"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
process imports every module of the benchmark, drives a tiny run of each
cell through the harness (the program's modules load as a run loads them)
and lists the top-level modules it holds, compared by whole names (the
port's ``repro_torch`` is not ``repro``)."""
import json
import os
import subprocess
import sys

import pytest

from rmabench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import glob, json, os, sys
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
from rmabench import harness, tiny
for kind in ("drivers", "metrics", "reference", "traffic"):
    pattern = os.path.join(ROOT, "rmabench", kind, "*.py")
    for path in sorted(glob.glob(pattern)):
        name = os.path.basename(path)[:-3]
        if name != "__init__":
            harness.load_module(kind, name)
import rmabench.limits, rmabench.trace, rmabench.run  # noqa: F401
for cell in ("sc2-train-dp4", "jamba-batch"):
    harness.execute(tiny.run(cell, 1))
print(json.dumps(harness.forbidden_modules()))
"""


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "rmabench", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "jax._src"]) == \
        ["jax", "repro"]


def test_a_run_loads_no_jax():
    pytest.importorskip("repro_torch")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.replace("ROOT", repr(ROOT))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
