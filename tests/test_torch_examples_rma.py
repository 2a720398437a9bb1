"""The port's ``examples_torch/rma_patterns.py`` and ``quickstart.py`` on the
CPU against the JAX package's ``examples/`` twins.

The reference examples re-launch themselves with 8 forced host devices
when imported, so they run here as subprocesses (both at once, in one
module-scoped fixture) and their printed lines are parsed.  The port's
examples run in this process through their ``main(["--device", "cpu"])``.
Every phase count of the port's ledger equals the reference example's
collective-permute count, but two: there the reference's lowering drops an
operation whose landing nothing reads (dead code), and the port's ledger,
its own planner and its traced program all count it
(``test_dead_code_counts_differ_from_hlo``, ROADMAP fault 12)."""
import contextlib
import importlib.util
import io
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the reference example's counts, as measured when the port's example was
#: written (collective-permutes in the compiled HLO, 8 forced CPU devices);
#: the subprocess below must still print them
REFERENCE_COUNTS = dict(
    listing1=7, listing2=5, dup=3, acc_declared=3, acc_generic=4,
    acc_fused_signal=4, a2a_declared=38, a2a_undeclared=60, planned=7,
    planned_predicted=7, planned_naive=9, flat_inter=14, flat_intra=0,
    hier_inter=2, hier_intra=6, backend_rma=14, backend_gspmd=0)

#: patterns whose port count is the reference's HLO count + 1: the lowering
#: removes one permute whose result the function never reads
DEAD_IN_HLO = ("dup", "a2a_declared")


def load_example(name: str):
    """The port's example module ``examples_torch/<name>.py``."""
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def reference_output():
    """stdout of the reference's rma_patterns.py and quickstart.py, run at
    once."""
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")],
        cwd=ROOT, env=_reference_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name in ("rma_patterns", "quickstart")}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"examples/{name}.py failed:\n{stderr}"
        out[name] = stdout
    return out


def _parse_reference_counts(text: str) -> dict:
    def one(pattern):
        m = re.search(pattern, text)
        assert m, pattern
        return tuple(int(g) for g in m.groups())

    got = {}
    got["listing1"], = one(r"listing1 \(put;flush;signal;flush\): (\d+)")
    got["listing2"], = one(r"listing2 \(ordered put\+signal;flush\): (\d+)")
    got["dup"], = one(r"dup_with_info mixed-config region: (\d+)")
    got["acc_declared"], = one(r"accumulate via same_op dup: (\d+)")
    got["acc_generic"], = one(r"accumulate undeclared:\s+(\d+)")
    got["acc_fused_signal"], = one(r"fused accumulate\+signal:\s+(\d+)")
    got["a2a_declared"], = one(r"all-to-all declared:\s+(\d+)")
    got["a2a_undeclared"], = one(r"all-to-all undeclared:\s+(\d+)")
    (got["planned"], got["planned_predicted"],
     got["planned_naive"]) = one(r"compiled plan replay:\s+(\d+)\s+\(predicted"
                                 r" (\d+), naive baseline (\d+)\)")
    got["flat_inter"], got["flat_intra"] = one(
        r"ring flat:\s+inter=(\d+) intra=(\d+)")
    got["hier_inter"], got["hier_intra"] = one(
        r"ring topology=2x4:\s+inter=(\d+) intra=(\d+)")
    got["backend_rma"], = one(r"ring backend=rma:\s+(\d+) phases")
    got["backend_gspmd"], = one(r"ring backend=gspmd:\s+(\d+) permutes")
    return got


@pytest.fixture(scope="module")
def port_patterns():
    mod = load_example("rma_patterns")
    env = {k: os.environ.get(k) for k in ("RMA_TORCH_ACC_BENCH_JSON",
                                          "RMA_ACC_CROSSOVER")}
    os.environ["RMA_TORCH_ACC_BENCH_JSON"] = "/nonexistent"
    os.environ.pop("RMA_ACC_CROSSOVER", None)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            counts = mod.main(["--device", "cpu"])
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mod, counts, buf.getvalue()


def test_reference_example_prints_the_stated_counts(reference_output):
    text = reference_output["rma_patterns"]
    assert "RMA_PATTERNS OK" in text
    assert _parse_reference_counts(text) == REFERENCE_COUNTS


@pytest.mark.parametrize("pattern", sorted(REFERENCE_COUNTS))
def test_port_ledger_equals_reference_count(port_patterns, reference_output,
                                            pattern):
    _, counts, _ = port_patterns
    want = _parse_reference_counts(reference_output["rma_patterns"])[pattern]
    if pattern in DEAD_IN_HLO:
        assert counts[pattern] == want + 1
    else:
        assert counts[pattern] == want


def test_port_example_prints_marker_and_its_router(port_patterns):
    _, counts, text = port_patterns
    assert text.rstrip().endswith("RMA_PATTERNS OK")
    assert "phases in the port's ledger" in text
    assert "win_op_intrinsic('sum,cas', 8, int32): True" in text
    assert "win_op_intrinsic('sum', 4096, float32): False" in text
    # no table in this run: the router's crossover is the hardware envelope,
    # and the line says so
    from repro_torch.core.rma.intrinsic import INTRINSIC_MAX_COUNT

    line = next(l for l in text.splitlines()
                if l.startswith("crossover_elems"))
    assert line.startswith(f"crossover_elems(default): {INTRINSIC_MAX_COUNT}")
    assert "hardware envelope" in line
    assert "route(sum, 4): intrinsic" in line
    assert "route(sum, 4096): tiled" in line


def _reference_dup_demo(buf):
    """``examples/rma_patterns.py::dup_demo``, verbatim."""
    import jax.numpy as jnp
    from repro.core.rma import Window, WindowConfig

    perm = [(i, (i + 1) % 8) for i in range(8)]
    win = Window.allocate(buf, "x", 8, WindowConfig(max_streams=2))
    latency = win.dup_with_info(order=True, scope="thread", same_op="sum")
    bulk = win
    bulk = bulk.put(jnp.ones((8,)), perm, offset=0, stream=0)
    latency = latency.accumulate(jnp.ones((1,)), perm, op="sum",
                                 offset=8, stream=1)
    return latency.flush(stream=1).buffer


def _reference_a2a_declared(buf):
    """``examples/rma_patterns.py::a2a_declared``, verbatim."""
    from repro.core.rma import rma_all_to_all

    return rma_all_to_all(buf, "x", 8, chunks=2, order=True,
                          declare=True).data


def test_dead_code_counts_differ_from_hlo(port_patterns):
    """Fault 12: in ``dup_demo`` the bulk put lands in a buffer the function
    never returns (the latency handle was dup'd before it), and in the
    declared all-to-all the last peer's header request lands in a header
    word nothing reads after.  JAX drops both permutes as dead code before
    it lowers; the reference's traced program and its planner count them,
    as the port's ledger does."""
    import jax
    import jax.numpy as jnp
    from jax._src.interpreters import partial_eval as pe

    from repro.core.rma.alltoall import all_to_all_plan

    _, counts, _ = port_patterns

    def permutes(jaxpr):
        return sum(e.primitive.name == "ppermute" for e in jaxpr.eqns)

    for name, fn in (("dup", _reference_dup_demo),
                     ("a2a_declared", _reference_a2a_declared)):
        closed = jax.make_jaxpr(fn, axis_env=[("x", 8)])(
            jnp.zeros((16,), jnp.float32))
        live, _ = pe.dce_jaxpr(closed.jaxpr,
                               [True] * len(closed.jaxpr.outvars))
        assert permutes(live) == REFERENCE_COUNTS[name]
        assert permutes(closed.jaxpr) == REFERENCE_COUNTS[name] + 1
        assert counts[name] == permutes(closed.jaxpr)
    planned = all_to_all_plan("x", 8, (16,), jnp.float32, chunks=2,
                              order=True, declare=True)
    assert planned.phases == counts["a2a_declared"]


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def _parse_reference_quickstart(text: str):
    lines = text.splitlines()
    i = next(k for k, l in enumerate(lines) if l.startswith("window contents"))
    rows = " ".join(lines[i + 1:i + 9]).replace("[", " ").replace("]", " ")
    window = np.array(rows.split(), dtype=np.float32).reshape(8, 5)
    m = re.search(r"one-sided ring all-reduce: \[([^\]]*)\]", text)
    reduced = np.array(m.group(1).split(), dtype=np.float32)
    return window, reduced


def test_quickstart_matches_reference(reference_output, capsys):
    text = reference_output["quickstart"]
    assert "QUICKSTART OK" in text
    want_window, want_row = _parse_reference_quickstart(text)
    out = load_example("quickstart").main(["--device", "cpu"])
    np.testing.assert_array_equal(out["window"], want_window)
    np.testing.assert_array_equal(out["reduced"],
                                  np.broadcast_to(want_row, (8, 4)))
    assert out["losses"][-1] < out["losses"][0]
    assert capsys.readouterr().out.rstrip().endswith("QUICKSTART OK")


def test_examples_reject_cuda_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart", "rma_patterns"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_example(name).main([])


def test_examples_import_neither_jax_nor_reference():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                     re.M)
    files = sorted((ROOT / "examples_torch").glob("*.py"))
    assert [f.name for f in files] == ["quickstart.py", "rma_patterns.py",
                                       "serve_decode.py", "train_lm.py"]
    offenders = [f.name for f in files + [ROOT / "chip_smoke.py"]
                 if bad.search(f.read_text())]
    assert not offenders, offenders
