"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell and its metrics; ``workloads/<cell>.json`` holds its traffic, its
driver and its limits; ``configs/<config>.json`` its model and the name
of its plain reference, ``reference/<name>.py``; ``drivers/<kind>.py``
runs it; ``metrics/<metric>.py`` reads one metric from the run's
records.

A driver module provides ``setup(run)`` (build, warm up, and record the
program's readings for the check), ``window(run, seconds)`` (the measured
loop; a ``--trace 1`` run's profiler is on around it), ``release(run)``
(free the program's state), ``check(run)`` (the reference; returns
``[(name, value, limit), ...]``, correct when every value is at most its
limit) and ``control(run)`` (the control's compared numbers).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level modules that may not be loaded in a run: JAX and the JAX
#: package the port was made from (compared by whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    tops = {m.split(".")[0] for m in (modules if modules is not None
                                      else list(sys.modules))}
    return sorted(tops & set(FORBIDDEN))


def set_environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    and no library loading JAX on its own."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_json(*parts: str) -> dict:
    with open(BENCH.joinpath(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, by file (names may hold
    dots)."""
    path = BENCH / folder / f"{name}.py"
    key = f"rmabench_{folder}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def now() -> float:
    return time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"[rmabench] {msg}", file=sys.stderr, flush=True)


def kernel_libraries() -> set:
    """The port's kernel libraries already built in the checkout."""
    from repro_torch import _build

    return {n for n in _build.SOURCES if _build.library_path(n).exists()}


@dataclasses.dataclass
class Run:
    """What a driver and the metric readers share about one run."""
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_process: float = 0.0              # perf_counter at process start
    setup_s: float | None = None
    records: dict = dataclasses.field(default_factory=dict)
    program: dict = dataclasses.field(default_factory=dict)  # live state
    tracer: object = None

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def tr(self):
        """The trace summary of a ``--trace 1`` run, or ``None``."""
        return self.tracer.trace if self.tracer is not None else None


def model_config(model: dict):
    """The port's ``ModelConfig`` of a configuration file's ``model``."""
    from repro_torch.configs.base import (MoEConfig, ModelConfig,
                                          SSMConfig)

    kw = dict(model)
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    if kw.get("ssm"):
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ModelConfig(**kw)


def make_run(cell: str, seed: int, seconds: float, trace: bool, **kw) -> Run:
    workload = load_json("workloads", f"{cell}.json")
    config = load_json("configs", f"{workload['config']}.json")
    return Run(cell, workload, config, seed, seconds, trace, **kw)


def _metric_entries(bench: dict, cell: str, trace: bool) -> list[dict]:
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m
            or cell in m["workloads"]]


def read_metrics(run: Run, entries: list[dict]) -> dict:
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(run: Run, *, bench: dict | None = None) -> dict:
    """Set-up, window, check and metrics of one run; returns the result
    object (the last line a run prints)."""
    import torch

    driver = load_module("drivers", run.workload["driver"])
    on_card = run.device == "cuda"
    built = kernel_libraries() if on_card else set()
    driver.setup(run)
    if run.setup_s is None:
        run.setup_s = now() - run.t_process
    if on_card:
        new = sorted(kernel_libraries() - built)
        log(f"set-up {run.setup_s:.2f} s; kernel libraries built in this "
            f"run: {new or 'none'}; memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    from rmabench.trace import Tracer

    run.tracer = Tracer(run.trace and on_card)
    with run.tracer:
        driver.window(run, run.seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if run.tracer.trace is not None:
        log(f"trace read in {run.tracer.read_s:.2f} s: "
            f"{len(run.tracer.trace.device)} device intervals")
    driver.release(run)
    run.program.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = now()
    checks = driver.check(run)
    log(f"check {now() - t_check:.2f} s")
    # an answer that never came (a request unserved past the drain, a step
    # with no finite loss) is not correct either, nor a run that finished
    # nothing to compare
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) \
        and not run.records.get("failed", 0) \
        and run.records.get("attempted", 0) > 0
    bench = bench if bench is not None else benchmark()
    metrics = read_metrics(run, _metric_entries(bench, run.cell, run.trace))
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(0) if on_card else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(run.records.get("attempted", 0)),
              "failed": int(run.records.get("failed", 0)),
              "metrics": metrics, "device": device}
    tr = run.tr
    if tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result
