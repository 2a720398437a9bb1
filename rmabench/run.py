#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` (the PyTorch and CUDA
port) once, on the CUDA card of this machine:

    python3 rmabench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics read under the profiler (``--trace 1``) as one JSON object, the
last line of standard output; every number the output check compared is
printed beside its limit on the last lines of standard error and under
``checks`` in the result.  Exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for), when the program is not
beside the benchmark, or when JAX or the JAX package was loaded.

Modes that the benchmark's own runs do not use: ``--readings <seeds>``
runs set-up and the check alone for each seed (with the short window a
serving check needs) in one process; ``--control <seeds>`` runs the
reference in the control's lower precision in the program's place on the
same inputs; ``--sweep <rates>`` runs an open loop at each rate for
``--seconds`` on one engine (to find the highest rate it sustains).
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rmabench import harness  # noqa: E402


def _say_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", default=None,
                    help="comma-separated seeds: set-up and check only")
    ap.add_argument("--control", default=None,
                    help="comma-separated seeds: the control's readings")
    ap.add_argument("--fault", default=None,
                    help="with --readings: a fault planted underneath the "
                    "timed path (rmabench/faults.py)")
    ap.add_argument("--sweep", default=None,
                    help="comma-separated rates (requests/s) of an open "
                    "loop, each for --seconds, on one engine")
    args = ap.parse_args(argv)

    harness.set_environment()
    if not os.path.isdir(os.path.join(harness.ROOT, "src", "repro_torch")):
        print("rmabench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"rmabench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    need = cells[args.workload]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"rmabench: the cell needs {need} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (fails here if the program is absent)

    if args.readings or args.control:
        from rmabench import limits

        seeds = [int(s) for s in (args.readings or args.control).split(",")]
        out = limits.readings(args.workload, seeds,
                              control=bool(args.control), fault=args.fault)
        print(json.dumps(out), flush=True)
        return 0

    run = harness.make_run(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_process=T_PROCESS)
    if args.sweep:
        driver = harness.load_module("drivers", run.workload["driver"])
        driver.setup(run)
        rows = driver.sweep(run, [float(r) for r in args.sweep.split(",")],
                            args.seconds)
        print(json.dumps({"cell": args.workload, "sweep": rows}), flush=True)
        return 0
    result = harness.execute(run, bench=bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"rmabench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    _say_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
