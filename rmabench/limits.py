"""Readings for setting a cell's limits: the program's compared numbers
over many seeds (set-up and check, with the short window the cell's check
needs), and the control's, in one process."""
from __future__ import annotations

import gc
import json
import sys

from rmabench import harness


def readings(cell: str, seeds, *, control: bool = False,
             fault: str | None = None) -> dict:
    import contextlib

    import torch

    from rmabench import faults

    out = []
    plant = faults.FAULTS[fault] if fault else contextlib.nullcontext
    for seed in seeds:
        run = harness.make_run(cell, seed, 0.0, False)
        run.seconds = run.workload["check"].get("window_s", 0.0)
        driver = harness.load_module("drivers", run.workload["driver"])
        if control:
            nums = driver.control(run)
        else:
            with plant():
                driver.setup(run)
                driver.window(run, run.seconds)
            driver.release(run)
            run.program.clear()
            gc.collect()
            torch.cuda.empty_cache()
            driver.check(run)
            nums = run.records["compared"]
        row = {"seed": seed, **nums}
        out.append(row)
        mode = "control" if control else fault or "program"
        print(f"readings {cell} {mode} "
              f"{json.dumps(row)}", file=sys.stderr, flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return {"cell": cell, "mode": "control" if control else
            (fault or "program"), "readings": out}
