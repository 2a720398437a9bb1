"""Whole runs at a tiny size on the CPU (the look for a card skipped, the
plain versions in the kernels' place): a sound run comes out correct, and
each fault a cell can have, planted underneath the timed path, comes out
not correct; so does the control, the reference in float8 put in the
program's place."""
import pytest

from rmabench import faults, harness, tiny

pytest.importorskip("repro_torch")


def _execute(cell, seed):
    run = tiny.run(cell, seed)
    return harness.execute(run), run


@pytest.mark.parametrize("cell", ["sc2-train-dp4", "jamba-chat",
                                  "jamba-batch"])
def test_sound_run_is_correct(cell):
    res, run = _execute(cell, 101)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = [m["name"] for m in harness.benchmark()["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    assert set(res["metrics"]) == set(e2e)
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "no_exchange"])
def test_train_fault_is_caught(fault):
    with faults.FAULTS[fault]():
        res, run = _execute("sc2-train-dp4", 102)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("cell", ["jamba-chat", "jamba-batch"])
def test_altered_token_is_caught(cell):
    with faults.altered_token():
        res, _ = _execute(cell, 103)
    assert not res["correct"], res["checks"]


def test_train_control_is_not_correct():
    run = tiny.run("sc2-train-dp4", 200)
    nums = harness.load_module("drivers", "train").control(run)
    lim = run.workload["check"]["limits"]
    assert nums["loss"] > lim["loss"] or nums["grad"] > lim["grad"], nums


@pytest.mark.parametrize("cell", ["jamba-chat", "jamba-batch"])
def test_serve_control_is_not_correct(cell):
    run = tiny.run(cell, 201)
    nums = harness.load_module("drivers", run.workload["driver"]).control(
        run)
    lim = run.workload["check"]["limits"]["mean_gap"]
    assert nums["mean_gap"] > lim > nums["program_mean_gap"], nums
