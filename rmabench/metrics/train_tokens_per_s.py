"""Training throughput: the global-batch tokens of every step of the
window over the window's time (first step's start to last step's end,
host clock; the host waits for every step)."""
from rmabench import stats


def read(run):
    steps = run.records.get("steps")
    if not steps:
        return None
    return stats.rate(sum(s["tokens"] for s in steps),
                      steps[-1]["t1"] - steps[0]["t0"])
