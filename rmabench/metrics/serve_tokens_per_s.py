"""Serving throughput: every output token produced inside the window (a
prefill's first token and every decoded token, by the time its host read
returned) over the window's time."""
from rmabench import stats


def read(run):
    rec = run.records
    if "t_open" not in rec or "due" in rec:
        return None
    lo, hi = rec["t_open"], rec["t_close"]
    n = sum(1 for ts in rec["tok_times"].values() for t in ts if lo < t <= hi)
    return stats.rate(n, hi - lo)
