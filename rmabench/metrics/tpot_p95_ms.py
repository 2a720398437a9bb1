"""Time per output token: the gap between consecutive tokens of a request,
pooled over every gap of every request due in the window, 95th
percentile."""
from rmabench import stats


def read(run):
    due = run.records.get("due")
    if not due:
        return None
    tt = run.records["tok_times"]
    gaps = [b - a for rid in due for a, b in zip(tt.get(rid, ()),
                                                tt.get(rid, ())[1:])]
    return 1e3 * stats.percentile(gaps, 95) if gaps else None
