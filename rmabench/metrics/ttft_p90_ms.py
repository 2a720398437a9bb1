"""Time to first token: from each request's due time to its first token
(the end of its prefill, which ends in a host read), 90th percentile over
every request due in the window; a request never served counts from its
due time to the end of the run (the drain's limit), the least it is
late by."""
from rmabench import stats


def read(run):
    due = run.records.get("due")
    if not due:
        return None
    tt, end = run.records["tok_times"], run.records["t_end"]
    lat = [(tt[rid][0] if tt.get(rid) else end) - t for rid, t in due.items()]
    return 1e3 * stats.percentile(lat, 90)
