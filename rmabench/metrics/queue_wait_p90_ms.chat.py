"""Queueing: from each request's due time to the start of its prefill,
90th percentile over every request due in the window (harness wrap of the
executor's prefill; the scheduler admits at the start of a tick)."""
from rmabench import stats


def read(run):
    due = run.records.get("due")
    if not due:
        return None
    waits = [t0 - due[rid] for rid, t0, _, _ in run.records["prefills"]
             if rid in due]
    return 1e3 * stats.percentile(waits, 90) if waits else None
