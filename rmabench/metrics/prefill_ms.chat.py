"""Mean host time of the executor's prefill (one prompt into one slot,
ending in the host read of its first token) over the window's prefills."""
from rmabench.metrics_common import mean_ms


def read(run):
    return mean_ms([(t0, t1) for _, t0, t1, _ in run.records.get(
        "prefills", [])])
