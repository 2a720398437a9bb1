"""Mean host time of the executor's decode tick (one token for every slot,
ending in the host read of the greedy tokens) over the window's ticks."""
from rmabench.metrics_common import mean_ms


def read(run):
    return mean_ms([(t0, t1) for t0, t1, _ in run.records.get("decodes", [])])
