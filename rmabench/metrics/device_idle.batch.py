"""The card's idle share in the traced stretch of the batch window:
1 - the union of every device interval (kernels, copies, sets) over the
stretch's length."""
from rmabench.metrics_common import idle_percent


def read(run):
    return idle_percent(run)
