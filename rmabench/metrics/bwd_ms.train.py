"""Mean device time of the train step's backwards a step over the window:
the sum of the step's ``bwd.<rank>.<micro-batch>`` parts (the program's
CUDA events around each rank's ``autograd.grad``, its recompute under
``remat="block"`` and the copy of its gradients into the ring's row)."""
from rmabench.program_spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "bwd.")
