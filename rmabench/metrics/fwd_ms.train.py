"""Mean device time of the train step's forwards a step over the window:
the sum of the step's ``fwd.<rank>.<micro-batch>`` parts (the program's
CUDA events around each rank's ``model.loss``)."""
from rmabench.program_spans import part_ms_per_step


def read(run):
    return part_ms_per_step(run, "fwd.")
