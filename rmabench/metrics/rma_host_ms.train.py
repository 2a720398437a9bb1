"""Host time of the window operations a train step: the program's
``rma.*`` spans (``Window.allocate``, ``dup_with_info``, ``flush`` and a
plan's replay, ``CompiledPlan.execute``) inside each step, nested spans
counted once, as a mean over the traced steps."""
from rmabench.program_spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "rma.")
