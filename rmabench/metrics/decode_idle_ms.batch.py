"""The card's idle time inside a decode tick: for each traced
``serve.decode`` span (the engine's call of ``Executor.decode``), its
length less the union of device intervals inside it, as a mean over the
ticks."""
from rmabench.program_spans import idle_ms


def read(run):
    return idle_ms(run, "serve.decode")
