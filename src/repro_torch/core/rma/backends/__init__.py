"""Lowering targets of :meth:`RmaPlan.compile` — the plan IR's backends.

A compiled plan describes *what* communicates; this package holds the
realizations of *how*:

* ``rma``       — the one-sided substrate and its kernels (the default).
* ``gspmd``     — recognized macros (ring all-reduce, all-to-all) collapsed
  to the collective they compute (:mod:`.gspmd`): on the stacked layout one
  library operation, billed zero phases.
* ``interpret`` — the whole schedule walked on stacked tensors by plain
  indexing (:mod:`.interpret`), the conformance suite's second opinion.

``backend="auto"`` picks between ``rma`` and ``gspmd`` per macro from the
latency table measured on the card (:mod:`.costmodel`); the verdict and its
reason are recorded in ``CompiledPlan.lowering`` and lead
``phase_table()``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core.rma.backends.costmodel import (AUTO_CANDIDATES,
                                                     load_table)
from repro_torch.core.rma.backends.costmodel import choose as choose_backend
from repro_torch.core.rma.backends.gspmd import (execute_macro, host_macro,
                                                 macro_lowerable)
from repro_torch.core.rma.backends.interpret import (InterpretResult,
                                                     interpret_plan,
                                                     vmapped_execute)

#: Accepted values of the ``backend=`` knob everywhere it is threaded.
BACKEND_NAMES = ("auto", "rma", "gspmd", "interpret")


@runtime_checkable
class Backend(Protocol):
    """What a lowering target provides (the in-tree targets are modules):
    a gate deciding whether a recorded macro may leave the substrate, and
    an executor producing the macro's results."""

    def macro_lowerable(self, plan, macro) -> tuple[bool, str]:
        """``(ok, reason)`` — may this macro leave the RMA substrate?"""
        ...

    def execute_macro(self, macro, resolve) -> dict:
        """``{result_idx: value}`` for a selected macro at execute time."""
        ...


__all__ = [
    "AUTO_CANDIDATES", "BACKEND_NAMES", "Backend", "InterpretResult",
    "choose_backend", "execute_macro", "host_macro", "interpret_plan",
    "load_table", "macro_lowerable", "vmapped_execute",
]
