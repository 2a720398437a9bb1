"""The program's own records read by the per-layer metrics: its spans
(``repro_torch.obs``) of a ``--trace 1`` run, laid beside the device
trace, and the train step's CUDA-event parts on each step record.

The program records its spans while a profiler records, stamped with
``time.perf_counter()``: the clock :class:`rmabench.trace.Trace` maps the
device's intervals onto, so the two need no conversion.  A program that
records no spans (one without ``repro_torch.obs``) gives none, and the
metrics that read them read nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict


def _recorded() -> list:
    try:
        from repro_torch import obs
    except ImportError:
        return []
    return obs.spans()


def spans(run, prefix: str = "") -> list:
    """The program's finished spans whose name starts with ``prefix``,
    inside the traced stretch ``[run.tr.start, run.tr.end]``; none
    untraced."""
    tr = run.tr
    if tr is None:
        return []
    return [s for s in _recorded() if s.name.startswith(prefix)
            and s.t0 >= tr.start and s.t1 <= tr.end]


def merged(intervals) -> tuple[list, list]:
    """The union of ``(start, end)`` intervals as sorted disjoint pieces:
    their starts and their ends."""
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def covered(pieces: tuple[list, list], lo: float, hi: float) -> float:
    """How much of ``[lo, hi]`` the disjoint ``pieces`` cover."""
    starts, ends = pieces
    i = bisect.bisect_right(ends, lo)
    total = 0.0
    while i < len(starts) and starts[i] < hi:
        total += min(ends[i], hi) - max(starts[i], lo)
        i += 1
    return total


def _named(run, name: str) -> list:
    return [s for s in spans(run, name) if s.name == name]


def idle_gaps(run, stretches) -> list:
    """The parts of the ``(start, end)`` stretches where the device ran
    nothing (no device interval open), as ``(start, end)`` pairs."""
    starts, ends = merged((s, e) for s, e, _ in run.tr.device)
    out = []
    for lo, hi in stretches:
        i = bisect.bisect_right(ends, lo)
        at = lo
        while i < len(starts) and starts[i] < hi:
            if starts[i] > at:
                out.append((at, starts[i]))
            at = max(at, ends[i])
            i += 1
        if at < hi:
            out.append((at, hi))
    return out


def idle_ms(run, name: str):
    """Mean over the spans ``name`` of each span's length less the device
    time inside it (the union of device intervals clipped to the span), in
    ms; ``None`` without such spans."""
    outer = [(s.t0, s.t1) for s in _named(run, name)]
    if not outer:
        return None
    return 1e3 * sum(b - a for a, b in idle_gaps(run, outer)) / len(outer)


def idle_by_innermost(run, within: str | None = None) -> dict:
    """Idle device time inside the spans ``within`` (the whole traced
    stretch without), split by the innermost program span open at each
    idle stretch's midpoint (``-`` where none is): name → seconds, largest
    first."""
    from rmabench.trace import _innermost

    outer = ([(s.t0, s.t1) for s in _named(run, within)] if within
             else [(run.tr.start, run.tr.end)])
    gaps = sorted(idle_gaps(run, outer), key=lambda g: g[0] + g[1])
    ranges = sorted((s.t0, s.t1, s.name) for s in spans(run))
    names = _innermost(ranges, [(a + b) / 2 for a, b in gaps])
    by = defaultdict(float)
    for (a, b), n in zip(gaps, names):
        by[n] += b - a
    return dict(sorted(by.items(), key=lambda x: -x[1]))


def host_ms_per_step(run, prefix: str):
    """Mean over the window's steps of the host time inside spans named
    ``prefix...`` (nested spans counted once) in each step, in ms; ``None``
    without such spans."""
    found = spans(run, prefix)
    steps = [s for s in run.records.get("steps", ())
             if s["t0"] >= run.tr.start and s["t1"] <= run.tr.end] \
        if run.tr is not None else []
    if not found or not steps:
        return None
    pieces = merged((s.t0, s.t1) for s in found)
    return 1e3 * sum(covered(pieces, s["t0"], s["t1"])
                     for s in steps) / len(steps)


def part_ms_per_step(run, prefix: str):
    """Mean over the window's steps of the sum of the step's CUDA-event
    parts named ``prefix...`` (``<part>_ms`` on each step record); ``None``
    where no step has one."""
    sums = [sum(v for k, v in s.items()
                if k.startswith(prefix) and k.endswith("_ms"))
            for s in run.records.get("steps", ())
            if any(k.startswith(prefix) for k in s)]
    return sum(sums) / len(sums) if sums else None
