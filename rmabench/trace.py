"""The device trace of a ``--trace 1`` run, kept as a summary.

:class:`Tracer` runs ``torch.profiler`` (CPU and CUDA activities) over the
whole window (an open loop's drain included) and, once the window has
closed, reads the raw events once into :class:`Trace`: every device
interval (kernels, copies, sets) with its name, and the host's ranges (the
benchmark's own ``record_function`` spans and the operators) to say what
the host was doing in each gap.  Stopping the profiler and reading its
events takes seconds, so it never happens inside the window.  Nothing is
written to disk.
"""
from __future__ import annotations

import time
from collections import defaultdict

from rmabench import stats

#: prefix of the benchmark's own spans (``record_function`` names); the
#: profiler mirrors each on the device's timeline, where it is no work
SPAN = "bench:"
#: the span whose start ties the profiler's clock to the host's
MARK = SPAN + "trace-start"


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


class Trace:
    """Device intervals (seconds on the host's clock) and host ranges of
    one traced stretch ``[start, end]``."""

    def __init__(self, device: list, host: list, start: float, end: float):
        self.device = device        # (start_s, end_s, name)
        self.host = host            # (start_s, end_s, name, is_span)
        self.start, self.end = start, end

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return stats.union_length(
            (max(s, self.start), min(e, self.end)) for s, e, _ in self.device
            if e > self.start and s < self.end)

    def kernel_seconds(self, names) -> float:
        """Device time of the intervals whose name contains any of
        ``names``."""
        return sum(e - s for s, e, n in self.device
                   if any(k in n for k in names))

    def kernel_count(self, names) -> int:
        return sum(1 for _, _, n in self.device if any(k in n for k in names))

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for s, e, n in self.device:
            by[n[:120]] += e - s
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_by_host(self, k: int = 10) -> list:
        """Idle device time grouped by what the host was inside at each
        gap's midpoint: the innermost benchmark span and the innermost
        operator, ``span/operator``."""
        gaps = stats.gaps([(s, e) for s, e, _ in self.device],
                          self.start, self.end)
        mids = [(s + e) / 2 for s, e in gaps]
        span_at = _innermost(sorted(h for h in self.host if h[3]), mids)
        op_at = _innermost(sorted(h for h in self.host if not h[3]), mids)
        by = defaultdict(float)
        for (s, e), sp, op in zip(gaps, span_at, op_at):
            by[f"{sp}/{op}"[:120]] += e - s
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_by_host()}


def _innermost(ranges, times) -> list:
    """For each of the sorted ``times``, the name of the latest-started
    range of ``ranges`` (sorted by start) still open there, or ``-``: one
    sweep with a stack, exact for nested ranges."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "-")
    return out


class Tracer:
    """``with Tracer(enabled) as tr: ...``; ``tr.trace`` holds the summary
    afterwards (``None`` when disabled)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Trace | None = None
        self._prof = None
        self.read_s = 0.0

    def __enter__(self):
        if self.enabled:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            torch.cuda.synchronize()
            self._prof.__enter__()
            # a marker span ties the profiler's clock to perf_counter
            with torch.profiler.record_function(MARK):
                self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prof, self._prof = self._prof, None
        r0 = time.perf_counter()
        prof.__exit__(None, None, None)
        self.trace = _read(prof, self._t0, t1)
        self.read_s = time.perf_counter() - r0
        return False


def _read(prof, t0: float, t1: float) -> Trace:
    """Raw profiler events → :class:`Trace`, on the host's perf_counter
    clock (the profiler stamps events with the same monotonic clock)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    for ev in events:
        s = _ns(ev, "start") * 1e-9
        e = s + _ns(ev, "duration") * 1e-9
        if ev.device_type() == cuda:
            if not ev.name().startswith(SPAN):   # a span's mirror, no work
                device.append((s, e, ev.name()))
        else:
            name = ev.name()
            host.append((s, e, name, name.startswith(SPAN)))
    # the profiler's epoch → perf_counter's, by the marker span
    mark = [h for h in host if h[2] == MARK]
    shift = t0 - mark[0][0] if mark else 0.0
    device = [(s + shift, e + shift, n) for s, e, n in device]
    host = [(s + shift, e + shift, n, k) for s, e, n, k in host if n != MARK]
    return Trace(device, host, t0, t1)
