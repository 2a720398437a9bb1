"""Straggler detection and mitigation policy (a copy of the JAX package's
pure-Python ``ft/straggler.py``).

At pod scale the common failure mode is not death but *slowness* (one host at
60 % speed stalls every synchronous collective).  The monitor keeps an EMA of
step times, flags steps exceeding ``threshold × EMA``, and tracks repeat
offenders per source; the policy layer decides between logging, raising (so
the launcher restarts onto a healthy mesh slice), or — on real multi-host
deployments — re-dispatching the slow host's shard.

Warmup is *robust*: the first ``warmup_steps`` samples (which include
compile-time spikes and allocator churn) never feed the EMA directly —
the baseline is re-seeded from their **median** each step, so a single slow
warmup step cannot inflate the baseline and mask real stragglers later.
Once armed, only non-straggler steps update the EMA.

The monitor is deliberately runtime-agnostic (fed wall-clock step times), so
it is unit-testable without hardware and usable unchanged in the launcher.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from collections import defaultdict, deque
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ema: float
    ratio: float
    source: str


class StragglerMonitor:
    def __init__(self, *, threshold: float = 2.0, ema_alpha: float = 0.1,
                 warmup_steps: int = 5, escalate_after: int = 3,
                 on_escalate: Callable[[StragglerEvent], None] | None = None):
        self.threshold = threshold
        self.alpha = ema_alpha
        self.warmup = warmup_steps
        self.escalate_after = escalate_after
        self.on_escalate = on_escalate
        self.ema: float | None = None
        self.seen = 0
        self.events: list[StragglerEvent] = []
        self.offenders: dict[str, int] = defaultdict(int)
        self._t0: float | None = None
        self._warmup_samples: list[float] = []
        # recent healthy (source, duration) samples — what reset(source=)
        # re-seeds the baseline from once the named source's are excluded
        self._recent: deque[tuple[str, float]] = deque(maxlen=32)

    # -- context-manager style per-step timing ------------------------------
    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int, source: str = "local") -> StragglerEvent | None:
        if self._t0 is None:
            raise RuntimeError(
                "StragglerMonitor.stop() without a matching start() — "
                "call start() at the top of the step being timed")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, dt, source)

    # -- core logic -----------------------------------------------------------
    def observe(self, step: int, duration: float,
                source: str = "local") -> StragglerEvent | None:
        """Feed one step time.  Returns an event iff it's a straggler step."""
        self.seen += 1
        if self.seen <= self.warmup:
            # warmup: collect, never flag, and keep the baseline at the
            # median of what has been seen — an outlier warmup step (compile
            # spike, slow first allocation) cannot seed or drag the EMA
            self._warmup_samples.append(duration)
            self._recent.append((source, duration))
            self.ema = statistics.median(self._warmup_samples)
            return None
        if self.ema is None:
            # warmup_steps=0: seed from the first armed sample
            self.ema = duration
            return None
        event = None
        if duration > self.threshold * self.ema:
            event = StragglerEvent(step, duration, self.ema,
                                   duration / self.ema, source)
            self.events.append(event)
            self.offenders[source] += 1
            if (self.offenders[source] >= self.escalate_after
                    and self.on_escalate is not None):
                self.on_escalate(event)
        else:
            # straggler steps do not poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * duration
            self._recent.append((source, duration))
        return event

    def reset(self, source: str | None = None) -> None:
        """Clear escalation state.

        With ``source``, clears only that source — the **rejoin** path: a
        worker re-admitted after quarantine must not inherit its old
        offender count (one more slow step would immediately re-escalate)
        nor keep biasing the baseline with its pre-eviction samples.  Its
        events and recent samples are dropped and the EMA is re-seeded from
        the median of the *other* sources' recent healthy steps, so the
        rejoined worker is judged against the surviving mesh's pace.

        Without ``source``, resets the whole monitor to its initial state
        (fresh warmup)."""
        if source is None:
            self.ema = None
            self.seen = 0
            self.events.clear()
            self.offenders.clear()
            self._warmup_samples.clear()
            self._recent.clear()
            return
        self.offenders.pop(source, None)
        self.events = [e for e in self.events if e.source != source]
        kept = [(s, d) for s, d in self._recent if s != source]
        self._recent = deque(kept, maxlen=self._recent.maxlen)
        if kept:
            self.ema = statistics.median(d for _, d in kept)

    def chronic_offenders(self) -> list[str]:
        return [s for s, n in self.offenders.items()
                if n >= self.escalate_after]


__all__ = ["StragglerMonitor", "StragglerEvent"]
