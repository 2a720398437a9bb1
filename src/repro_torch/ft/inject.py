"""Deterministic fault injection — scripted failures for the elastic runtime
(a copy of the JAX package's pure-Python ``ft/inject.py``: one seed gives the
same script in both packages).

RAMC (Schonbein et al., PAPERS.md) argues transport-level failure and
timeout semantics must be first-class in an RMA runtime rather than assumed
away; foMPI's recovery story only matters if the recovery paths actually
run.  This module makes every failure mode a **reproducible input**: a
:class:`FaultScript` is an ordered list of :class:`Fault` events — seedable
(:meth:`FaultScript.random`), parseable from a CLI spec
(:meth:`FaultScript.parse`), and replayable tick-by-tick through a
:class:`FaultInjector` — so tests and the launcher exercise quarantine /
recompile / migration / re-admission without real hardware failures.

Fault kinds (what the injector does at the scripted tick):

* ``slow_step``   — the worker's observed step time is multiplied by
  ``magnitude`` (feeds the straggler monitor; repeated slow steps escalate);
* ``dead_worker`` — the worker stops responding entirely: quarantined
  immediately, evicted by the controller's recovery pipeline;
* ``lost_doorbell`` — one put_signal doorbell never lands (the RAMC-style
  transport loss): counts a suspect strike without any slow step;
* ``rejoin``      — a previously evicted worker comes back and re-enters
  through probation.
"""
from __future__ import annotations

import dataclasses
import random as _random
import re

FAULT_KINDS = ("slow_step", "dead_worker", "lost_doorbell", "rejoin")

#: CLI shorthand per kind (``FaultScript.parse``): ``dead:3@10`` reads
#: "dead_worker on worker 3 at tick 10"; ``slow:1@4x6`` adds a magnitude.
_SPEC_KINDS = {"slow": "slow_step", "dead": "dead_worker",
               "bell": "lost_doorbell", "rejoin": "rejoin"}
_SPEC_RE = re.compile(
    r"(?P<kind>[a-z_]+):(?P<worker>\d+)@(?P<tick>\d+)(?:x(?P<mag>[\d.]+))?")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted failure event."""

    tick: int                  # injector tick the fault fires at
    kind: str                  # one of FAULT_KINDS
    worker: int                # target worker rank
    magnitude: float = 1.0     # slow_step: step-time multiplier

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})")
        if self.tick < 0 or self.worker < 0:
            raise ValueError(f"fault tick/worker must be >= 0: {self}")
        if self.kind == "slow_step" and self.magnitude <= 1.0:
            raise ValueError(
                f"slow_step magnitude must be > 1 (a multiplier), "
                f"got {self.magnitude}")


class FaultScript:
    """An ordered, replayable list of :class:`Fault` events."""

    def __init__(self, faults=()):
        self.faults = tuple(sorted(faults, key=lambda f: (f.tick, f.worker)))

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def at(self, tick: int) -> list[Fault]:
        return [f for f in self.faults if f.tick == tick]

    @property
    def horizon(self) -> int:
        """Last scripted tick (0 for an empty script)."""
        return max((f.tick for f in self.faults), default=0)

    @classmethod
    def random(cls, seed: int, *, n_workers: int, n_faults: int = 3,
               max_tick: int = 20, kinds=("slow_step", "dead_worker",
                                          "lost_doorbell"),
               protect=(0,)) -> "FaultScript":
        """Seedable random script over ``n_workers`` ranks.

        ``protect`` names ranks never targeted (rank 0 by default — the
        controller's survivor anchor, so a script can't evict the whole
        mesh).  At most one ``dead_worker`` per rank is emitted; a dead
        rank draws no further faults.  Uses :mod:`random` with an explicit
        seed — same seed, same script, any process."""
        rng = _random.Random(seed)
        candidates = [w for w in range(n_workers) if w not in set(protect)]
        faults, dead = [], set()
        for _ in range(n_faults):
            alive = [w for w in candidates if w not in dead]
            if not alive:
                break
            kind = rng.choice(list(kinds))
            worker = rng.choice(alive)
            tick = rng.randrange(1, max_tick + 1)
            mag = round(rng.uniform(2.0, 8.0), 2) if kind == "slow_step" \
                else 1.0
            if kind == "dead_worker":
                dead.add(worker)
            faults.append(Fault(tick, kind, worker, mag))
        return cls(faults)

    @classmethod
    def parse(cls, spec: str) -> "FaultScript":
        """Parse a CLI spec: comma-separated ``kind:worker@tick[xmag]``.

        ``"dead:3@10,slow:1@4x6"`` — worker 3 dies at tick 10, worker 1
        runs 6× slow at tick 4.  Kinds: ``slow``, ``dead``, ``bell``,
        ``rejoin`` (or the full names)."""
        faults = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            m = _SPEC_RE.fullmatch(part)
            if not m:
                raise ValueError(
                    f"bad fault spec {part!r} — expected kind:worker@tick"
                    f"[xmagnitude], e.g. dead:3@10 or slow:1@4x6")
            kind = _SPEC_KINDS.get(m["kind"], m["kind"])
            mag = float(m["mag"]) if m["mag"] else \
                (4.0 if kind == "slow_step" else 1.0)
            faults.append(Fault(int(m["tick"]), kind, int(m["worker"]), mag))
        return cls(faults)

    def __repr__(self) -> str:
        return f"FaultScript({list(self.faults)!r})"


class FaultInjector:
    """Replays a :class:`FaultScript` tick by tick against a worker fleet.

    The injector owns the *physical* failure state (which ranks are dead,
    which run slow); the :class:`~repro_torch.ft.elastic.ElasticController`
    owns the *logical* reaction (suspicion, quarantine, recovery).  Keeping
    them separate is what lets the same script drive a unit test on the CPU
    and a serving run on the card identically."""

    def __init__(self, script: FaultScript, *, base_step: float = 1.0):
        self.script = script
        self.base_step = base_step
        self.tick = -1
        self.dead: set[int] = set()
        self.slow: dict[int, float] = {}       # worker -> multiplier
        self.lost_bells: list[int] = []        # workers hit this tick
        self.injected: list[Fault] = []

    def advance(self) -> list[Fault]:
        """Move to the next tick; returns the faults firing on it."""
        self.tick += 1
        fired = self.script.at(self.tick)
        self.lost_bells = []
        for f in fired:
            if f.kind == "dead_worker":
                self.dead.add(f.worker)
                self.slow.pop(f.worker, None)
            elif f.kind == "slow_step":
                if f.worker not in self.dead:
                    self.slow[f.worker] = f.magnitude
            elif f.kind == "lost_doorbell":
                if f.worker not in self.dead:
                    self.lost_bells.append(f.worker)
            elif f.kind == "rejoin":
                self.dead.discard(f.worker)
                self.slow.pop(f.worker, None)
        self.injected.extend(fired)
        return fired

    def alive(self, worker: int) -> bool:
        return worker not in self.dead

    def duration(self, worker: int) -> float | None:
        """This tick's observed step time for ``worker`` — ``None`` when
        the rank is dead (no heartbeat at all, not a slow one)."""
        if worker in self.dead:
            return None
        return self.base_step * self.slow.get(worker, 1.0)

    def durations(self, n_workers: int) -> dict[int, float]:
        """Step times for every rank still alive this tick."""
        out = {}
        for w in range(n_workers):
            d = self.duration(w)
            if d is not None:
                out[w] = d
        return out


__all__ = ["Fault", "FaultScript", "FaultInjector", "FAULT_KINDS"]
