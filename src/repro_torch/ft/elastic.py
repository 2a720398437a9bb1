"""Elastic runtime — quarantine, plan recompilation, live KV-page migration
(ported from the JAX package's ``ft/elastic.py``).

Because topology is a *declared plan input* with fingerprinted build-once
caches (``core/rma/topology.py``), reacting to a mesh change is a targeted
cache invalidation plus rebuilds — not a global teardown; and because KV
pages live behind memory handles with epoch-checked lifetimes (P5), a
victim's pages can be migrated to survivors while racing reads come back
**zeroed and counted**, never as reused bytes.  Recovery cost is
O(affected peers), not O(mesh).

Three pieces:

* :class:`ElasticController` — the control plane.  Consumes
  :class:`~repro_torch.ft.straggler.StragglerMonitor` escalations and
  injected faults (:mod:`repro_torch.ft.inject`) and drives each worker
  through the lifecycle ::

      healthy -> suspect -> quarantined -> evicted -> rejoined -> healthy

  On eviction it re-derives the shrunken :class:`Topology`, drops exactly
  the cached plans whose fingerprint died
  (:func:`repro_torch.core.rma.plan.invalidate_topology`), and runs the
  caller's ``rebuild`` / ``migrate`` / ``on_evict`` hooks — every recovery
  is written up as a :class:`RecoveryReport`.
* :func:`migrate_pages` — the data plane: a victim's live pages pushed to
  survivors as one batched handle push (a ``transfer_plan`` replay: one
  guarded K3 launch a page on the card) on a dedicated migration stream
  (:data:`MIGRATION_STREAM`).
* :class:`ElasticServing` — glue binding an injector + controller to a
  :class:`~repro_torch.serve.engine.ServeEngine`: a quarantined worker's
  slots are drained, its in-flight sequences re-admitted through scheduler
  ``requeue`` (re-prefill makes the drained tokens bit-identical to a
  fault-free run), and its unclaimed fetch_op tickets released so the
  admission window never leaks.

The controller and its state machine are pure Python and equal the JAX
package's transition for transition; the engine it drives runs on the card
unless it was built on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Callable

from repro_torch.core.rma.plan import invalidate_topology, plan_cache_stats
from repro_torch.core.rma.topology import Topology
from repro_torch.ft.inject import Fault, FaultInjector, FaultScript
from repro_torch.ft.straggler import StragglerEvent, StragglerMonitor

# -- lifecycle states --------------------------------------------------------
HEALTHY = "healthy"          # full member of the decode set
SUSPECT = "suspect"          # strikes accumulating, still serving
QUARANTINED = "quarantined"  # out of the decode set, grace for in-flight
EVICTED = "evicted"          # removed from the topology, recovery ran
REJOINED = "rejoined"        # back after eviction, on probation

LIFECYCLE = (HEALTHY, SUSPECT, QUARANTINED, EVICTED, REJOINED)

#: Stream victim-page migration rides on — distinct from the serving data
#: plane's push lanes (0/1) so recovery traffic neither shares a flush
#: epoch with nor serializes behind in-flight prefill pushes (the pool
#: windows declare ``max_streams=4``; the tier plans use 2/3 on the *host*
#: window, a different substrate).
MIGRATION_STREAM = 2


@dataclasses.dataclass
class WorkerState:
    worker: int
    state: str = HEALTHY
    strikes: int = 0
    since: int = 0             # tick of the last state change


@dataclasses.dataclass(frozen=True)
class Transition:
    worker: int
    frm: str
    to: str
    tick: int
    reason: str


@dataclasses.dataclass
class RecoveryReport:
    """One eviction's (or rejoin's) full recovery accounting."""

    worker: int
    tick: int
    reason: str
    old_topology: Topology
    new_topology: Topology
    plans_dropped: dict        # cache name -> dropped keys
    plans_rebuilt: int         # plans recompiled by the rebuild hook
    migration: dict            # migrate hook's stats (pages, peers, ...)
    requeued: int              # in-flight sequences re-admitted
    duration_s: float = 0.0

    @property
    def dropped_count(self) -> int:
        return sum(len(v) for v in self.plans_dropped.values())


def shrink_topology(topo: Topology, n_alive: int,
                    evicted=()) -> Topology:
    """The surviving mesh's declared factorization after eviction.

    When the evicted ranks cover whole hosts exactly (the common real
    failure: a host drops with all its local devices), the factorization
    survives with fewer hosts — ``Topology(g-k, l)``.  Any partial-host
    loss cannot tile host-major, so the survivors get the safe flat
    declaration ``Topology.flat(n_alive)`` rather than a wrong hierarchy."""
    if n_alive < 1:
        raise ValueError(f"cannot shrink to {n_alive} workers")
    g, l = topo.hosts, topo.local
    by_host = Counter(topo.host_of(int(w)) for w in set(evicted))
    if (by_host and all(c == l for c in by_host.values())
            and (g - len(by_host)) * l == n_alive):
        return Topology(g - len(by_host), l)
    return Topology.flat(n_alive)


def migrate_pages(pool, moves, perm, *, stream: int = MIGRATION_STREAM,
                  backend: str = "rma"):
    """Migrate a victim's live KV pages to survivor-owned slots.

    ``moves`` is a sequence of ``(src_page, dst_page)``: each source page is
    read from the pool (:meth:`~repro_torch.serve.paged.PagedKVWindow.
    read_page`) and the batch is pushed into the destination pages through
    their memory handles — one :meth:`~repro_torch.serve.paged.
    PagedKVWindow.push_pages` plan replay on the dedicated migration stream
    (2 phases per page + 2 for the single exit epoch, so the transfer count
    is O(victim pages), never O(mesh); on the card one guarded K3 launch a
    page).  The destinations must already be ``alloc_page``'d by the
    receiver — the P5 handle exchange — and the *source* pages should be
    freed only **after** migration: the epoch bump then turns any read
    still racing the eviction into a zeroed, counted drop.

    Returns ``(pool, n_pages_moved)``."""
    moves = [(int(s), int(d)) for s, d in moves]
    if not moves:
        return pool, 0
    kvs = [pool.read_page(s) for s, _ in moves]
    pool = pool.push_pages([d for _, d in moves], kvs, perm, stream=stream,
                           backend=backend)
    return pool, len(moves)


class ElasticController:
    """The elastic control plane over ``n_workers`` ranks.

    Inputs: per-step durations (:meth:`observe_step` feeds the straggler
    monitor; its escalations strike the source worker), transport events
    (:meth:`note_lost_doorbell`), and scripted faults (:meth:`apply_fault`).
    :meth:`advance` runs the per-tick state machine — quarantine grace
    expiry triggers the recovery pipeline, probation expiry re-promotes a
    rejoined worker.

    Recovery hooks (all optional):

    * ``rebuild(new_topology, dropped) -> int`` — recompile plans for the
      surviving mesh; returns how many were rebuilt.
    * ``migrate(worker, new_topology) -> dict`` — move the victim's KV
      pages; returns stats (e.g. ``{"pages": 4, "peers": 1}``).
    * ``on_evict(worker) -> int`` — drain/re-admit the victim's in-flight
      sequences; returns how many were requeued.
    * ``on_rejoin(worker)`` — re-enable the worker's resources.
    * ``on_transition(Transition)`` — observability tap for every edge.
    """

    def __init__(self, n_workers: int, *, topology: Topology | None = None,
                 monitor: StragglerMonitor | None = None,
                 suspect_strikes: int = 2, quarantine_grace: int = 1,
                 probation: int = 3,
                 rebuild: Callable | None = None,
                 migrate: Callable | None = None,
                 on_evict: Callable | None = None,
                 on_rejoin: Callable | None = None,
                 on_transition: Callable | None = None):
        if n_workers < 2:
            raise ValueError("elastic control needs n_workers >= 2 "
                             "(eviction must leave a survivor)")
        self.n_workers = n_workers
        self.topology = topology if topology is not None \
            else Topology.flat(n_workers)
        if self.topology.axis_size != n_workers:
            raise ValueError(
                f"topology {self.topology} declares "
                f"{self.topology.axis_size} ranks, got n_workers={n_workers}")
        self.monitor = monitor if monitor is not None else StragglerMonitor(
            threshold=2.0, warmup_steps=2, escalate_after=2)
        self.monitor.on_escalate = self._on_escalate
        self.suspect_strikes = suspect_strikes
        self.quarantine_grace = quarantine_grace
        self.probation = probation
        self.rebuild = rebuild
        self.migrate = migrate
        self.on_evict = on_evict
        self.on_rejoin = on_rejoin
        self.on_transition = on_transition
        self.workers = {w: WorkerState(w) for w in range(n_workers)}
        self.transitions: list[Transition] = []
        self.reports: list[RecoveryReport] = []
        self._tick = 0

    # -- identity helpers -----------------------------------------------------
    @staticmethod
    def source_of(worker: int) -> str:
        """The monitor/scheduler source key for a worker rank."""
        return f"worker{worker}"

    def state_of(self, worker: int) -> str:
        return self.workers[worker].state

    def alive(self) -> list[int]:
        """Ranks still in the topology (everything but evicted)."""
        return [w for w, ws in self.workers.items() if ws.state != EVICTED]

    def serving(self) -> list[int]:
        """Ranks in the decode set (healthy / suspect / on probation)."""
        return [w for w, ws in self.workers.items()
                if ws.state in (HEALTHY, SUSPECT, REJOINED)]

    # -- inputs ---------------------------------------------------------------
    def observe_step(self, worker: int, duration: float,
                     tick: int | None = None) -> StragglerEvent | None:
        """Feed one worker-step time; escalations strike the worker."""
        if tick is not None:
            self._tick = tick
        if self.workers[worker].state in (QUARANTINED, EVICTED):
            return None
        return self.monitor.observe(self._tick, duration,
                                    source=self.source_of(worker))

    def note_lost_doorbell(self, worker: int, tick: int | None = None) -> None:
        """A put_signal doorbell never landed (transport loss, RAMC-style):
        one suspect strike with no slow step involved."""
        if tick is not None:
            self._tick = tick
        self._strike(worker, "lost_doorbell")

    def apply_fault(self, fault: Fault, tick: int | None = None,
                    ) -> RecoveryReport | None:
        """React to one injected fault.  ``slow_step`` needs no direct
        action (it manifests through :meth:`observe_step` durations);
        ``dead_worker`` skips the grace period — there is nothing left to
        drain — and runs recovery immediately."""
        if tick is not None:
            self._tick = tick
        if fault.kind == "dead_worker":
            ws = self.workers[fault.worker]
            if ws.state == EVICTED:
                return None
            if ws.state != QUARANTINED:
                self._transition(fault.worker, QUARANTINED, "dead_worker")
            return self._evict(fault.worker, "dead_worker")
        if fault.kind == "lost_doorbell":
            self.note_lost_doorbell(fault.worker)
        elif fault.kind == "rejoin":
            self.rejoin(fault.worker)
        return None

    # -- per-tick state machine -----------------------------------------------
    def advance(self, tick: int) -> list[RecoveryReport]:
        """Run the tick's lifecycle edges: grace-expired quarantines evict
        (recovery pipeline), clean probations re-promote to healthy."""
        self._tick = tick
        reports = []
        for w, ws in list(self.workers.items()):
            if (ws.state == QUARANTINED
                    and tick - ws.since >= self.quarantine_grace):
                reports.append(self._evict(w, "quarantine_grace"))
            elif (ws.state == REJOINED
                    and tick - ws.since >= self.probation):
                self._transition(w, HEALTHY, "probation_clean")
        return reports

    def rejoin(self, worker: int) -> RecoveryReport | None:
        """Re-admit an evicted worker (probation).

        The monitor's memory of the worker is cleared
        (:meth:`StragglerMonitor.reset` with its source) — its pre-eviction
        offender count must not re-escalate it on the first slow step —
        and the topology re-expands, invalidating the shrunken mesh's
        plans exactly as eviction invalidated the old ones."""
        ws = self.workers[worker]
        if ws.state != EVICTED:
            return None
        self.monitor.reset(self.source_of(worker))
        self._transition(worker, REJOINED, "rejoin")
        ws.strikes = 0
        report = self._retopologize(worker, "rejoin", migrated={},
                                    requeued=0)
        if self.on_rejoin is not None:
            self.on_rejoin(worker)
        return report

    # -- internals -------------------------------------------------------------
    def _on_escalate(self, event: StragglerEvent) -> None:
        src = event.source
        if src.startswith("worker"):
            try:
                self._strike(int(src[len("worker"):]),
                             f"straggler x{event.ratio:.1f}")
            except ValueError:
                pass

    def _strike(self, worker: int, reason: str) -> None:
        ws = self.workers[worker]
        if ws.state in (QUARANTINED, EVICTED):
            return
        ws.strikes += 1
        if ws.state in (HEALTHY, REJOINED):
            self._transition(worker, SUSPECT, reason)
        if ws.strikes >= self.suspect_strikes:
            self._transition(worker, QUARANTINED,
                             f"{ws.strikes} strikes ({reason})")

    def _transition(self, worker: int, to: str, reason: str) -> None:
        ws = self.workers[worker]
        tr = Transition(worker, ws.state, to, self._tick, reason)
        ws.state, ws.since = to, self._tick
        self.transitions.append(tr)
        if self.on_transition is not None:
            self.on_transition(tr)

    def _evict(self, worker: int, reason: str) -> RecoveryReport:
        t0 = time.perf_counter()
        self._transition(worker, EVICTED, reason)
        requeued = self.on_evict(worker) if self.on_evict is not None else 0
        report = self._retopologize(worker, reason, requeued=requeued)
        report.duration_s = time.perf_counter() - t0
        return report

    def _retopologize(self, worker: int, reason: str, *,
                      migrated: dict | None = None,
                      requeued: int = 0) -> RecoveryReport:
        """The recovery pipeline shared by evict and rejoin: re-derive the
        topology, invalidate exactly the dead fingerprint's plans, then
        rebuild and migrate through the caller's hooks."""
        old = self.topology
        alive = self.alive()
        evicted = [w for w, ws in self.workers.items()
                   if ws.state == EVICTED]
        new = shrink_topology(old, len(alive), evicted) \
            if len(alive) < self.n_workers else Topology.flat(len(alive))
        dropped: dict = {}
        if new.fingerprint() != old.fingerprint():
            dropped = invalidate_topology(old.fingerprint())
        self.topology = new
        rebuilt = 0
        if self.rebuild is not None:
            rebuilt = int(self.rebuild(new, dropped) or 0)
        migration = migrated
        if migration is None:
            migration = dict(self.migrate(worker, new) or {}) \
                if self.migrate is not None else {}
        report = RecoveryReport(
            worker=worker, tick=self._tick, reason=reason,
            old_topology=old, new_topology=new, plans_dropped=dropped,
            plans_rebuilt=rebuilt, migration=migration, requeued=requeued)
        self.reports.append(report)
        return report

    # -- health ----------------------------------------------------------------
    def stats(self) -> dict:
        states = Counter(ws.state for ws in self.workers.values())
        return {
            "topology": repr(self.topology),
            "workers": {w: ws.state for w, ws in sorted(self.workers.items())},
            "states": dict(states),
            "transitions": len(self.transitions),
            "evictions": sum(1 for t in self.transitions if t.to == EVICTED),
            "rejoins": sum(1 for t in self.transitions if t.to == REJOINED),
            "plan_caches": plan_cache_stats(),
        }


class ElasticServing:
    """Bind a fault script + controller to a
    :class:`~repro_torch.serve.engine.ServeEngine`.

    The engine's ``n_slots`` decode slots are owned ``n_slots //
    n_workers`` per worker.  Each :meth:`tick`: the injector fires its
    scripted faults, surviving workers report step times, the controller
    runs its state machine, and the engine decodes one step.  When a
    worker is evicted its slots are drained — in-flight sequences go back
    through scheduler ``requeue`` (re-admission re-prefills from the
    prompt, so greedy tokens stay bit-identical to a fault-free run), the
    slots go offline so admission never lands on dead hardware, and the
    worker's unclaimed fetch_op tickets are released
    (:meth:`~repro_torch.serve.scheduler.Scheduler.release_claims`)."""

    def __init__(self, engine, script: FaultScript, *, n_workers: int,
                 base_step: float = 1.0, suspect_strikes: int = 2,
                 quarantine_grace: int = 1, probation: int = 3,
                 monitor: StragglerMonitor | None = None):
        if engine.n_slots % n_workers:
            raise ValueError(
                f"n_slots={engine.n_slots} must divide evenly over "
                f"n_workers={n_workers}")
        self.engine = engine
        self.n_workers = n_workers
        self.slots_per_worker = engine.n_slots // n_workers
        self.injector = FaultInjector(script, base_step=base_step)
        self.controller = ElasticController(
            n_workers, monitor=monitor, suspect_strikes=suspect_strikes,
            quarantine_grace=quarantine_grace, probation=probation,
            on_evict=self._evict_worker, on_rejoin=self._rejoin_worker)

    def slots_of(self, worker: int) -> list[int]:
        w0 = worker * self.slots_per_worker
        return list(range(w0, w0 + self.slots_per_worker))

    # -- controller hooks ------------------------------------------------------
    def _evict_worker(self, worker: int) -> int:
        slots = self.slots_of(worker)
        requeued = self.engine.evict_slots(slots, requeue=True)
        self.engine.set_slots_offline(slots, True)
        self.engine.scheduler.release_claims(
            ElasticController.source_of(worker))
        return requeued

    def _rejoin_worker(self, worker: int) -> None:
        self.engine.set_slots_offline(self.slots_of(worker), False)

    # -- driving ---------------------------------------------------------------
    def tick(self) -> None:
        fired = self.injector.advance()
        t = self.injector.tick
        for f in fired:
            self.controller.apply_fault(f, t)
        for w, d in self.injector.durations(self.n_workers).items():
            self.controller.observe_step(w, d, t)
        self.controller.advance(t)
        self.engine.step()

    def run(self, max_ticks: int = 10_000) -> list:
        """Tick until every submitted request completes (or raise)."""
        eng = self.engine
        for _ in range(max_ticks):
            if not (eng.scheduler.pending_count or eng.slot_req):
                return list(eng.done)
            self.tick()
        raise RuntimeError(
            f"elastic run did not drain in {max_ticks} ticks "
            f"(pending={eng.scheduler.pending_count}, "
            f"live={sorted(eng.slot_req)}, "
            f"states={self.controller.stats()['workers']})")

    def stats(self) -> dict:
        return {**self.engine.stats(), "elastic": self.controller.stats(),
                "faults_injected": len(self.injector.injected)}


__all__ = [
    "ElasticController", "ElasticServing", "WorkerState", "Transition",
    "RecoveryReport", "shrink_topology", "migrate_pages",
    "MIGRATION_STREAM", "LIFECYCLE",
    "HEALTHY", "SUSPECT", "QUARANTINED", "EVICTED", "REJOINED",
]
