"""Admission scheduling for the serving stack — the policy layer (a copy of
the JAX package's pure-Python ``serve/scheduler.py``).

The serving engine is split into three layers:

* **scheduler** (this module) — owns the request queue (arrival ticks,
  priorities, tenants) and decides *which* pending requests are admitted
  into free decode slots *each tick* (continuous batching), or only between
  whole batches (the static baseline).  The same policy object is meant to
  drive the disaggregated control window's fetch_op ticket admission
  (``serve/disagg.py::claim_slots``): :meth:`Scheduler.ticket_window` is how many
  tickets a decode lane may claim this tick, and
  :meth:`Scheduler.slot_for_ticket` maps a claimed ticket to a slot.
* **KV pool manager** (:class:`repro_torch.serve.paged.KVPoolManager`) —
  owns the physical pages (refcounts, copy-on-write sharing, free list).
* **executor** (:class:`repro_torch.serve.engine.Executor`) — runs
  prefill/decode against whatever the scheduler admitted.

The scheduler is pure host-side bookkeeping: it never touches device arrays,
so policies are cheap to extend and trivially testable.

Policies
--------

``continuous`` (default)
    In-flight admission every decode tick: any free slot is refilled from
    the queue immediately, FIFO by arrival.  Short requests never wait for
    the longest request of a batch.
``static``
    The classic static-batch baseline: admission only happens when *no*
    sequence is in flight — a full batch is admitted, decoded to
    completion, and only then is the next batch formed.
``priority``
    Continuous admission ordered by ``Request.priority`` (higher first),
    FIFO within a priority class.
``fair``
    Continuous fair-share admission across tenants: each admission goes to
    the pending request whose ``Request.tenant`` has the fewest admissions
    so far (FIFO within a tenant) — one tenant's burst cannot starve the
    others.
"""
from __future__ import annotations

import dataclasses

from repro_torch import obs

POLICIES = ("continuous", "static", "priority", "fair")


@dataclasses.dataclass
class SchedEntry:
    """A queued request plus its arrival bookkeeping."""

    req: object               # repro_torch.serve.engine.Request
    arrival: int              # engine tick at submission
    t_submit: float           # perf_counter at submission (queue wait)
    seq: int                  # monotone submission index (FIFO tiebreak)
    priority: int = 0
    tenant: int = 0


class Scheduler:
    """Request queue + admission policy over ``n_slots`` decode slots."""

    def __init__(self, n_slots: int, policy: str = "continuous"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r} (one of {POLICIES})")
        self.n_slots = n_slots
        self.policy = policy
        self._queue: list[SchedEntry] = []
        self._seq = 0
        self._tenant_admitted: dict[int, int] = {}
        self._claims: dict[str, int] = {}
        self.submitted = 0
        self.admitted = 0

    # -- queue ---------------------------------------------------------------
    def submit(self, req, *, tick: int = 0, t_submit: float = 0.0) -> SchedEntry:
        entry = SchedEntry(req, tick, t_submit, self._seq,
                           getattr(req, "priority", 0),
                           getattr(req, "tenant", 0))
        self._seq += 1
        self._queue.append(entry)
        self.submitted += 1
        return entry

    @property
    def pending_count(self) -> int:
        return len(self._queue)

    def pending_entries(self) -> list[SchedEntry]:
        return list(self._queue)

    # -- admission ------------------------------------------------------------
    def select(self, free_slots: int, *, live: int, tick: int = 0,
               ) -> list[SchedEntry]:
        """Pick up to ``free_slots`` entries to admit this tick.

        Selected entries leave the queue; if the engine cannot actually
        admit one (KV pool pressure), it hands it back via :meth:`requeue`.
        ``static`` returns nothing while any sequence is live.
        """
        if free_slots <= 0 or not self._queue:
            return []
        if self.policy == "static" and live > 0:
            return []
        with obs.span("sched.select") as sp:
            picked = self._pick(free_slots)
            if sp:
                sp.attrs["picked"] = [e.req.rid for e in picked]
        return picked

    def _pick(self, free_slots: int) -> list[SchedEntry]:
        k = min(free_slots, len(self._queue))
        if self.policy == "priority":
            order = sorted(self._queue, key=lambda e: (-e.priority, e.seq))
            picked = order[:k]
        elif self.policy == "fair":
            picked, pool = [], list(self._queue)
            served = dict(self._tenant_admitted)
            for _ in range(k):
                best = min(pool, key=lambda e: (served.get(e.tenant, 0), e.seq))
                picked.append(best)
                pool.remove(best)
                served[best.tenant] = served.get(best.tenant, 0) + 1
        else:  # continuous / static: FIFO
            picked = self._queue[:k]
        taken = {e.seq for e in picked}
        self._queue = [e for e in self._queue if e.seq not in taken]
        for e in picked:
            self._tenant_admitted[e.tenant] = \
                self._tenant_admitted.get(e.tenant, 0) + 1
            self.admitted += 1
        return picked

    def requeue(self, entry: SchedEntry) -> None:
        """Hand back an entry the engine could not admit (pool pressure):
        it goes to the queue front with its original arrival order intact."""
        self._tenant_admitted[entry.tenant] = \
            self._tenant_admitted.get(entry.tenant, 0) - 1
        self.admitted -= 1
        self._queue.insert(0, entry)

    # -- tiered capacity pricing ----------------------------------------------
    @staticmethod
    def price_admission(*, pages_per_seq: int, hbm_free: int,
                        host_free: int, reserve: int = 0) -> int:
        """How many more sequences the **whole hierarchy** can hold.

        Tiered admission is priced in two halves: a sequence's *total*
        footprint (``pages_per_seq``) against HBM + host capacity — this
        method — while its *decode-set* pages are priced against HBM only
        (:meth:`repro_torch.serve.paged.KVPoolManager.can_admit` at the moment it
        is activated).  Admitting against total capacity is what lets the
        host tier multiply concurrent sequences; activating against HBM
        only is what makes an admitted-but-cold sequence *wait its turn*
        (requeue / stay cold) instead of deadlocking the hot free list.
        ``reserve`` holds back pages promised elsewhere (the COW fork
        debt)."""
        if pages_per_seq <= 0:
            return hbm_free + host_free
        return max(hbm_free + host_free - reserve, 0) // pages_per_seq

    # -- disagg ticket admission ---------------------------------------------
    def ticket_window(self, live: int) -> int:
        """How many fetch_op admission tickets a decode lane may claim this
        tick on the disagg control window — the policy's admission decision
        expressed as a ticket budget (``claim_slots`` consumes it).

        Tickets already claimed but not yet bound to a live sequence
        (:meth:`note_claims`) count against the window: slots promised to
        one worker's outstanding claims are not offered to another."""
        if self.policy == "static" and live > 0:
            return 0
        return max(self.n_slots - live - self.outstanding_claims(), 0)

    def slot_for_ticket(self, ticket):
        """Map a claimed admission ticket to a decode slot (an int, or a
        tensor of tickets on the card: no host read)."""
        return ticket % self.n_slots

    # -- ticket claim bookkeeping (per claiming worker) -----------------------
    def note_claims(self, n: int, *, source: str = "default") -> None:
        """Record ``n`` fetch_op tickets claimed by ``source`` and not yet
        bound to live sequences.  Host-side counts only — the tickets
        themselves are device values inside the SPMD region."""
        if n > 0:
            self._claims[source] = self._claims.get(source, 0) + int(n)

    def consume_claims(self, n: int = 1, *, source: str = "default") -> int:
        """``source`` bound ``n`` of its claims to admitted sequences;
        returns how many were actually outstanding (never negative)."""
        cur = self._claims.get(source, 0)
        take = min(cur, max(int(n), 0))
        if cur - take:
            self._claims[source] = cur - take
        else:
            self._claims.pop(source, None)
        return take

    def release_claims(self, source: str) -> int:
        """Return **all** of ``source``'s unclaimed tickets to the window —
        the eviction path: a quarantined worker's outstanding claims would
        otherwise hold admission slots forever and stall recovery.
        Returns how many were released."""
        return self._claims.pop(source, 0)

    def outstanding_claims(self, source: str | None = None) -> int:
        if source is not None:
            return self._claims.get(source, 0)
        return sum(self._claims.values())

    # -- health ----------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "policy": self.policy,
            "pending": len(self._queue),
            "submitted": self.submitted,
            "admitted": self.admitted,
            "tenants": dict(self._tenant_admitted),
            "outstanding_claims": dict(self._claims),
        }


__all__ = ["Scheduler", "SchedEntry", "POLICIES"]
