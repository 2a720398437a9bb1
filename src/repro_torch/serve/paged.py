"""The KV page pool's host-side bookkeeping: a tier-generic refcounted page
core with copy-on-write sharing (:class:`PageTier`) and the tiered pool
manager composing an HBM hot tier and a host-memory cold tier
(:class:`KVPoolManager`) — pure Python, ported from the JAX package's
``serve/paged.py``.

The device side of the tiered pool (``PagedKVWindow``, ``HostKVTier`` in
pinned memory, ``transfer_plan``, ``tier_step_plan``) is not ported yet
(ROADMAP item 8); the serving engine uses the hot tier alone.
"""
from __future__ import annotations

#: Residency states a physical page moves through in the tiered pool.
RESIDENT_HOT = "hot"            # device-resident, decodable
RESIDENT_COLD = "cold"          # host-resident (demoted), not decodable
RESIDENT_IN_FLIGHT = "in-flight"  # queued/under migration between tiers


class PageTier:
    """One memory tier's refcounted page core with copy-on-write sharing.

    This is the tier-generic half of the pool split: everything that makes
    "a page" safe to own — refcounts, the FIFO free list (freed pages are
    reused as late as possible, maximum grace for in-flight transfers),
    the COW ledger and fork-debt reserve, and the double-free / not-
    allocated guards — parameterized only by a name and a capacity.
    :class:`KVPoolManager` composes two of these (the HBM hot tier and the
    host-memory cold tier) and layers residency/migration state on top;
    neither tier knows the other exists.

    Guards: releasing a page with refcount 0 (double free / never
    allocated) raises with the page id; so does sharing or cow-writing one.
    :meth:`can_admit` reserves one free page per outstanding writable share
    (each such holder may still fork), so admission never promises pages a
    later COW fault will need.
    """

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity
        self._ref = [0] * capacity
        self._free = list(range(capacity))
        # writable-shared pages -> writer count (owner + writable sharers);
        # read-only sharers hold references but never fork
        self._cow: dict[int, int] = {}
        self.allocs = 0
        self.frees = 0
        self.cow_copies = 0
        self.shared_maps = 0

    # -- capacity ---------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def cow_debt(self) -> int:
        """Free pages that must stay reserved for pending COW forks.

        Per writable-shared page the worst case is ``min(writers, ref - 1)``
        forks: every writer forks while other references pin the page, and
        the last writer writes in place only when no read-only holder
        remains (all-writable sharing keeps the classic ``ref - 1``)."""
        return sum(min(w, self._ref[p] - 1)
                   for p, w in self._cow.items() if self._ref[p] > 1)

    def can_admit(self, n_fresh: int, n_writable_shares: int = 0) -> bool:
        """Would allocating ``n_fresh`` pages plus ``n_writable_shares``
        more units of fork debt stay fork-safe?  Price shares with
        :meth:`share_price` — a writable share of a page that already has
        read-only holders costs *more* than one unit (the owner is dragged
        into forking too)."""
        return len(self._free) - self.cow_debt >= n_fresh + n_writable_shares

    def share_price(self, pages, *, writable: bool = False) -> int:
        """The COW-debt delta :meth:`share_pages` of ``pages`` would incur —
        what admission must pass to :meth:`can_admit`.  Non-writable shares
        are not free either: one more read-only holder of a writable-shared
        page can push its last writer from write-in-place to fork."""
        ref = {p: self._ref[p] for p in set(pages)}
        wrt = {p: self._cow.get(p) for p in set(pages)}

        def debt(p):
            w = wrt[p]
            return min(w, ref[p] - 1) if w is not None and ref[p] > 1 else 0

        delta = 0
        for p in pages:
            before = debt(p)
            ref[p] += 1
            if writable:
                wrt[p] = (wrt[p] if wrt[p] is not None else 1) + 1
            delta += debt(p) - before
        return delta

    # -- lifecycle ---------------------------------------------------------------
    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted ({self.name} tier): need {n} "
                f"pages, {len(self._free)}/{self.capacity} free")
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._ref[p] = 1
        self.allocs += n
        return pages

    def refcount_of(self, page: int) -> int:
        return self._ref[page]

    def share_pages(self, pages, *, writable: bool = False) -> None:
        """Map already-allocated pages into one more sequence (refcount+1).

        ``writable=True`` marks the share copy-on-write: the page sits at a
        holder's future write position (a partial prefix page) and one free
        page is reserved per extra holder for the eventual fork."""
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(f"share_pages({p}): page is not allocated")
            self._ref[p] += 1
            if writable:
                self._cow[p] = self._cow.get(p, 1) + 1
        self.shared_maps += len(pages)

    def cow_write(self, page: int) -> tuple[int, bool]:
        """Resolve a write to ``page``: ``(page, False)`` if this holder is
        the sole owner (write in place), else fork — allocate a fresh page,
        move one reference onto it, and return ``(new_page, True)``; the
        caller copies the contents and remaps its page table."""
        if self._ref[page] <= 0:
            raise ValueError(f"cow_write({page}): page is not allocated")
        if self._ref[page] == 1:
            self._cow.pop(page, None)
            return page, False
        if not self._free:
            raise RuntimeError(
                f"cow_write({page}): pool exhausted at fork "
                f"(admission outran the COW reserve)")
        new = self._free.pop(0)
        self._ref[new] = 1
        self._ref[page] -= 1
        if page in self._cow:
            self._cow[page] -= 1     # the forking writer moved off the page
            if self._cow[page] <= 0 or self._ref[page] <= 1:
                del self._cow[page]
        self.allocs += 1
        self.cow_copies += 1
        return new, True

    def release(self, pages) -> list[int]:
        """Drop one reference per page; pages reaching refcount 0 return to
        the FIFO free list.  Returns the pages whose refcount dropped to
        ``<= 1`` (no longer shared — the engine clears their write
        protection).  Raises on double free with the offending page id."""
        dropped = []
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(
                    f"release({p}): double free (page is not allocated)")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                self.frees += 1
                self._cow.pop(p, None)
                dropped.append(p)
            elif self._ref[p] == 1:
                self._cow.pop(p, None)
                dropped.append(p)
        return dropped

    def check_conservation(self) -> None:
        """Assert the tier's conservation invariants (the Hypothesis sweep's
        oracle): every page is exactly one of free or refcounted — live
        count + free-list size == capacity, the free list holds no
        duplicates and no live page, refcounts are non-negative, and the COW
        fork debt never exceeds the free pages backing it."""
        live = sum(1 for r in self._ref if r > 0)
        assert live + len(self._free) == self.capacity, \
            f"{self.name}: {live} live + {len(self._free)} free " \
            f"!= {self.capacity} pages"
        assert len(set(self._free)) == len(self._free), \
            f"{self.name}: duplicate pages in the free list"
        assert all(self._ref[p] == 0 for p in self._free), \
            f"{self.name}: live page on the free list"
        assert all(r >= 0 for r in self._ref), \
            f"{self.name}: negative refcount"
        assert self.cow_debt <= len(self._free), \
            f"{self.name}: cow_debt {self.cow_debt} exceeds " \
            f"{len(self._free)} free pages"


class KVPoolManager:
    """Tiered physical-page pool: an HBM hot tier + a host-memory cold tier.

    The serving engine's pool layer: where a plain page allocator hands
    every sequence exclusive pages, this manager lets sequences with a
    common prompt prefix *map the same physical page* — a refcount per page, :meth:`share_pages` to map an
    allocated page into another sequence, and :meth:`cow_write` to fork a
    shared page the moment a holder needs to write it (vLLM-style COW on the
    paper's memhandle lifetime model: a physical page is a memhandle whose
    exposure outlives any one sequence, and the epoch machinery — not this
    bookkeeping — is what catches a stale access if the two ever disagree).

    With ``host_pages > 0`` the pool becomes a **memory hierarchy**
    ("MPI Windows on Storage" applied to KV): two :class:`PageTier` cores —
    ``hbm`` (what decode reads) and ``host`` (cold spill, backed by a
    host-memory window at the engine layer, not ported yet: ROADMAP item 8)
    — plus per-page residency state and demotion/promotion queues.  Page naming is
    tier-scoped: ``("hbm", p)`` and ``("host", s)`` are different physical
    pages; a migration copies payload between them and retires one side.
    The refcount/COW machinery lives entirely in the hot tier — sharing
    dissolves at demotion (the cold copy is private to its sequence) so a
    cold page has exactly one owner by construction.

    Every pre-tier entry point (``alloc``/``release``/``share_pages``/
    ``cow_write``/``can_admit``/counters/``stats()``) delegates to the hot
    tier unchanged — a ``KVPoolManager(n)`` without host pages is
    behaviorally identical to the pre-hierarchy flat pool, FIFO order and
    error messages included.
    """

    def __init__(self, n_pages: int, host_pages: int = 0):
        self.hbm = PageTier("hbm", n_pages)
        self.host = PageTier("host", host_pages)
        #: residency by (tier_name, page): RESIDENT_* or absent (free)
        self._residency: dict[tuple[str, int], str] = {}
        self._demote_q: list[tuple[int, int]] = []   # (hbm_page, host_slot)
        self._promote_q: list[int] = []              # host_slot
        self.demotions = 0
        self.promotions = 0

    # -- hot-tier delegation (the pre-tier surface, byte-identical) ----------
    @property
    def n_pages(self) -> int:
        return self.hbm.capacity

    @property
    def n_free(self) -> int:
        return self.hbm.n_free

    @property
    def cow_debt(self) -> int:
        return self.hbm.cow_debt

    @property
    def allocs(self) -> int:
        return self.hbm.allocs

    @property
    def frees(self) -> int:
        return self.hbm.frees

    @property
    def cow_copies(self) -> int:
        return self.hbm.cow_copies

    @property
    def shared_maps(self) -> int:
        return self.hbm.shared_maps

    @property
    def _ref(self):
        return self.hbm._ref

    @property
    def _free(self):
        return self.hbm._free

    @property
    def _cow(self):
        return self.hbm._cow

    def can_admit(self, n_fresh: int, n_writable_shares: int = 0) -> bool:
        """Decode-set admission: would the **hot tier alone** back
        ``n_fresh`` fresh pages plus ``n_writable_shares`` writable shares,
        fork-safe?  (Total-footprint pricing against HBM+host is the
        scheduler's :meth:`~repro_torch.serve.scheduler.Scheduler.
        price_admission`; this is the per-tick decode-set half.)"""
        return self.hbm.can_admit(n_fresh, n_writable_shares)

    def share_price(self, pages, *, writable: bool = False) -> int:
        return self.hbm.share_price(pages, writable=writable)

    def alloc(self, n: int) -> list[int]:
        pages = self.hbm.alloc(n)
        for p in pages:
            self._residency[("hbm", p)] = RESIDENT_HOT
        return pages

    def refcount_of(self, page: int) -> int:
        return self.hbm.refcount_of(page)

    def share_pages(self, pages, *, writable: bool = False) -> None:
        self.hbm.share_pages(pages, writable=writable)

    def cow_write(self, page: int) -> tuple[int, bool]:
        new, forked = self.hbm.cow_write(page)
        if forked:
            self._residency[("hbm", new)] = RESIDENT_HOT
        return new, forked

    def release(self, pages) -> list[int]:
        dropped = self.hbm.release(pages)
        for p in dropped:
            if self.hbm.refcount_of(p) == 0:
                self._residency.pop(("hbm", p), None)
        return dropped

    # -- cold tier + residency -----------------------------------------------
    def alloc_cold(self, n: int) -> list[int]:
        """Take ``n`` host-tier slots for incoming demotions; they report
        in-flight until :meth:`drain_demotes` lands the payloads."""
        slots = self.host.alloc(n)
        for s in slots:
            self._residency[("host", s)] = RESIDENT_IN_FLIGHT
        return slots

    def free_cold(self, slots) -> None:
        """Retire cold copies (their sequence promoted back, or finished).
        The backing window's ``free_page`` epoch bump — not this
        bookkeeping — is what makes outstanding handles stale."""
        self.host.release(slots)
        gone = set(slots)
        self._promote_q = [s for s in self._promote_q if s not in gone]
        for s in slots:
            self._residency.pop(("host", s), None)

    def residency(self, tier: str, page: int) -> str | None:
        """RESIDENT_* for a live page of ``tier`` (``"hbm"``/``"host"``),
        ``None`` if the page is free/unknown."""
        return self._residency.get((tier, page))

    def queue_demote(self, hbm_page: int, host_slot: int) -> None:
        """Stage one page for demotion: both sides report in-flight until
        the planned put lands and :meth:`drain_demotes` commits."""
        self._residency[("hbm", hbm_page)] = RESIDENT_IN_FLIGHT
        self._residency[("host", host_slot)] = RESIDENT_IN_FLIGHT
        self._demote_q.append((hbm_page, host_slot))

    def drain_demotes(self) -> list[tuple[int, int]]:
        """Commit every staged demotion (the planned puts completed): cold
        copies become resident, the HBM side returns to ``hot`` for the
        caller to release.  Returns the drained (hbm_page, host_slot)
        pairs."""
        pairs, self._demote_q = self._demote_q, []
        for hp, hs in pairs:
            self._residency[("hbm", hp)] = RESIDENT_HOT
            self._residency[("host", hs)] = RESIDENT_COLD
        self.demotions += len(pairs)
        return pairs

    def queue_promote(self, host_slots) -> None:
        """Schedule cold copies for promotion next tick (they report
        in-flight — neither decodable nor reclaimable while queued)."""
        for s in host_slots:
            self._residency[("host", s)] = RESIDENT_IN_FLIGHT
            self._promote_q.append(s)

    def drain_promotes(self, host_slots=None) -> list[int]:
        """Commit promotions for ``host_slots`` (default: everything
        queued): drop them from the queue and count them.  The caller
        lands the payloads in fresh hot pages and then :meth:`free_cold`\\ s
        the slots; a slot left queued (promotion deferred) stays
        in-flight."""
        if host_slots is None:
            done, self._promote_q = self._promote_q, []
        else:
            done = [s for s in self._promote_q if s in set(host_slots)]
            self._promote_q = [s for s in self._promote_q
                               if s not in set(host_slots)]
        self.promotions += len(done)
        return done

    def assert_resident(self, pages) -> None:
        """Raise unless every hot-tier page is decode-ready (``hot``): the
        engine's pre-decode residency check — a cold or in-flight page in a
        decode set means host and device state disagree."""
        for p in pages:
            r = self._residency.get(("hbm", p))
            if r != RESIDENT_HOT:
                raise RuntimeError(
                    f"page {p} is not resident (residency={r!r}) — "
                    "decode would read a non-hot page")

    def check_conservation(self) -> None:
        """Both tiers' conservation invariants plus the residency map's:
        every residency entry names a live page of its tier."""
        self.hbm.check_conservation()
        self.host.check_conservation()
        for (tier, p), state in self._residency.items():
            t = self.hbm if tier == "hbm" else self.host
            assert t.refcount_of(p) > 0, \
                f"residency entry for free page ({tier}, {p}): {state}"

    # -- health ----------------------------------------------------------------
    def stats(self) -> dict:
        live = sum(1 for r in self.hbm._ref if r > 0)
        st = {
            "n_pages": self.n_pages,
            "n_free": self.n_free,
            "live_pages": live,
            "occupancy": live / max(self.n_pages, 1),
            "allocs": self.allocs,
            "frees": self.frees,
            "cow_copies": self.cow_copies,
            "shared_maps": self.shared_maps,
            "cow_debt": self.cow_debt,
        }
        if self.host.capacity:
            st.update({
                "host_pages": self.host.capacity,
                "host_free": self.host.n_free,
                "cold_pages": sum(1 for v in self._residency.values()
                                  if v == RESIDENT_COLD),
                "in_flight": sum(1 for v in self._residency.values()
                                 if v == RESIDENT_IN_FLIGHT),
                "demotions": self.demotions,
                "promotions": self.promotions,
            })
        return st


__all__ = ["PageTier", "KVPoolManager", "RESIDENT_HOT", "RESIDENT_COLD",
           "RESIDENT_IN_FLIGHT"]
