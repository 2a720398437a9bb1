"""The paged KV cache as a dynamic RMA window (the serving-side use of P5),
and the KV page pool's host-side bookkeeping — ported from the JAX
package's ``serve/paged.py``.

The device side: :class:`PagedKVWindow` is a fixed-capacity page pool
exposed as a dynamic window (pages are attached segments, each with a
memory handle, freed through ``memhandle_release``), :func:`transfer_plan`
the planned page push, and the tiered pool's cold tier: :class:`HostKVTier`
keeps its pages in pinned host memory behind the same window and handle
machinery, and :func:`tier_step_plan` is one tick's tier traffic — promote
reads as prefetch edges, demote writes, one replay.  On the card every page
moves by kernel K3 (a guarded handle put or read at the pool's
device-mapped address), and every flush or prefetch-wait is K3's wait.

The host side: a tier-generic refcounted page core with copy-on-write
sharing (:class:`PageTier`) and the tiered pool manager composing an HBM
hot tier and a host-memory cold tier (:class:`KVPoolManager`), pure Python.

Ranks are the rows of stacked tensors: the pool is ``(n, n_pages ·
page_elems)``, ``handles`` ``(n, n_pages, 4)``; page lifecycle (alloc,
free and their guards) reads a host-side mirror of which pages are live,
never the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.rma import (DynamicWindow, WindowConfig,
                                  memhandle_create, memhandle_release,
                                  win_from_memhandle)
from repro_torch.core.rma.plan import register_plan_cache
from repro_torch.device import resolve_device
from repro_torch.kernels.common import as_dtype

#: the memory handle's offset word is int32: a pool of 2^31 elements or
#: more would wrap page offsets (the JAX package wraps silently)
MAX_POOL_ELEMS = 2**31 - 1

_TRANSFER_PLANS: dict[tuple, object] = register_plan_cache("kv_transfer", {})


def _dtype_name(dt: torch.dtype) -> str:
    """A dtype's name as numpy and JAX spell it (``"bfloat16"``)."""
    return str(dt).rsplit(".", 1)[-1]


def transfer_plan(pool_pages: int, pages: tuple, page_elems: int, dtype,
                  perm: tuple, stream: int = 0, *,
                  naive_flush: bool = False, topology=None,
                  backend: str = "rma"):
    """Build (or fetch from the build-once cache) the compiled page push:
    one :meth:`RmaPlan.put_handle` per page on the batch's ordered stream
    and one exit flush epoch — 2 phases per page (payload + handle header)
    and 2 for the epoch, never a per-page ack.  ``topology`` (part of the
    cache key) classifies a push that stays on one host into the
    shared-memory tier.  ``backend``: ``"auto"`` resolves to ``"rma"`` (a
    page push records no collective macro, so ``"gspmd"`` compiles the
    substrate schedule too, and ``"interpret"`` tags it for the walker)."""
    from repro_torch.core.rma.plan import RmaPlan
    from repro_torch.core.rma.topology import topology_fingerprint

    if backend == "auto":
        backend = "rma"        # no macro to ever pick gspmd for
    dt = as_dtype(dtype)
    key = (pool_pages, tuple(pages), page_elems, _dtype_name(dt), perm,
           stream, naive_flush, topology_fingerprint(topology), backend)
    if key in _TRANSFER_PLANS:
        return _TRANSFER_PLANS[key]
    plan = RmaPlan(f"transfer_pages[{len(pages)}]", topology=topology)
    plan.window("pool", scope="thread", order=True, max_streams=stream + 1,
                dtype=dt, exit_epoch=True)
    plan.bind("handles", (pool_pages, 4), torch.int32)
    for i, page in enumerate(pages):
        plan.bind(f"kv{i}", (page_elems,), dt)
        plan.put_handle("pool", f"kv{i}",
                        lambda env, p=page: env["handles"][:, p], perm,
                        slot=page, stream=stream, shape=(page_elems,),
                        dtype=dt, label=f"page{page}")
    compiled = plan.compile(naive_flush=naive_flush, backend=backend)
    _TRANSFER_PLANS[key] = compiled
    return compiled


@dataclasses.dataclass(frozen=True)
class PageSpec:
    page_tokens: int          # tokens per page
    kv_heads: int
    head_dim: int
    n_pages: int              # pool capacity

    @property
    def page_elems(self) -> int:
        return self.page_tokens * self.kv_heads * self.head_dim * 2  # K and V


@dataclasses.dataclass
class PagedKVWindow:
    """Fixed-capacity page pool exposed as a dynamic window.

    ``window.buffer`` is the stacked pool ``(n, n_pages · page_elems)``;
    page *p* occupies columns ``[p·page_elems, (p+1)·page_elems)`` of every
    rank's row.  ``handles`` ``(n, n_pages, 4)`` holds each live page's
    memory handle per rank (what a remote engine would receive); ``live``
    is the host-side mirror of which pages are attached, so alloc and free
    and their guards never read the card.

    ``err_count`` ``(n,)`` aggregates the P5 stale-handle drops observed
    across every handle-path transfer through this pool (put, get,
    accumulate, batched pushes), by the rank that dropped them.  The
    methods update the pool in place and return it."""

    window: DynamicWindow
    handles: torch.Tensor
    live: torch.Tensor        # (n_pages,) bool, on the host
    spec: PageSpec
    err_count: torch.Tensor = None

    def __post_init__(self):
        if self.err_count is None:
            self.err_count = torch.zeros(self.window.axis_size,
                                         dtype=torch.int32,
                                         device=self.window.device)

    # -- construction ---------------------------------------------------------
    @classmethod
    def create(cls, spec: PageSpec, axis: str, axis_size: int,
               dtype=torch.bfloat16, *, topology=None, device="cuda",
               host: bool = False) -> "PagedKVWindow":
        """A zeroed pool on ``device`` (the card unless the caller asks for
        the CPU).  ``host=True`` keeps the pool itself in pinned host
        memory, under registration tables, handles and counters on the
        card: K3 reaches it at its device-mapped address.  A pool of 2^31
        elements or more raises (the handle's offset word is int32)."""
        dev = resolve_device(device)
        elems = spec.n_pages * spec.page_elems
        if elems > MAX_POOL_ELEMS:
            raise ValueError(
                f"a pool of {spec.n_pages} pages x {spec.page_elems} elements"
                f" = {elems} >= 2^31: the memory handle's offset word is "
                "int32 and would wrap")
        dt = as_dtype(dtype)
        if host:
            if dev.type != "cuda":
                raise ValueError("host=True keeps the pool in pinned host "
                                 "memory beside the card; on the CPU every "
                                 "pool is in host memory already")
            pool = torch.zeros((axis_size, elems), dtype=dt, pin_memory=True)
        else:
            pool = torch.zeros((axis_size, elems), dtype=dt, device=dev)
        win = DynamicWindow.create_dynamic(
            pool, axis, axis_size,
            WindowConfig(scope="thread", order=True, max_streams=4,
                         topology=topology),
            max_attach=spec.n_pages, am_slots=1, am_msg=1, device=dev)
        return cls(
            window=win,
            handles=torch.zeros((axis_size, spec.n_pages, 4),
                                dtype=torch.int32, device=dev),
            live=torch.zeros(spec.n_pages, dtype=torch.bool),
            spec=spec)

    def _live(self, page: int) -> bool:
        return 0 <= page < self.spec.n_pages and bool(self.live[page])

    # -- page lifecycle ---------------------------------------------------------
    def alloc_page(self, page: int) -> "PagedKVWindow":
        """Attach page ``page`` and create its memory handle (P5): local,
        no communication — the handle is what peers get.  Allocating a live
        page raises with the page id: a second attach would mint a handle
        at the epoch of the outstanding ones."""
        if self._live(page):
            raise ValueError(
                f"alloc_page({page}): page is already allocated "
                f"(double alloc — free_page it before re-attaching)")
        s = self.spec
        self.window.attach(page, offset=page * s.page_elems,
                           size=s.page_elems)
        self.handles[:, page] = memhandle_create(self.window, page)
        self.live[page] = True
        return self

    def free_page(self, page: int) -> "PagedKVWindow":
        """Release through ``memhandle_release``: the slot goes invalid,
        the epoch advances (stale handle writes are dropped and counted,
        stale reads come back zeroed and counted) and the release is
        recorded, so handle windows made for this page with ``slot=`` raise
        on a later use.  Freeing a page that is not live raises with the
        page id."""
        if not self._live(page):
            raise ValueError(
                f"free_page({page}): page is not allocated "
                f"(double free, or never alloc_page'd)")
        memhandle_release(self.window, page)
        self.handles[:, page] = 0
        self.live[page] = False
        return self

    # -- data paths ---------------------------------------------------------------
    def _columns(self, page: int) -> slice:
        if not 0 <= page < self.spec.n_pages:
            raise ValueError(f"page {page} outside the pool's "
                             f"{self.spec.n_pages}")
        e = self.spec.page_elems
        return slice(page * e, (page + 1) * e)

    def write_page_local(self, page: int, kv: torch.Tensor
                         ) -> "PagedKVWindow":
        """Local fill (an engine writing its own pool): ``kv`` is stacked
        per rank."""
        buf = self.window.buffer
        buf[:, self._columns(page)] = kv.reshape(buf.shape[0], -1).to(
            buf.dtype)
        return self

    def read_page(self, page: int) -> torch.Tensor:
        """Every rank's page ``(n, 2, page_tokens, kv_heads, head_dim)``."""
        s = self.spec
        return self.window.buffer[:, self._columns(page)].reshape(
            -1, 2, s.page_tokens, s.kv_heads, s.head_dim)

    def _handle_window(self, page: int, **info):
        """A handle window for ``page`` on a dup'd view of the pool (paper
        P4: the transfer's own config, the pool's substrate)."""
        view = self.window.dup_with_info(scope="thread", **info)
        return win_from_memhandle(view, self.handles[:, page], slot=page)

    def put_page_remote(self, page: int, kv: torch.Tensor, perm,
                        stream: int = 0, *, order: bool = True
                        ) -> "PagedKVWindow":
        """Push a filled page into a peer's pool through its memory handle:
        one guarded K3 launch, then the stream's flush.  The transfer runs
        on a dup'd view of the pool (ordered, thread-scope completion)."""
        mhw = self._handle_window(page, order=order)
        mhw.put(kv.reshape(self.window.axis_size, -1), perm, stream=stream)
        mhw.flush(stream)
        self.err_count += mhw.err_count
        return self

    def accumulate_page(self, page: int, update: torch.Tensor, perm, *,
                        op: str = "sum", offset: int = 0, stream: int = 0
                        ) -> "PagedKVWindow":
        """In-place remote update of a live page through a dup'd view that
        declares single-op usage (``same_op=op``, paper §2.3 hints × P4),
        addressed by the page's memory handle: small updates on
        atomic-capable dtypes take K2, large ones K3 read, K1 fold and K3
        write-back."""
        mhw = self._handle_window(page, order=True, same_op=op,
                                  accumulate_ops=(op,))
        mhw.accumulate(update.reshape(self.window.axis_size, -1), perm,
                       op=op, offset=offset, stream=stream)
        mhw.flush(stream)
        self.err_count += mhw.err_count
        return self

    def push_pages(self, pages, kvs, perm, stream: int = 0, *,
                   backend: str = "rma") -> "PagedKVWindow":
        """Batched push as a plan replay (:func:`transfer_plan`): every page
        back to back through its memory handle on one ordered stream, one
        guarded K3 launch each, and one thread-scope flush epoch for the
        batch.  ``pages`` are Python ints: the registration slots are part
        of the plan."""
        buf = self.window.buffer
        compiled = transfer_plan(
            self.spec.n_pages, tuple(pages), self.spec.page_elems, buf.dtype,
            tuple(tuple(p) for p in perm), stream,
            topology=self.window.config.topology, backend=backend)
        bindings = {"handles": self.handles}
        for i, kv in enumerate(kvs):
            bindings[f"kv{i}"] = kv.reshape(buf.shape[0], -1).to(buf.dtype)
        res = compiled.execute({"pool": self.window}, bindings)
        self.window = res.windows["pool"]
        self.err_count += res.err_count
        return self

    def transfer_pages(self, pages, kvs, perm, stream: int = 0
                       ) -> "PagedKVWindow":
        """Batched push, the legacy entry point: a thin wrapper over
        :meth:`push_pages` (same numerics, same phases) that warns once per
        process (``DeprecationWarning``)."""
        from repro_torch.core.rma.plan import warn_legacy_once

        warn_legacy_once("PagedKVWindow.transfer_pages",
                         "PagedKVWindow.push_pages (plan replay)")
        return self.push_pages(pages, kvs, perm, stream=stream)

    def get_page_remote(self, page: int, perm, stream: int = 0
                        ) -> tuple["PagedKVWindow", torch.Tensor]:
        """Read a page from a peer's pool through its memory handle: one
        guarded K3 launch (the response), then the stream's flush.  A stale
        handle's response is zeros, counted into ``err_count``."""
        s = self.spec
        mhw = self._handle_window(page, order=True)
        _, flat = mhw.get(perm, offset=0, size=s.page_elems, stream=stream)
        mhw.flush(stream)
        self.err_count += mhw.err_count
        return self, flat.reshape(-1, 2, s.page_tokens, s.kv_heads,
                                  s.head_dim)


# ---------------------------------------------------------------------------
# Host-side pool management: tier-generic refcounted core + the tiered manager
# ---------------------------------------------------------------------------

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
    host-memory :class:`HostKVTier` at the engine layer) — plus per-page
    residency state and demotion/promotion queues.  Page naming is
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


# ---------------------------------------------------------------------------
# The cold tier's window: host-memory pages behind the same P5 machinery
# ---------------------------------------------------------------------------

_TIER_PLANS: dict[tuple, object] = register_plan_cache("kv_tier_step", {})


def tier_step_plan(pool_pages: int, promote: tuple, demote: tuple,
                   page_elems: int, dtype, perm: tuple = ((0, 0),), *,
                   backend: str = "rma"):
    """Build (or fetch from the build-once cache) one decode tick's tier
    traffic as a compiled plan: the promote ``get_handle``\\ s first —
    **prefetch edges** on the window's dedicated last stream (3) — then the
    demote ``put_handle``\\ s on the migration stream (2), then the
    ``attention-gather`` compute that consumes the promoted payloads.  The
    planner places the promotes' completion epoch as a ``prefetch-wait``
    right before the gather, so the phase table shows the overlap::

        prefetch:promote[s]...   (dedicated stream, issued first)
        demote[t]...             (migration stream)
        prefetch-wait[host/3]    (the promotes complete only here)

    A stale handle (a cold page freed after its demotion) reads zeros and
    is counted (P5).  Output ``"promoted"`` stacks the fetched payloads
    ``(n, len(promote), page_elems)``; omitted when nothing promotes."""
    from repro_torch.core.rma.plan import RmaPlan

    if backend == "auto":
        backend = "rma"        # no macro to ever pick gspmd for
    dt = as_dtype(dtype)
    key = (pool_pages, tuple(promote), tuple(demote), page_elems,
           _dtype_name(dt), tuple(tuple(p) for p in perm), backend)
    if key in _TIER_PLANS:
        return _TIER_PLANS[key]
    plan = RmaPlan(f"kv-tier-step[p{len(promote)} d{len(demote)}]")
    plan.window("host", scope="thread", order=True, max_streams=4,
                dtype=dt, exit_epoch=True)
    plan.bind("handles", (pool_pages, 4), torch.int32)
    gets = []
    for s in promote:
        gets.append(plan.get_handle(
            "host", lambda env, p=s: env["handles"][:, p], tuple(perm),
            slot=s, size=page_elems, stream=3, label=f"promote[{s}]"))
    for i, s in enumerate(demote):
        plan.bind(f"cold{i}", (page_elems,), dt)
        plan.put_handle("host", f"cold{i}",
                        lambda env, p=s: env["handles"][:, p], tuple(perm),
                        slot=s, stream=2, shape=(page_elems,), dtype=dt,
                        label=f"demote[{s}]")
    if gets:
        gather = plan.compute(
            lambda env: torch.stack([env[g] for g in gets], dim=1),
            reads=tuple(gets), label="attention-gather")
        for g in gets:
            plan.prefetch(g, gather)
        plan.output("promoted", gather)
    compiled = plan.compile(backend=backend)
    _TIER_PLANS[key] = compiled
    return compiled


class HostKVTier:
    """The cold tier's storage: a host-memory page pool behind the same
    dynamic-window and memory-handle machinery as the device pools.

    Demoted pages are attached slots of a :class:`PagedKVWindow` whose pool
    lies in **pinned host memory** (``device="cuda"``, the default: its
    registration tables, epochs, handles, ``err_count`` and completion
    counters stay on the card, and K3 reaches the pool at its device-mapped
    address), or on the CPU with everything else (``device="cpu"``).  So the
    P5 lifetime story applies unchanged: :meth:`free` releases through
    ``memhandle_release``, and a later promote of that slot comes back
    **zeroed and counted**, never as reused bytes.

    The serving engine is one process, so a tier step replays the compiled
    :func:`tier_step_plan` on a window of one rank with the self-map
    ``((0, 0),)`` — where the JAX package runs it under ``vmap`` over one
    rank.  A "page" here is one sequence page's full payload across every
    pool the model keeps (``Executor.page_payload_elems``).  A pool of 2^31
    elements or more raises (the handle's offset word is int32)."""

    def __init__(self, n_pages: int, page_elems: int, dtype, *,
                 axis: str = "x", device="cuda"):
        if page_elems % 2:
            raise ValueError(f"page_elems must be even, got {page_elems}")
        dev = resolve_device(device)
        self.axis = axis
        self.perm = ((0, 0),)
        # PageSpec models elems as tokens*heads*dim*2; the host tier stores
        # opaque payload, so everything folds into the token factor
        self.spec = PageSpec(page_tokens=page_elems // 2, kv_heads=1,
                             head_dim=1, n_pages=n_pages)
        self.pool = PagedKVWindow.create(self.spec, axis, 1, dtype,
                                         device=dev, host=dev.type == "cuda")
        self.dtype = as_dtype(dtype)
        # the self-map on the device now, so a step copies nothing to it
        self.pool.window.substrate.prepare(self.perm)

    @property
    def err_count(self) -> torch.Tensor:
        """The stale-handle drops tier traffic observed, ``(1,)`` int32."""
        return self.pool.err_count

    def alloc(self, slots) -> None:
        """Attach host slots (fresh handles) for incoming demotions."""
        for s in slots:
            self.pool.alloc_page(int(s))

    def free(self, slots) -> None:
        """Release host slots through ``memhandle_release``: the epoch bump
        is the guarantee that a demoted-then-freed page is never read."""
        for s in slots:
            self.pool.free_page(int(s))

    def step(self, promote_slots, demote_slots, demote_payloads=None):
        """Run one planned tier step: promote reads (prefetch edges, one
        guarded K3 read each) and demote writes (one guarded K3 put each),
        one replay with no host read.  ``demote_payloads`` is
        ``(len(demote_slots), page_elems)``; returns the promoted payloads
        ``(len(promote_slots), page_elems)`` on the pool's control device,
        or ``None``."""
        promote_slots = tuple(int(s) for s in promote_slots)
        demote_slots = tuple(int(s) for s in demote_slots)
        if not promote_slots and not demote_slots:
            return None
        compiled = tier_step_plan(self.spec.n_pages, promote_slots,
                                  demote_slots, self.spec.page_elems,
                                  self.dtype, self.perm)
        win = self.pool.window
        bindings = {"handles": self.pool.handles}
        for i in range(len(demote_slots)):
            bindings[f"cold{i}"] = demote_payloads[i].reshape(1, -1).to(
                device=win.device, dtype=self.dtype)
        res = compiled.execute({"host": win}, bindings)
        self.pool.window = res.windows["host"]
        self.pool.err_count += res.err_count
        return res.outputs["promoted"][0] if promote_slots else None


__all__ = [
    "PageSpec", "PagedKVWindow", "PageTier", "KVPoolManager", "HostKVTier",
    "transfer_plan", "tier_step_plan", "MAX_POOL_ELEMS",
    "RESIDENT_HOT", "RESIDENT_COLD", "RESIDENT_IN_FLIGHT",
]
