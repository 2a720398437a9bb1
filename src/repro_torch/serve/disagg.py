"""Disaggregated prefill→decode serving on the RMA substrate — ported from the
JAX package's ``serve/disagg.py``.

The serving data plane composed of the paper's proposals:

* **P5 (memory handles)** — the decode side exposes its KV pool as a
  :class:`~repro_torch.serve.paged.PagedKVWindow`; page handles are
  exchanged once at allocation and every prefill push is a guarded K3 put
  through the handle.  A push or read racing a ``free_page`` is dropped or
  zeroed and *counted*, never lands in reused memory.
* **P2 (ordered sequences)** — a sequence's pages go back to back on one
  ordered lane and its **doorbell** (``put_signal``, one K4 launch) chains
  behind the batch's flush epoch: one data phase per page, one epoch per
  batch, no per-page ack.
* **P3 (op intrinsics)** — decode **admission** is a remote fetch-and-op on
  a ticket counter of a small control window (``same_op="sum"``, so the
  doorbell flag takes the 1-phase intrinsic route).
* **P1 × P4** — every decode lane is an issue stream of the shared
  substrate with thread-scope flushes, so lanes never share an epoch.

Layout of the control window (int32 words, one row per rank)::

    [ticket | meta(seq 0), bell(seq 0) | meta(seq 1), bell(seq 1) | ...]

``ticket`` is the fetch_op admission counter; per sequence, ``meta`` carries
the pushed page count and ``bell`` is the doorbell flag the consumer polls.

Ranks are the rows of stacked tensors (the reference runs these functions
inside ``shard_map``).  On the card no function from the first push to the
last claim reads the card from the host: ticket values stay device tensors,
and only their count reaches the scheduler.  The host-side pieces —
:class:`PageAllocator`, :func:`paginate_cache` and :func:`park_slot` — wire
the same page-table discipline into the single-process
:class:`~repro_torch.serve.engine.ServeEngine` (``paged_kv=True``).

The round trip over 8 stacked ranks, on the card (``--cpu``: the CPU)::

    PYTHONPATH=src python -m repro_torch.serve.disagg [--cpu]
"""
from __future__ import annotations

import sys

import torch

from repro_torch.core.rma import (SCOPE_THREAD, Window, WindowConfig,
                                  put_signal, win_from_memhandle)
from repro_torch.device import resolve_device
from repro_torch.serve.paged import PagedKVWindow, PageSpec
from repro_torch.serve.scheduler import Scheduler

#: Control-window word 0: the fetch_op admission ticket counter.
CTRL_TICKET = 0


def ctrl_meta_offset(seq: int) -> int:
    """Word carrying sequence ``seq``'s pushed page count."""
    return 1 + 2 * seq


def ctrl_flag_offset(seq: int) -> int:
    """Sequence ``seq``'s doorbell flag word."""
    return 2 + 2 * seq


def ctrl_size(n_seqs: int) -> int:
    return 1 + 2 * n_seqs


def make_control_window(n_seqs: int, axis: str, axis_size: int, *,
                        n_lanes: int = 2, device="cuda") -> Window:
    """The decode-side control window: ticket counter and per-sequence
    (meta, doorbell) word pairs, zeroed, on ``device`` (the card unless the
    caller asks for the CPU).

    Declared ``same_op="sum"`` (the doorbell flag takes the intrinsic
    route), ``order=True`` (a doorbell chains behind its data with no
    intermediate flush) and thread scope with one issue stream per decode
    lane (P1 × P4)."""
    buf = torch.zeros((axis_size, ctrl_size(n_seqs)), dtype=torch.int32,
                      device=resolve_device(device))
    cfg = WindowConfig(scope=SCOPE_THREAD, order=True, max_streams=n_lanes,
                       same_op="sum", accumulate_ops=("sum",))
    return Window.allocate(buf, axis, axis_size, cfg)


# ---------------------------------------------------------------------------
# The data plane: push / doorbell / admission
# ---------------------------------------------------------------------------


def push_sequence(pool: PagedKVWindow, ctrl: Window, seq: int,
                  pages, kvs, perm, *, lane: int = 0,
                  ) -> tuple[PagedKVWindow, Window]:
    """Prefill side: push one sequence's filled pages into the decode pool
    and ring its doorbell.

    The pages ride one :meth:`PagedKVWindow.push_pages` (a plan replay: one
    guarded K3 launch a page on ``lane``, one thread-scope flush epoch for
    the batch); the doorbell is a ``put_signal`` on the control window (one
    K4 launch: the page count into the sequence's meta word, then its flag).
    The control window is another substrate than the pool, so the doorbell
    is ordered ``after=`` the pool lane's post-flush completion token: a
    consumer that sees ``bell != 0`` may read the pages with no flush of its
    own.  Everything is issued on ``lane``'s stream, so sequences on other
    lanes share no flush epoch with it."""
    pool = pool.push_pages(pages, kvs, perm, stream=lane)
    n = ctrl.axis_size
    count = torch.full((n, 1), len(pages), dtype=torch.int32,
                       device=ctrl.buffer.device)
    ctrl = put_signal(ctrl, count, perm, data_offset=ctrl_meta_offset(seq),
                      flag_offset=ctrl_flag_offset(seq), stream=lane,
                      after=pool.window.completion_token(lane))
    return pool, ctrl


def _fetch_ticket(ctrl: Window, perm, lane: int):
    """One remote fetch-and-op of 1 on the target's ticket counter: each
    origin's old value, ``(n,)`` on the window's device (0 where a rank
    claims nothing)."""
    one = torch.ones((ctrl.axis_size, 1), dtype=torch.int32,
                     device=ctrl.buffer.device)
    ctrl, old = ctrl.fetch_op(one, perm, op="sum", offset=CTRL_TICKET,
                              stream=lane)
    return ctrl, old[:, 0]


def claim_slot(ctrl: Window, perm, *, n_slots: int, lane: int = 0,
               ) -> tuple[Window, torch.Tensor, torch.Tensor]:
    """Decode admission: atomically claim the next ticket on the target's
    control window (``MPI_Fetch_and_op`` on the counter word) and map it to
    a decode slot.  Returns ``(ctrl, ticket, slot)``, per-rank tensors."""
    ctrl, ticket = _fetch_ticket(ctrl, perm, lane)
    return ctrl, ticket, torch.remainder(ticket, n_slots)


def claim_slots(ctrl: Window, perm, scheduler, *, live: int = 0,
                lane: int = 0, max_claims: int | None = None,
                source: str | None = None) -> tuple[Window, list, list]:
    """Policy-driven decode admission: claim up to the scheduler's ticket
    budget for this tick (:meth:`~repro_torch.serve.scheduler.Scheduler.
    ticket_window` — 0 under ``static`` while sequences are live, the
    free-slot count otherwise) by remote fetch_op, mapping each ticket
    through :meth:`~repro_torch.serve.scheduler.Scheduler.slot_for_ticket`.

    ``source`` names the claiming worker: its claim count is registered
    (:meth:`~repro_torch.serve.scheduler.Scheduler.note_claims`) so the
    tickets count against later windows until the worker binds them to
    live sequences — or is evicted, when ``release_claims`` returns them.
    The ticket *values* stay on the window's device (no host read); only
    their count reaches the scheduler.

    Returns ``(ctrl, tickets, slots)`` — lists of per-rank tensors, empty
    when the policy grants no admission."""
    budget = scheduler.ticket_window(live)
    if max_claims is not None:
        budget = min(budget, max_claims)
    tickets, slots = [], []
    for _ in range(budget):
        ctrl, ticket = _fetch_ticket(ctrl, perm, lane)
        tickets.append(ticket)
        slots.append(scheduler.slot_for_ticket(ticket))
    if source is not None:
        scheduler.note_claims(len(tickets), source=source)
    return ctrl, tickets, slots


def read_doorbell(ctrl: Window, seq: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Consumer-side poll: ``(flag, page_count)`` of sequence ``seq`` for
    every rank — local reads of the control window (copies, on its
    device), no communication."""
    buf = ctrl.buffer
    return (buf[:, ctrl_flag_offset(seq)].clone(),
            buf[:, ctrl_meta_offset(seq)].clone())


def pool_stats(pool: PagedKVWindow, ctrl: Window | None = None
               ) -> dict[str, torch.Tensor]:
    """The pool's health: ``live_pages``, the live page count (int32, from
    the host-side mirror every rank shares), ``err_count``, the P5
    stale-handle drops per rank (non-zero: a peer pushed or read through a
    freed page), and ``stalls``, the pool's flushes that gave up waiting
    (non-zero: a completion token taken after them does not imply that the
    pages landed).  With ``ctrl``, ``ctrl_stalls`` too: the control
    window's flushes that gave up and the doorbells it withheld because
    the pool's flush had.  All stay on the device."""
    stats = {
        "live_pages": pool.live.sum().to(torch.int32),
        "err_count": pool.err_count,
        "stalls": pool.window.substrate.stalls[0],
    }
    if ctrl is not None:
        stats["ctrl_stalls"] = ctrl.substrate.stalls[0]
    return stats


# ---------------------------------------------------------------------------
# Host side: the page allocator + paged-cache plumbing for ServeEngine
# ---------------------------------------------------------------------------


class PageAllocator:
    """Host-side FIFO free-list over the decode pool's physical pages.

    FIFO (not LIFO) so freed pages are reused as late as possible — the
    most pressure on the stale-handle guarantee in tests and the most grace
    for in-flight transfers in a deployment."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages))
        self.allocs = 0
        self.frees = 0

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: need {n} pages, "
                f"{len(self._free)}/{self.n_pages} free")
        pages, self._free = self._free[:n], self._free[n:]
        self.allocs += n
        return pages

    def free(self, pages) -> None:
        self._free.extend(pages)
        self.frees += len(pages)

    @property
    def n_free(self) -> int:
        return len(self._free)


def _is_gqa_cache(d) -> bool:
    return isinstance(d, dict) and set(d) == {"k", "v", "pos"}


def paginate_cache(cache, page_tokens: int):
    """Convert every dense GQA KV leaf ``{k, v, pos}`` of a stack cache into
    the pooled page layout ``{k_pages, v_pages, page_table, page_ro,
    page_hot, pos}``.

    Dense ``k``/``v`` leaves of shape ``(…, B, S, KV, hd)`` become physical
    pools of ``B·S/pt`` allocatable pages **plus one parking page**; every
    page-table entry starts at the parking page, and the engine's pool
    (which hands out ids ``0 … B·S/pt − 1``) wires rows to real pages at
    slot admission.  Idle and released decode rows still scatter their
    discarded per-step KV through the table; parking those writes on a page
    no allocation can own keeps them off a live slot's pages.  Leaves that
    are not self-attention KV (the step counter) pass through unchanged.

    ``page_ro`` is the per-page write protection of copy-on-write prefix
    sharing (the decode scatter drops writes at a protected page like
    overflow writes); ``page_hot`` the per-page residency bit of the tiered
    pool (the gather reads the parking page instead of a non-hot page, and
    the scatter drops writes at one).  The parking page is never protected
    and always hot."""
    if _is_gqa_cache(cache):
        k = cache["k"]
        *lead, b, s, kv, hd = k.shape
        if s % page_tokens:
            raise ValueError(f"max_seq={s} not divisible by "
                             f"page_tokens={page_tokens}")
        pages_per_row = s // page_tokens
        n_alloc = b * pages_per_row        # the pool's page ids
        dev = k.device

        def repage(x):
            pool = x.reshape(*lead, n_alloc, page_tokens, kv, hd)
            park = x.new_zeros((*lead, 1, page_tokens, kv, hd))
            return torch.cat([pool, park], dim=len(lead))

        return {
            "k_pages": repage(k),
            "v_pages": repage(cache["v"]),
            "page_table": torch.full((*lead, b, pages_per_row), n_alloc,
                                     dtype=torch.int32, device=dev),
            "page_ro": torch.zeros((*lead, n_alloc + 1), dtype=torch.bool,
                                   device=dev),
            "page_hot": torch.ones((*lead, n_alloc + 1), dtype=torch.bool,
                                   device=dev),
            "pos": cache["pos"],
        }
    if isinstance(cache, dict):
        return {key: paginate_cache(val, page_tokens)
                for key, val in cache.items()}
    if isinstance(cache, list):
        return [paginate_cache(val, page_tokens) for val in cache]
    return cache


def park_slot(cache, slot: int):
    """Point a released slot's page-table rows at the parking page and
    rewind its position counter, in place (returns ``cache``): the slot's
    idle decode writes then land on the parking page, never on its old
    pages, which the pool may hand to a later admission."""
    if isinstance(cache, dict):
        if "k_pages" in cache:
            park = cache["k_pages"].shape[-4] - 1   # the extra page
            cache["page_table"][..., slot, :] = park
            cache["pos"][..., slot] = 0
            return cache
        for val in cache.values():
            park_slot(val, slot)
    elif isinstance(cache, list):
        for val in cache:
            park_slot(val, slot)
    return cache


# ---------------------------------------------------------------------------
# The round trip over stacked ranks: prefill→push→doorbell→admit→decode
# ---------------------------------------------------------------------------

N_DEMO_DEV = 8


def demo_round_trip(n_seqs: int = 2, pages_per_seq: int = 2,
                    n_lanes: int = 2, verbose: bool = True,
                    policy: str = "continuous", *, device="cuda") -> dict:
    """Drive one disaggregated round trip around a ring of
    :data:`N_DEMO_DEV` stacked ranks on ``device`` (the card unless the
    caller asks for the CPU).

    Every rank plays both roles: as a *prefill* worker it fills ``n_seqs``
    sequences' pages and pushes them into its ring successor's pool through
    memory handles, ringing one doorbell per sequence; as a *decode* worker
    it receives its predecessor's pushes, claims admission tickets by remote
    fetch_op, reads the doorbells and meta words and the pushed pages — and
    reads once through a freed page's old handle, which must come back
    zeroed and counted.  Returns the reference's seven checks and an eighth,
    ``no_stalls``: no flush of the pool or the control window gave up, so
    no doorbell was withheld; raises ``SystemExit`` if one fails."""
    dev = resolve_device(device)
    n = N_DEMO_DEV
    perm = [(i, (i + 1) % n) for i in range(n)]
    spec = PageSpec(page_tokens=4, kv_heads=2, head_dim=8,
                    n_pages=n_seqs * pages_per_seq + 1)
    pool = PagedKVWindow.create(spec, "x", n, torch.float32, device=dev)
    ctrl = make_control_window(n_seqs, "x", n, n_lanes=n_lanes, device=dev)
    # decode side: allocate and register the pages each sequence lands in
    # (the once-per-allocation handle exchange of P5)
    for p in range(n_seqs * pages_per_seq):
        pool.alloc_page(p)
    # prefill side: fill pages, push each sequence on its lane
    page = (n, 2, spec.page_tokens, spec.kv_heads, spec.head_dim)
    for s in range(n_seqs):
        pages = [s * pages_per_seq + j for j in range(pages_per_seq)]
        kvs = [torch.full(page, 1.0 + s + 0.25 * j, dtype=torch.float32,
                          device=dev) for j in range(pages_per_seq)]
        pool, ctrl = push_sequence(pool, ctrl, s, pages, kvs, perm,
                                   lane=s % n_lanes)
    for lane in range(min(n_lanes, n_seqs)):
        ctrl.flush(stream=lane)              # thread scope: per lane
    # decode admission: the policy grants each lane's ticket budget
    sched = Scheduler(n_seqs, policy)
    tickets = []
    for lane in range(n_lanes):
        ctrl, ts, _slots = claim_slots(ctrl, perm, sched, live=0, lane=lane,
                                       max_claims=1)
        ctrl.flush(stream=lane)
        tickets.extend(ts)
    # decode: doorbells and the pages pushed by the ring predecessor
    bells = [read_doorbell(ctrl, s) for s in range(n_seqs)]
    vals = [pool.read_page(s * pages_per_seq)[:, 0, 0, 0, 0].clone()
            for s in range(n_seqs)]
    # eviction: free sequence 0's first page; a read through its old handle
    # must come back zeroed and counted, never reused memory
    stale_handle = pool.handles[:, 0].clone()
    pool.free_page(0)
    mhw = win_from_memhandle(pool.window, stale_handle)
    mhw, stale = mhw.get(perm, offset=0, size=4)
    stats = pool_stats(pool, ctrl)
    k = n_seqs
    vals = torch.stack(vals, 1).cpu()
    flags = torch.stack([b[0] for b in bells], 1).cpu()
    metas = torch.stack([b[1] for b in bells], 1).cpu()
    tickets = torch.stack(tickets, 1).cpu()
    errs = (stats["err_count"] + mhw.err_count).cpu()
    want = torch.tensor([1.0 + s for s in range(k)])
    checks = {
        "pages_landed": bool((vals == want).all()),
        "doorbells": bool((flags == 1).all()),
        "meta_page_counts": bool((metas == pages_per_seq).all()),
        "tickets": bool((tickets == torch.arange(n_lanes)).all()),
        "stale_read_masked": bool((stale[:, :4].cpu() == 0).all()),
        "stale_read_counted": bool((errs == 1).all()),
        "live_pages": int(stats["live_pages"]) == k * pages_per_seq - 1,
        "no_stalls": int(stats["stalls"]) == int(stats["ctrl_stalls"]) == 0,
    }
    if verbose:
        print(f"[disagg] {k} seqs x {pages_per_seq} pages pushed over a "
              f"{n}-rank ring on {n_lanes} lanes ({policy} admission, "
              f"device {dev})")
        for name, ok in checks.items():
            print(f"[disagg]   {name}: {'OK' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise SystemExit(f"disagg round-trip failed: {checks}")
    return checks


__all__ = [
    "CTRL_TICKET",
    "ctrl_meta_offset",
    "ctrl_flag_offset",
    "ctrl_size",
    "make_control_window",
    "push_sequence",
    "claim_slot",
    "claim_slots",
    "read_doorbell",
    "pool_stats",
    "PageAllocator",
    "paginate_cache",
    "park_slot",
    "demo_round_trip",
]


if __name__ == "__main__":
    demo_round_trip(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
    print("DISAGG ROUND-TRIP OK")
