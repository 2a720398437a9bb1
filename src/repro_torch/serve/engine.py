"""The serving engine: scheduler / KV pool / executor, continuous batching.

Three layers, as in the JAX package's ``serve/engine.py``:

* :class:`repro_torch.serve.scheduler.Scheduler` — the **policy** layer:
  request queue (arrival ticks, priorities, tenants) and per-tick
  admission (continuous batching: any free slot is refilled every decode
  tick).
* :class:`repro_torch.serve.paged.KVPoolManager` — the **pool** layer:
  refcounts on physical KV pages, copy-on-write prefix sharing, FIFO free
  list, double-free guards.
* :class:`Executor` (here) — the **execution** layer: owns the batched
  device cache and runs prefill and decode, writing the cache in place;
  one host read per call (the greedy tokens).  On a CUDA card a decode
  tick is one replay of a captured CUDA graph.

:class:`ServeEngine` wires the three together (``submit`` / ``step`` /
``run`` / ``stats``, ``slot_free`` / ``slot_req`` / ``done``).

``paged_kv=True`` replaces the dense per-slot KV with the paged pool layout
(``repro_torch.serve.disagg.paginate_cache``): a physical page pool plus a
per-row page table for every attention layer (a hybrid stack's Mamba2
layers keep their dense conv tail and state); a stack with no
self-attention KV (pure SSM, or MLA, whose compressed cache stays dense)
refuses it.  An enc-dec stack is refused outright (``ENCDEC_REFUSAL``);
a VLM is served as a text LM, prompt tokens only, as in the JAX package.
``prefix_share=True`` additionally admits new requests onto the pages
of a live request with a common prompt prefix: full pages
inside the common prefix are mapped read-only (refcount + 1, write-protected
through the cache's ``page_ro`` leaf); the partial page at the prefix
boundary is mapped copy-on-write when the new prompt ends exactly at the
prefix, and forked (device page copy + table remap) the tick a holder's
write position reaches it while it is still shared.  Sharing is bit-safe
because the KV at position *i* depends only on tokens ``0..i`` and decode
writes before it attends.

Prefill runs each admitted prompt alone into a one-row sub-cache (through
kernel K7, and K8 and the SSD pass for Mamba2 blocks) and inserts it into
the slot; in paged
mode the prompt's KV is re-paged into the slot's physical pages, and pages
it shares land on the parking page.

``kv_pages=(hbm_pages, host_pages)`` turns the pool into a tiered memory
hierarchy: admission is priced against HBM + host capacity (so more
sequences are live than HBM alone could back) while the per-tick decode set
is priced against HBM only.  Live slots rotate through the tiers: inactive
slots' pages are demoted to a :class:`~repro_torch.serve.paged.HostKVTier`
(pinned host memory on the card's side) by planned handle puts, and
promotions are scheduled a tick ahead so their planned handle reads ride
prefetch edges beside the demote traffic
(:func:`~repro_torch.serve.paged.tier_step_plan`); kernel K3 moves every
page.  Only active slots commit tokens each tick; greedy decode is
row-independent and a promotion restores the slot's pages, table row and
position exactly, so the committed tokens equal the all-HBM engine's.

The engine owns the parameter tree it is handed.  At construction every
leaf the model only ever reads cast whole to its compute dtype
(``Model.compute_dtype_leaves``), where that dtype is narrower than the
leaf's, is converted once inside the leaf's own bytes
(:func:`own_weights`): every holder of the tree then sees it in the
compute dtype, holding the values the model computed with, so the
per-call casts launch nothing and memory does not grow.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve import disagg
from repro_torch.serve.paged import HostKVTier, KVPoolManager
from repro_torch.serve.scheduler import Scheduler
from repro_torch.tree import leaves_with_paths


#: why an enc-dec stack is not served: the engine's prefill feeds prompt
#: tokens only, and the JAX package's engine, which does the same, fails in
#: ``model.prefill`` for want of ``frames``
ENCDEC_REFUSAL = (
    "{name!r} is an encoder-decoder stack: the serving engine feeds prompt "
    "tokens only and has no encoder frames to give its prefill (the JAX "
    "package's engine cannot serve it either); call Model.prefill with "
    "batch['frames'] and Model.decode_step directly")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int
    max_new_tokens: int
    eos_id: int = -1            # -1: never stops early
    priority: int = 0           # policy="priority": higher admits first
    tenant: int = 0             # policy="fair": fair-share key


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list
    finished: bool = True       # False: run() ran out of ticks (partial)
    arrival_tick: int = 0
    done_tick: int = 0


#: elements one chunk of a conversion casts through its temporary; at least
#: CONVERT_ALIGN / 2, so a chunk's writes, which start at most
#: CONVERT_ALIGN - 1 bytes into the leaf, never reach bytes not yet read
CONVERT_CHUNK = 1 << 24
#: the byte boundary a converted leaf starts on where its bytes leave room
#: (a float32 leaf of n elements has 2n bytes to spare): cuBLAS then finds
#: the alignment of the freshly allocated cast it replaces
CONVERT_ALIGN = 256


def _byte_range(t: torch.Tensor) -> tuple:
    """(device, first byte, one past the last byte) that ``t`` spans."""
    n = 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    start = t.data_ptr()
    return (str(t.device), start,
            start + (n * t.element_size() if t.numel() else 0))


def _convert(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t``'s values in ``dtype``, written over the front of ``t``'s own
    bytes (a contiguous leaf of a wider dtype) chunk by chunk: each chunk
    is read whole into a temporary before it is written, and the writes
    trail the reads.  Returns the contiguous view that holds them."""
    n = t.numel()
    start = t.data_ptr()
    room = n * (t.element_size() - dtype.itemsize)
    align = CONVERT_ALIGN
    while -start % align > room:
        align //= 2
    storage = t.untyped_storage()
    offset = (start + -start % align - storage.data_ptr()) // dtype.itemsize
    out = t.new_empty(0, dtype=dtype).set_(storage, offset, t.shape)
    src, dst = t.view(-1), out.view(-1)
    for i in range(0, n, CONVERT_CHUNK):
        dst[i:i + CONVERT_CHUNK] = src[i:i + CONVERT_CHUNK].to(dtype)
    return out


def own_weights(model, params) -> dict:
    """Convert, in place, every leaf of ``params`` that the model reads only
    cast whole to its compute dtype, where that dtype is narrower than the
    leaf's: each is rewritten in the front of its own bytes
    (:func:`_convert`) and re-pointed there (``.data``), so every holder of
    the tree or of the leaf sees a contiguous tensor of the compute dtype
    holding the values each call computed with.  Leaves that alias the
    same bytes are converted once; a leaf whose bytes another leaf only
    partly covers, or that is not contiguous, is left as it is.  Returns
    the counts ``ServeEngine.stats()`` reports: leaves converted, the bytes
    they held before, leaves kept in their own dtype."""
    dtype = model.cfg.activation_dtype
    named = set(model.compute_dtype_leaves())
    groups: dict[tuple, list] = {}
    for path, t in leaves_with_paths(params):
        groups.setdefault(_byte_range(t), []).append((path, t))
    spans = sorted(r for r in groups if r[1] < r[2])
    clash = set()
    for i, (dev, lo, hi) in enumerate(spans):
        for other in spans[i + 1:]:
            if other[0] != dev or other[1] >= hi:
                break
            clash |= {spans[i], other}
    out = {"weights_converted": 0, "weights_converted_bytes": 0,
           "weights_kept": 0}
    for span, group in groups.items():
        t = group[0][1]
        if (span not in clash and t.numel() and t.is_contiguous()
                and t.is_floating_point()
                and t.element_size() > dtype.itemsize
                and all(p in named and u.dtype == t.dtype
                        and u.shape == t.shape for p, u in group)):
            new = _convert(t, dtype)
            for _, u in group:
                u.data = new
            out["weights_converted"] += len(group)
            out["weights_converted_bytes"] += span[2] - span[1]
        else:
            out["weights_kept"] += len(group)
    return out


def _paged_dicts(tree):
    """Every paged-attention dict of a cache tree."""
    if isinstance(tree, dict):
        if "k_pages" in tree:
            yield tree
            return
        for v in tree.values():
            yield from _paged_dicts(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _paged_dicts(v)


def _insert_row(full: torch.Tensor, one: torch.Tensor, slot: int,
                n_slots: int) -> None:
    """Copy a 1-row leaf into row ``slot`` of the n_slots-row leaf, in place.

    The batch axis is wherever ``one`` is 1 and ``full`` is n_slots with all
    other dims equal (scan-stacked leaves carry a leading layer axis)."""
    if full.dim() != one.dim():
        return
    for ax in range(full.dim()):
        rest_f = full.shape[:ax] + full.shape[ax + 1:]
        rest_o = one.shape[:ax] + one.shape[ax + 1:]
        if one.shape[ax] == 1 and full.shape[ax] == n_slots \
                and rest_f == rest_o:
            full.narrow(ax, slot, 1).copy_(one)
            return


class Executor:
    """The execution layer: the batched cache, prefill and decode.

    Decisions live elsewhere — the scheduler picks *what* runs, the pool
    manager *which pages* back it; the executor is handed a slot, a
    physical-page row and a per-page write mask, and runs the model on the
    device its parameters live on.

    The executor owns the tree it is handed: after construction the
    caller's tree holds each leaf the model reads only in its compute
    dtype in that dtype (:func:`own_weights`; ``weight_stats`` keeps the
    counts), and the caller reads no float32 values from those leaves
    again.

    Everything is written in place: no leaf of ``self.cache`` or of
    ``self.params`` is ever rebound or reallocated after construction.
    Prefill's insertion, the page operations, the tier's payload writes
    and ``park`` write into the leaves the decode tick reads.  On a CUDA
    card the tick relies on it: the first :meth:`decode` runs eagerly on
    the stream the capture uses, the second captures one step (the
    model's ``decode_step`` and the greedy argmax, between a static token
    buffer and a static output) in a CUDA graph and replays it, and every
    later one replays it; the graph reads and writes the leaves at the
    addresses they had when it was captured.  On the CPU every tick runs
    the same step eagerly.  ``decode_counts`` counts captures, replays
    and eager ticks."""

    def __init__(self, model, params, *, n_slots: int, max_seq: int,
                 paged_kv: bool = False, page_tokens: int = 16):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        if model.cfg.enc_layers:
            raise ValueError(ENCDEC_REFUSAL.format(name=model.cfg.name))
        self.device = params["embed"]["table"].device
        self.cache = model.init_cache(n_slots, max_seq, device=self.device)
        self.paged_kv = paged_kv
        if paged_kv:
            paged_cache = disagg.paginate_cache(self.cache, page_tokens)
            if next(_paged_dicts(paged_cache), None) is None:
                raise ValueError(
                    f"paged_kv=True but the {model.cfg.family!r} stack has "
                    "no self-attention KV caches to page (MLA/SSM caches "
                    "stay dense) — the paged data plane would be a no-op")
            self.cache = paged_cache
        self.weight_stats = own_weights(model, params)
        self.decode_counts = {"decode_graph_captures": 0,
                              "decode_graph_replays": 0, "decode_eager": 0}
        self._graph = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._staged = torch.zeros((n_slots, 1), dtype=torch.int64,
                                       pin_memory=True)
            self._tokens = torch.zeros((n_slots, 1), dtype=torch.int64,
                                       device=self.device)
            self._next = torch.zeros((n_slots,), dtype=torch.int32,
                                     device=self.device)

    # -- the two model calls ----------------------------------------------------
    def prefill(self, tokens: torch.Tensor, slot: int, phys_pages: list,
                write_ok: np.ndarray) -> int:
        """Prefill one admitted request (tokens (1, S)) into ``slot``;
        returns its first greedy token."""
        sub = self.model.init_cache(1, self.max_seq, device=self.device)
        logits, sub = self.model.prefill(self.params, {"tokens": tokens}, sub)
        self._insert(self.cache, sub, slot, phys_pages, write_ok)
        return int(torch.argmax(logits[0, -1]))

    def decode(self, last_tokens: np.ndarray) -> np.ndarray:
        """One decode step over every slot (``last_tokens`` (n_slots, 1));
        returns per-slot argmax (one host read).  On a CUDA card a replay
        of the captured step (see the class)."""
        if self.device.type != "cuda":
            return self._decode_eager(last_tokens)
        with obs.span("decode.h2d"):
            # the last tick's read waited for the copy out of the staging
            # buffer, so it is free to refill
            self._staged.numpy()[:] = np.reshape(last_tokens,
                                                 (self.n_slots, 1))
            self._tokens.copy_(self._staged, non_blocking=True)
        if self._graph is None:
            self._decode_warm_or_capture()
        else:
            with obs.span("decode.model"):
                self._graph.replay()
            self.decode_counts["decode_graph_replays"] += 1
        with obs.span("decode.read"):
            return self._next.cpu().numpy()

    def _step(self, tokens: torch.Tensor) -> torch.Tensor:
        """The decode step: the model's step over the cache, in place, and
        each row's greedy token (int32)."""
        logits, _ = self.model.decode_step(self.params, self.cache, tokens)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    def _decode_eager(self, last_tokens: np.ndarray) -> np.ndarray:
        """The step run eagerly: every tick on the CPU, and the reference
        the card's replayed tick is held to."""
        with obs.span("decode.h2d"):
            tokens = torch.as_tensor(last_tokens, dtype=torch.int64,
                                     device=self.device)
        with obs.span("decode.model"):
            nxt = self._step(tokens)
        self.decode_counts["decode_eager"] += 1
        with obs.span("decode.read"):
            return nxt.cpu().numpy()

    def _decode_warm_or_capture(self) -> None:
        """The card's first tick runs the step eagerly on the capture's
        stream (cuBLAS and the allocator warm there); the second captures
        it and replays the graph once, which runs this tick: a capture
        records without running, and a tick that is not real would
        advance the cache."""
        side, main = self._stream, torch.cuda.current_stream(self.device)
        if not self.decode_counts["decode_eager"]:
            side.wait_stream(main)
            with obs.span("decode.model"), torch.cuda.stream(side):
                self._next.copy_(self._step(self._tokens))
            main.wait_stream(side)
            self.decode_counts["decode_eager"] += 1
            return
        graph = torch.cuda.CUDAGraph()
        with obs.span("decode.capture"), torch.cuda.graph(graph,
                                                          stream=side):
            self._next.copy_(self._step(self._tokens))
        self._graph = graph
        self.decode_counts["decode_graph_captures"] += 1
        with obs.span("decode.model"):
            graph.replay()
        self.decode_counts["decode_graph_replays"] += 1

    # -- paged-pool device ops ---------------------------------------------------
    def fork_page(self, slot: int, j: int, src: int, dst: int) -> None:
        """Copy-on-write fork: copy physical page ``src`` → ``dst`` in every
        paged pool and point this slot's table entry ``j`` at the copy."""
        for d in _paged_dicts(self.cache):
            for key in ("k_pages", "v_pages"):
                pool = d[key]
                if pool.dim() == 4:
                    pool[dst] = pool[src]
                else:                               # leading layer axis
                    pool[:, dst] = pool[:, src]
            d["page_table"][..., slot, j] = dst
            d["page_ro"][..., dst] = False
            d["page_hot"][..., dst] = True

    def set_pages_ro(self, pages, value: bool) -> None:
        """(Un)write-protect physical pages device-side: decode scatters at
        a read-only page are dropped like overflow writes (defence in depth
        — the pool manager forks before any legitimate write reaches
        one)."""
        idx = torch.as_tensor(list(pages), dtype=torch.int64,
                              device=self.device)
        for d in _paged_dicts(self.cache):
            d["page_ro"][..., idx] = value

    def set_pages_hot(self, pages, value: bool) -> None:
        """Flip physical pages' device-side residency bit.  The tiered
        engine clears it when a page's bytes leave for the host tier and
        sets it when fresh pages are wired (admission, promotion, COW
        fork); the paged attention reroutes any gather or scatter still
        aimed at a non-hot page to the parking page."""
        idx = torch.as_tensor(list(pages), dtype=torch.int64,
                              device=self.device)
        for d in _paged_dicts(self.cache):
            d["page_hot"][..., idx] = value

    # -- tiered payload migration -------------------------------------------
    @property
    def page_payload_dtype(self) -> torch.dtype:
        """Dtype of the concatenated per-page payload (the pools' dtype)."""
        for d in _paged_dicts(self.cache):
            return d["k_pages"].dtype
        raise ValueError("no paged pools in this cache")

    @property
    def page_payload_elems(self) -> int:
        """Elements in one page's full payload: every paged pool's K and V
        for that page concatenated (a scan-stacked pool contributes all its
        layers), so one host-tier slot round-trips one logical KV page."""
        n = 0
        for d in _paged_dicts(self.cache):
            for key in ("k_pages", "v_pages"):
                leaf = d[key]
                n += leaf[..., 0, :, :, :].numel()
        if not n:
            raise ValueError("no paged pools in this cache")
        return n

    def gather_page_payloads(self, pages) -> torch.Tensor:
        """Read physical pages' full payloads ``(len(pages),
        page_payload_elems)`` in the fixed pool walk order
        :meth:`scatter_page_payloads` writes them back in — the demotion
        snapshot (shared pages are never written: the pool forks first)."""
        pages = list(pages)
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        dt = self.page_payload_dtype
        parts = []
        for d in _paged_dicts(self.cache):
            for key in ("k_pages", "v_pages"):
                leaf = d[key]
                part = (leaf[idx] if leaf.dim() == 4
                        else leaf[:, idx].movedim(0, 1))
                parts.append(part.reshape(len(pages), -1).to(dt))
        return torch.cat(parts, dim=1)

    def scatter_page_payloads(self, pages, payloads: torch.Tensor) -> None:
        """Write payloads back into physical pages in place — the exact
        inverse of :meth:`gather_page_payloads` (same walk order, each
        leaf's dtype restored), so a demote → promote round trip is
        bit-identical."""
        pages = list(pages)
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
        payloads = payloads.reshape(len(pages), -1)
        cur = 0
        for d in _paged_dicts(self.cache):
            for key in ("k_pages", "v_pages"):
                leaf = d[key]
                if leaf.dim() == 4:
                    shape = (len(pages),) + tuple(leaf.shape[1:])
                    take = shape[1] * shape[2] * shape[3]
                    leaf[idx] = payloads[:, cur:cur + take].reshape(
                        shape).to(leaf.dtype)
                else:                               # leading layer axis
                    shape = (len(pages), leaf.shape[0]) + tuple(
                        leaf.shape[2:])
                    take = shape[1] * shape[2] * shape[3] * shape[4]
                    leaf[:, idx] = payloads[:, cur:cur + take].reshape(
                        shape).to(leaf.dtype).movedim(1, 0)
                cur += take

    def map_slot(self, slot: int, phys_pages, pos: int) -> None:
        """Point ``slot``'s page-table row at ``phys_pages`` and restore its
        cache position — how a promoted sequence gets its device identity
        back.  Restores both position counters: the paged dicts' per-row
        ``pos`` (scatter target and causal mask) and the stack's top-level
        ``step`` counter (rope positions), which kept advancing while the
        slot sat cold, since parked rows still ride the batched decode."""
        phys = torch.as_tensor(list(phys_pages), dtype=torch.int32,
                               device=self.device)
        for d in _paged_dicts(self.cache):
            d["page_table"][..., slot, :] = phys
            d["pos"][..., slot] = pos

        def restep(tree):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    if k != "step":
                        restep(v)
                if "step" in tree and "k_pages" not in tree:
                    tree["step"][slot] = pos
            elif isinstance(tree, list):
                for v in tree:
                    restep(v)

        restep(self.cache)

    def park(self, slot: int) -> None:
        """Point a released slot's table rows at the parking page (its idle
        decode writes must never land on pages a later admission owns)."""
        disagg.park_slot(self.cache, slot)

    # -- cache insertion ---------------------------------------------------------
    def _insert(self, full, one, slot, phys_pages, write_ok) -> None:
        """Insert the freshly prefilled 1-row cache ``one`` into slot
        ``slot`` of ``full``: paged attention dicts scatter through the page
        table, every other leaf copies along its batch axis."""
        if isinstance(full, dict):
            if "k_pages" in full:
                self._insert_paged_attn(full, one, slot, phys_pages, write_ok)
                return
            for key in full:
                self._insert(full[key], one[key], slot, phys_pages, write_ok)
        elif isinstance(full, list):
            for f, o in zip(full, one):
                self._insert(f, o, slot, phys_pages, write_ok)
        else:
            _insert_row(full, one, slot, self.n_slots)

    def _insert_paged_attn(self, full, one, slot, phys_pages, write_ok):
        """Scatter a dense (…, 1, S, KV, hd) prefill KV into the slot's
        physical pages and point the slot's page-table row at them.  Pages
        with ``write_ok=False`` are shared — the donor already holds their
        prefix KV — so their scatter lands on the parking page while the
        table still maps them."""
        pt = self.page_tokens
        park = full["k_pages"].shape[-4] - 1
        phys = torch.as_tensor(phys_pages, dtype=torch.int64,
                               device=self.device)
        ok = torch.as_tensor(write_ok, dtype=torch.bool, device=self.device)
        dest = torch.where(ok, phys, park)
        for key, src in (("k_pages", "k"), ("v_pages", "v")):
            pool, dense = full[key], one[src]
            *lead, _, s, kv, hd = dense.shape
            d = dense.reshape(*lead, s // pt, pt, kv, hd).to(pool.dtype)
            if pool.dim() == 4:
                pool[dest] = d
            else:
                pool[:, dest] = d                   # leading layer axis
        full["page_table"][..., slot, :] = phys.to(torch.int32)
        full["pos"][..., slot] = one["pos"][..., 0]


class ServeEngine:
    """Greedy-decoding continuous-batching engine over ``n_slots`` slots —
    the facade wiring scheduler, KV pool manager and executor together.
    Runs on the device of ``params``.

    The engine owns the tree it is handed: after construction the caller's
    tree holds each leaf the model reads only in its compute dtype in that
    dtype, converted once in its own bytes (:class:`Executor`);
    ``stats()`` counts them (``weights_converted``,
    ``weights_converted_bytes``, ``weights_kept``), and the decode ticks
    by how they ran (``decode_graph_captures``, ``decode_graph_replays``,
    ``decode_eager``)."""

    def __init__(self, model, params, *, n_slots: int, max_seq: int,
                 paged_kv: bool = False, page_tokens: int = 16,
                 policy: str = "continuous", prefix_share: bool = False,
                 kv_pages: int | tuple[int, int] | None = None,
                 tier_quantum: int = 2):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.paged_kv = paged_kv
        self.tiered = False
        if prefix_share and not paged_kv:
            raise ValueError("prefix_share=True requires paged_kv=True "
                             "(sharing happens on the physical page pool)")
        self.prefix_share = prefix_share
        self.executor = Executor(model, params, n_slots=n_slots,
                                 max_seq=max_seq, paged_kv=paged_kv,
                                 page_tokens=page_tokens)
        if paged_kv:
            self.page_tokens = page_tokens
            self.pages_per_slot = max_seq // page_tokens
            n_pages = n_slots * self.pages_per_slot
            host_pages = 0
            if isinstance(kv_pages, tuple):
                kv_pages, host_pages = kv_pages
                if host_pages < 0:
                    raise ValueError(
                        f"kv_pages=(hbm, host): host pages must be >= 0, "
                        f"got {host_pages}")
            if kv_pages is not None:
                if not self.pages_per_slot <= kv_pages <= n_pages:
                    raise ValueError(
                        f"kv_pages={kv_pages} must be between pages_per_slot"
                        f"={self.pages_per_slot} and the device pool size "
                        f"{n_pages}")
                n_pages = kv_pages
            self.pool = KVPoolManager(n_pages, host_pages)
            self.slot_pages: dict[int, list[int]] = {}
            self._ro_pages: set[int] = set()
            self.tiered = host_pages > 0
            self.tier_quantum = max(int(tier_quantum), 1)
            if self.tiered:
                if host_pages < self.pages_per_slot:
                    raise ValueError(
                        f"kv_pages=({n_pages}, {host_pages}): the host tier "
                        f"must hold at least one sequence "
                        f"(pages_per_slot={self.pages_per_slot})")
                ex = self.executor
                self.tier = HostKVTier(host_pages, ex.page_payload_elems,
                                       ex.page_payload_dtype,
                                       device=ex.device)
                self._cold: dict[int, dict] = {}   # slot -> {"host": [...]}
                self._active: set[int] = set()
                self._promote_next: list[int] = []
                self._hot_since: dict[int, int] = {}
        self.scheduler = Scheduler(n_slots, policy)
        self.slot_free = [True] * n_slots
        self._offline: set[int] = set()
        self.evictions = 0
        self.slot_req: dict[int, Request] = {}
        self.slot_generated: dict[int, list] = {}
        self.slot_pos: dict[int, int] = {}
        self.slot_entry: dict[int, object] = {}
        self.done: list[Completion] = []
        self._last_tokens = np.zeros((n_slots, 1), np.int32)
        self._tick = 0
        self._incomplete = 0
        self.max_live = 0

    # -- public API --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_seq:
            raise ValueError("prompt longer than max_seq")
        self.scheduler.submit(req, tick=self._tick,
                              t_submit=time.perf_counter())

    def step(self) -> None:
        """One engine tick: migrate tiers, admit per the policy, fork shared
        pages about to be written, then one decode step over every slot.
        In tiered mode only active (HBM-resident) slots commit tokens: a
        cold slot's row is parked and its output discarded."""
        with obs.span("serve.tick", tick=self._tick):
            if self.tiered:
                with obs.span("serve.tier"):
                    self._tier_tick()
            self._admit()
            if self.slot_req:
                if self.paged_kv and self.prefix_share:
                    with obs.span("serve.cow"):
                        self._cow_tick()
                if self.tiered:
                    # every active slot's pages must be hot before decode
                    for slot in sorted(self._active):
                        self.pool.assert_resident(self.slot_pages[slot])
                with obs.span("serve.decode", rows=len(self.slot_req)):
                    nxt = self.executor.decode(self._last_tokens)
                for slot in list(self.slot_req):
                    if self.tiered and slot not in self._active:
                        continue
                    tok = int(nxt[slot])
                    self.slot_generated[slot].append(tok)
                    self.slot_pos[slot] += 1
                    self._last_tokens[slot, 0] = tok
                    self._finish_if_ended(slot)
        self._tick += 1

    def evict_slots(self, slots, *, requeue: bool = True) -> int:
        """Evict the live sequences on ``slots`` (the elastic path when a
        worker owning them is quarantined): each releases its slot through
        the normal teardown and, under ``requeue=True``, its scheduler entry
        goes back to the front of the queue with its arrival intact —
        re-admission re-prefills from the prompt, so greedy decode
        reproduces the lost tokens.  Returns how many were requeued."""
        n = 0
        for slot in slots:
            if slot not in self.slot_req:
                continue
            entry = self.slot_entry.get(slot)
            req = self.slot_req[slot]
            self._release(slot)
            self.evictions += 1
            if requeue:
                if entry is not None:
                    self.scheduler.requeue(entry)
                else:
                    self.scheduler.submit(req, tick=self._tick)
                n += 1
        return n

    def set_slots_offline(self, slots, offline: bool = True) -> None:
        """Take decode slots out of (or back into) the admission pool.
        Offline slots read as not-free, so admission skips them."""
        for slot in slots:
            if offline:
                if slot in self.slot_req:
                    raise ValueError(
                        f"slot {slot} still holds a live sequence — "
                        f"evict_slots() it before taking it offline")
                self._offline.add(slot)
                self.slot_free[slot] = False
            else:
                self._offline.discard(slot)
                if slot not in self.slot_req:
                    self.slot_free[slot] = True

    def run(self, max_ticks: int = 10_000, *,
            strict: bool = False) -> list[Completion]:
        """Drive ticks until every submitted request completes or
        ``max_ticks`` is exhausted.  On exhaustion each live slot yields a
        ``Completion(finished=False)`` with its partial tokens and each
        queued request one with no tokens (``stats()['incomplete']`` counts
        them), or under ``strict=True`` a ``RuntimeError`` names them."""
        ticks = 0
        while ((self.scheduler.pending_count or self.slot_req)
               and ticks < max_ticks):
            self.step()
            ticks += 1
        live = [(slot, self.slot_req[slot]) for slot in sorted(self.slot_req)]
        queued = self.scheduler.pending_entries()
        self._incomplete = len(live) + len(queued)
        if self._incomplete and strict:
            rids = [r.rid for _, r in live] + [e.req.rid for e in queued]
            raise RuntimeError(
                f"run(max_ticks={max_ticks}) exhausted with "
                f"{self._incomplete} request(s) unfinished (rids {rids}) — "
                "raise max_ticks, or strict=False for explicit incomplete "
                "completions")
        out = list(self.done)
        for slot, req in live:
            e = self.slot_entry.get(slot)
            out.append(Completion(req.rid, list(self.slot_generated[slot]),
                                  False, e.arrival if e else 0, self._tick))
        for e in queued:
            out.append(Completion(e.req.rid, [], False, e.arrival,
                                  self._tick))
        return out

    def stats(self) -> dict:
        """Engine health across all three layers."""
        out = {"completed": len(self.done),
               "pending": self.scheduler.pending_count,
               "live_slots": len(self.slot_req), "paged_kv": self.paged_kv,
               "policy": self.scheduler.policy,
               "submitted": self.scheduler.submitted,
               "admitted": self.scheduler.admitted,
               "ticks": self._tick, "incomplete": self._incomplete,
               "max_live": self.max_live, "evictions": self.evictions,
               "offline_slots": len(self._offline),
               **self.executor.weight_stats, **self.executor.decode_counts}
        if self.paged_kv:
            out.update(pages_allocated=self.pool.allocs,
                       pages_freed=self.pool.frees,
                       pages_free=self.pool.n_free,
                       page_tokens=self.page_tokens,
                       pages_shared=self.pool.shared_maps,
                       cow_copies=self.pool.cow_copies,
                       cow_debt=self.pool.cow_debt)
            if self.tiered:
                out.update(host_pages=self.pool.host.capacity,
                           host_pages_free=self.pool.host.n_free,
                           cold_slots=len(self._cold),
                           active_slots=len(self._active),
                           demotions=self.pool.demotions,
                           promotions=self.pool.promotions,
                           tier_stale_drops=int(self.tier.err_count.sum()))
        return out

    # -- internals --------------------------------------------------------------
    def _finish_if_ended(self, slot: int) -> bool:
        """Complete-and-release ``slot`` iff its latest token ends the
        request (EOS, token budget, or cache full)."""
        req = self.slot_req[slot]
        gen = self.slot_generated[slot]
        ended = (gen[-1] == req.eos_id or
                 len(gen) >= req.max_new_tokens or
                 self.slot_pos[slot] >= self.max_seq - 1)
        if ended:
            e = self.slot_entry.get(slot)
            self.done.append(Completion(req.rid, gen, True,
                                        e.arrival if e else 0, self._tick))
            self._release(slot)
        return ended

    def _admit(self) -> None:
        """Admit what the scheduler selects, until it selects nothing (an
        admission-time completion frees its slot within the tick)."""
        with obs.span("serve.admit"):
            while True:
                n_free = sum(self.slot_free)
                if self.tiered:
                    # total-footprint pricing against the whole hierarchy: an
                    # admitted sequence may rotate through the cold tier, but
                    # never lands on capacity that does not exist
                    n_free = min(n_free, self.scheduler.price_admission(
                        pages_per_seq=self.pages_per_slot,
                        hbm_free=self.pool.n_free,
                        host_free=self.pool.host.n_free,
                        reserve=self.pool.cow_debt))
                entries = self.scheduler.select(
                    n_free, live=len(self.slot_req), tick=self._tick)
                if not entries:
                    return
                for idx, entry in enumerate(entries):
                    slot = self.slot_free.index(True)
                    if not self._admit_one(entry, slot):
                        # pool pressure: hand this and the rest back, front of
                        # queue, original order — retry next tick
                        for e in reversed(entries[idx:]):
                            self.scheduler.requeue(e)
                        return

    def _admit_one(self, entry, slot: int) -> bool:
        """Prefill one selected request into ``slot``.  Returns False (no
        state changed; requeue the entry) when the pool cannot back it
        fork-safely."""
        req = entry.req
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self.executor.device)[None]
        phys, write_ok = [], np.zeros((0,), bool)
        if self.paged_kv:
            shared, shared_rw = ([], [])
            if self.prefix_share:
                shared, shared_rw = self._share_plan(req)
            n_fresh = self.pages_per_slot - len(shared) - len(shared_rw)
            # price shares by their true fork-debt delta
            debt = (self.pool.share_price(shared)
                    + self.pool.share_price(shared_rw, writable=True))
            if not self.pool.can_admit(n_fresh, debt):
                return False
            fresh = self.pool.alloc(n_fresh)
            if shared:
                self.pool.share_pages(shared)
            if shared_rw:
                self.pool.share_pages(shared_rw, writable=True)
            phys = shared + shared_rw + fresh
            self.slot_pages[slot] = phys
            write_ok = np.ones(self.pages_per_slot, bool)
            write_ok[:len(shared) + len(shared_rw)] = False
            newly_ro = [p for p in shared + shared_rw
                        if self.pool.refcount_of(p) >= 2]
            if newly_ro:
                self.executor.set_pages_ro(newly_ro, True)
                self._ro_pages.update(newly_ro)
            if self.tiered:
                if fresh:
                    self.executor.set_pages_hot(fresh, True)
                self._active.add(slot)
                self._hot_since[slot] = self._tick
        # submitted → the span's start is the request's queue wait
        with obs.span("serve.prefill", rid=req.rid, tokens=len(req.prompt),
                      submitted=entry.t_submit):
            first = self.executor.prefill(tokens, slot, phys, write_ok)
        self.slot_free[slot] = False
        self.slot_req[slot] = req
        self.slot_generated[slot] = [first]
        self.slot_pos[slot] = len(req.prompt) + 1
        self.slot_entry[slot] = entry
        self.max_live = max(self.max_live, len(self.slot_req))
        # the prefill token can already end the request: complete and
        # release now, or the slot decodes a spurious extra step
        if self._finish_if_ended(slot):
            return True
        self._last_tokens[slot, 0] = first
        return True

    def _share_plan(self, req: Request) -> tuple[list[int], list[int]]:
        """Find the live donor with the longest common prompt prefix and
        split its pages into (read-only shared, copy-on-write shared).

        Full pages inside the common prefix hold bit-identical KV for both
        sequences.  The partial page at the prefix boundary is shared
        copy-on-write only when the new prompt ends exactly at the prefix;
        otherwise the new prefill writes that page's tail, so it is
        allocated fresh."""
        prompt = [int(t) for t in req.prompt]
        best_c, donor = 0, None
        for slot, dreq in self.slot_req.items():
            if slot not in self.slot_pages:
                continue
            c = 0
            for a, b in zip(prompt, dreq.prompt):
                if a != int(b):
                    break
                c += 1
            if c > best_c:
                best_c, donor = c, slot
        if donor is None:
            return [], []
        pt = self.page_tokens
        n_full = min(best_c // pt, self.pages_per_slot)
        shared = [self.slot_pages[donor][j] for j in range(n_full)]
        shared_rw = []
        if (best_c % pt and len(prompt) == best_c
                and n_full < self.pages_per_slot):
            shared_rw = [self.slot_pages[donor][n_full]]
        return shared, shared_rw

    def _cow_tick(self) -> None:
        """Fork any shared page a live slot is about to write, before the
        decode scatter: the write position this tick is ``slot_pos - 1``."""
        for slot in list(self.slot_req):
            pages = self.slot_pages.get(slot)
            if not pages:
                continue
            wpos = self.slot_pos[slot] - 1
            j = wpos // self.page_tokens
            if j >= self.pages_per_slot:
                continue               # cache full: the write is dropped
            p = pages[j]
            if self.pool.refcount_of(p) <= 1:
                if p in self._ro_pages:     # last co-holder is gone
                    self.executor.set_pages_ro([p], False)
                    self._ro_pages.discard(p)
                continue
            new, _ = self.pool.cow_write(p)
            self.executor.fork_page(slot, j, p, new)
            pages[j] = new
            if self.pool.refcount_of(p) <= 1 and p in self._ro_pages:
                self.executor.set_pages_ro([p], False)
                self._ro_pages.discard(p)

    def _tier_tick(self) -> None:
        """One tier-rotation step, at the top of every tick.

        1. Demote the oldest-hot victims until the HBM free list can back
           the scheduled promotions, one fresh admission (if a request is
           pending and the hierarchy has room) and the COW fork reserve:
           payload snapshot, host-slot alloc, planned puts, then release
           (sharing dissolves on demotion).
        2. Promote the scheduled slots that now fit: the planned reads land
           in fresh hot pages, the table row and position are restored
           (:meth:`Executor.map_slot`), and the cold copy is retired through
           ``memhandle_release``.  Steps 1 and 2 are one
           :func:`~repro_torch.serve.paged.tier_step_plan` replay.
        3. Recompute the active set and schedule the next promotions
           (oldest-cold first, every ``tier_quantum`` ticks or at once when
           nothing is active)."""
        pool, ex, tier = self.pool, self.executor, self.tier
        pps = self.pages_per_slot
        # promotions scheduled last tick (slots may have finished meanwhile)
        enter = [s for s in self._promote_next if s in self._cold]
        self._promote_next = []
        # demotion headroom also covers one fresh admission this tick
        admit_head = 0
        if (self.scheduler.pending_count and any(self.slot_free)
                and self.scheduler.price_admission(
                    pages_per_seq=pps, hbm_free=pool.n_free,
                    host_free=pool.host.n_free,
                    reserve=pool.cow_debt) > 0):
            admit_head = pps
        target = pps * len(enter) + admit_head + pool.cow_debt
        projected = pool.n_free
        host_room = pool.host.n_free
        leave: list[int] = []
        hot_live = sorted(
            (s for s in self.slot_req
             if s in self._active and s in self.slot_pages),
            key=lambda s: self._hot_since.get(s, 0))
        for s in hot_live:
            if projected >= target or host_room < pps:
                break
            # only sole-owner pages return to the free list; a shared
            # page's co-holders keep it resident
            projected += sum(1 for p in self.slot_pages[s]
                             if pool.refcount_of(p) == 1)
            host_room -= pps
            leave.append(s)
        demote_pages: list[int] = []
        for s in leave:
            demote_pages.extend(self.slot_pages[s])
        payloads = (ex.gather_page_payloads(demote_pages)
                    if demote_pages else None)
        host_slots = pool.alloc_cold(len(demote_pages)) if demote_pages else []
        for hp, hs in zip(demote_pages, host_slots):
            pool.queue_demote(hp, hs)
        # which scheduled promotions fit after this demotion round
        avail = projected - admit_head - pool.cow_debt
        promote: list[int] = []
        for s in enter:
            if avail >= pps:
                promote.append(s)
                avail -= pps
            else:
                self._promote_next.append(s)     # stays queued (in flight)
        promote_hosts = [h for s in promote for h in self._cold[s]["host"]]
        # one planned tier step: the promote reads (prefetch edges) issued
        # ahead of the demote puts, one completion epoch each
        tier.alloc(host_slots)
        promoted = tier.step(promote_hosts, host_slots, payloads)
        # commit demotions: park, release (COW machinery runs normally),
        # clear the residency bits of pages that actually freed
        cursor = 0
        for s in leave:
            pages = self.slot_pages.pop(s)
            ex.park(s)
            dropped = pool.release(pages)
            ro_clear = [p for p in dropped if p in self._ro_pages]
            if ro_clear:
                ex.set_pages_ro(ro_clear, False)
                self._ro_pages.difference_update(ro_clear)
            freed = [p for p in dropped if pool.refcount_of(p) == 0]
            if freed:
                ex.set_pages_hot(freed, False)
            self._cold[s] = {"host": host_slots[cursor:cursor + pps]}
            cursor += pps
            self._active.discard(s)
            self._hot_since.pop(s, None)
        pool.drain_demotes()
        # commit promotions: payloads land in fresh hot pages, identity
        # (table row and position) restored, cold copies retired
        cursor = 0
        for s in promote:
            hs = self._cold.pop(s)["host"]
            fresh = pool.alloc(pps)
            ex.scatter_page_payloads(fresh, promoted[cursor:cursor + pps])
            ex.set_pages_hot(fresh, True)
            ex.map_slot(s, fresh, self.slot_pos[s] - 1)
            self.slot_pages[s] = fresh
            tier.free(hs)
            pool.drain_promotes(hs)
            pool.free_cold(hs)
            self._hot_since[s] = self._tick
            cursor += pps
        self._active = {s for s in self.slot_req if s in self.slot_pages}
        # schedule the next promotion round a tick ahead: oldest-cold
        # first, on the rotation quantum (or at once when nothing is active)
        if self._cold and (self._tick % self.tier_quantum == 0
                           or not self._active):
            k = max(1, (pool.n_pages // max(pps, 1)) // 2)
            cand = [s for s in self._cold
                    if s not in self._promote_next][:k]
            if cand:
                self._promote_next.extend(cand)
                pool.queue_promote(
                    [h for s in cand for h in self._cold[s]["host"]])

    def _release(self, slot: int) -> None:
        self.slot_free[slot] = slot not in self._offline
        del self.slot_req[slot]
        del self.slot_generated[slot]
        del self.slot_pos[slot]
        self.slot_entry.pop(slot, None)
        if self.paged_kv and slot in self.slot_pages:
            # park the row before its pages go back to the free list: idle
            # rows keep scattering per-step KV, and those writes must never
            # land on pages a later admission may own
            self.executor.park(slot)
            dropped = self.pool.release(self.slot_pages.pop(slot))
            ro_clear = [p for p in dropped if p in self._ro_pages]
            if ro_clear:
                self.executor.set_pages_ro(ro_clear, False)
                self._ro_pages.difference_update(ro_clear)
        if self.tiered:
            self._active.discard(slot)
            self._hot_since.pop(slot, None)
            if slot in self._promote_next:
                self._promote_next.remove(slot)
            if slot in self._cold:
                # a cold slot released outright: retire its host copy (the
                # epoch bump makes any straggler handle stale)
                hs = self._cold.pop(slot)["host"]
                self.tier.free(hs)
                self.pool.free_cold(hs)


__all__ = ["ServeEngine", "Executor", "Request", "Completion",
           "own_weights"]
