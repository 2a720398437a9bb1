"""The unified RMA substrate — one epoch engine under every window view.

On one card the n ranks of a window are the rows of one stacked tensor
(row r = rank r's exposed memory), so a "remote" operation is a write into
another rank's row, lowered to the port's kernels:

* put, the response half of get, channel sends and ring hops → K3
  (``kernels.rma_put``), which bumps a per-(rank, stream) completion counter;
* a flush of stream s → K3's wait, on the card, for the counters (·, s) to
  reach what the stream's puts owe;
* a put and its doorbell (``put_signal``) → one K4 launch, and an ordered
  accumulate and its doorbell (``acc_signal``) → one K6 launch
  (``kernels.ordered_put_signal``), billed as the operations they fuse;
* intrinsic-routed accumulates → K2 (``kernels.intrinsic``): origin atomics
  on the target row;
* tiled-routed accumulates → K3 lands the update, K1 (``kernels.accumulate``)
  folds it into the target rows.

:class:`FlushQueues` is the JAX package's scope-aware flush-queue state,
unchanged: shared by a whole dup family, it decides which streams a flush
drains (P1).  The JAX substrate proves its cost model in lowered HLO; here
every operation bills a :class:`PhaseLedger` with the same model, so a
recorded pattern's ledger can be held against the planner's prediction:

==========================  ==================================================
operation                   phases
==========================  ==================================================
put                         1, plus 1 for a per-rank (tensor) displacement
get                         2 (request + response), plus 1 likewise
send / hop                  1
intrinsic / tiled accum.    1, plus 1 likewise
software accumulate         2 (payload + completion ack)
target ack                  1
flush, thread scope         2 for the named stream if it has ops pending
                            (and one K3 wait on its counters)
flush, process scope        2 × pending streams (serialized endpoint walk,
                            one K3 wait per stream)
same-host (``shm``) op      the same data phases, billed to the intra tier,
                            and never queued: a flush owes it nothing
==========================  ==================================================

Ordering (P2) needs no tokens: every launch of a window family goes to one
CUDA stream, whose issue order is completion order at the target.  The
substrate is mutable — operations update the buffer in place and return the
substrate, so ``sub = sub.put(...)`` reads like the JAX package's functional
calls.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import torch

from repro_torch.kernels.intrinsic import accumulate_rows_atomic
from repro_torch.kernels.ordered_put_signal import (accumulate_signal_rows,
                                                    put_signal_rows)
from repro_torch.kernels.rma_put import (perm_targets, put_rows,
                                         targets_tensor, wait_counters)

Perm = Sequence[tuple[int, int]]

SCOPE_PROCESS = "process"
SCOPE_THREAD = "thread"


def _is_static(offset) -> bool:
    """True when ``offset`` is one Python int shared by every origin (the
    displacement needs no address word of its own)."""
    return isinstance(offset, int) and not isinstance(offset, bool)


# ---------------------------------------------------------------------------
# Scope-aware flush queues (shared across a dup family)
# ---------------------------------------------------------------------------

class FlushQueues:
    """Per-scope flush queues for one dup family.

    ``pending`` maps a stream id to the route (perm) of that stream's
    in-flight operations.  One object per family, aliased by every view, so
    synchronization through one handle completes operations issued through
    all of them."""

    def __init__(self):
        self.pending: dict[int, tuple] = {}

    def note_op(self, stream: int, perm: Perm) -> None:
        self.pending[stream] = tuple(perm)

    def take(self, scope: str, stream: int | None) -> dict[int, tuple]:
        """Drain queues according to the flush scope: thread scope pops the
        named stream's queue (and must name one — a stream-less thread flush
        would silently pay the process-scope walk); process scope pops every
        queue."""
        if scope == SCOPE_THREAD:
            if stream is None:
                raise ValueError(
                    "thread-scope flush must name the stream it completes "
                    "(flush(stream=...)); a stream-less flush would silently "
                    "pay the process-scope drain-all walk")
            out = {}
            if stream in self.pending:
                out[stream] = self.pending.pop(stream)
            return out
        out, self.pending = self.pending, {}
        return out


class PhaseLedger:
    """Communication phases billed by a dup family, per tier and per kind
    (the port's stand-in for counting collective-permutes in HLO)."""

    def __init__(self):
        self.inter = 0
        self.intra = 0
        self.by_kind: collections.Counter = collections.Counter()

    def bill(self, kind: str, phases: int, *, shm: bool = False) -> None:
        if shm:
            self.intra += phases
        else:
            self.inter += phases
        self.by_kind[kind] += phases

    @property
    def total(self) -> int:
        return self.inter + self.intra


# ---------------------------------------------------------------------------
# Substrate
# ---------------------------------------------------------------------------


def _layers(pairs: Perm) -> list[list[tuple[int, int]]]:
    """Split (src, tgt) pairs into groups in which each src appears once
    (one kernel launch per group)."""
    groups: list[list[tuple[int, int]]] = []
    for s, t in pairs:
        for g in groups:
            if all(s != gs for gs, _ in g):
                g.append((s, t))
                break
        else:
            groups.append([(s, t)])
    return groups


@dataclasses.dataclass
class Substrate:
    """Stacked backing buffer, completion counters, flush queues and phase
    ledger of one dup family.  ``buffer`` is ``(axis_size, ...)``: row r is
    rank r's window.  ``counters[r, s]`` counts the K3 blocks that completed
    rank r's puts on stream s; ``expected`` is what the issued puts owe, and
    ``stalls[0]`` counts the ranks a flush found short of it."""

    buffer: torch.Tensor
    axis: str
    axis_size: int
    queues: FlushQueues
    n_streams: int
    counters: torch.Tensor
    expected: list
    stalls: torch.Tensor
    ledger: PhaseLedger
    #: K4/K6's arrival counters; every launch leaves them at zero, and the
    #: family's launches run in stream order
    scratch: torch.Tensor
    #: origin → target maps already on the device, by map (kernels read
    #: them from device memory; building one is a host-to-device copy)
    targets: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def allocate(cls, buffer: torch.Tensor, axis: str, axis_size: int,
                 n_streams: int = 1) -> "Substrate":
        if buffer.dim() < 2 or buffer.shape[0] != axis_size:
            raise ValueError(
                f"a window buffer is the stacked (axis_size={axis_size}, "
                f"...) shards of every rank, got {tuple(buffer.shape)}")
        counters = torch.zeros((axis_size, n_streams), dtype=torch.int32,
                               device=buffer.device)
        return cls(buffer, axis, axis_size, FlushQueues(), n_streams,
                   counters, [[0] * n_streams for _ in range(axis_size)],
                   torch.zeros(1, dtype=torch.int32, device=buffer.device),
                   PhaseLedger(),
                   torch.zeros(axis_size + 2, dtype=torch.int32,
                               device=buffer.device))

    # -- helpers ----------------------------------------------------------
    def _targets(self, pairs) -> torch.Tensor:
        key = tuple(perm_targets(pairs, self.axis_size))
        t = self.targets.get(key)
        if t is None:
            t = targets_tensor(key, self.axis_size, self.buffer.device)
            self.targets[key] = t
        return t

    def _payload(self, data: torch.Tensor) -> torch.Tensor:
        if data.shape[0] != self.axis_size:
            raise ValueError(
                f"payloads are stacked per rank: leading dim must be "
                f"{self.axis_size}, got {tuple(data.shape)}")
        return data.to(device=self.buffer.device,
                       dtype=self.buffer.dtype).contiguous()

    def _offsets(self, offset, perm: Perm) -> dict[int, int]:
        """origin → displacement (a per-rank tensor gives each origin its
        own word, the analogue of a traced displacement)."""
        if _is_static(offset):
            return {s: offset for s, _ in perm}
        offs = torch.as_tensor(offset).reshape(-1).tolist()
        return {s: int(offs[s]) for s, _ in perm}

    def _write_rows(self, src: torch.Tensor, dst: torch.Tensor, perm: Perm,
                    offsets: dict[int, int], stream: int) -> None:
        """dst[t, off(s):] = src[s] for (s, t) in perm through K3, one
        launch per distinct displacement (and per repeated origin)."""
        n = self.axis_size
        by_off: dict[int, list] = {}
        for s, t in perm:
            by_off.setdefault(offsets[s], []).append((s, t))
        for off, pairs in by_off.items():
            for group in _layers(pairs):
                ticks = put_rows(src, dst, self._targets(group), offset=off,
                                 counters=self.counters, stream=stream)
                for s, _ in group:
                    self.expected[s][stream] += ticks

    def _read(self, perm: Perm, offs: dict[int, int], size: int,
              stream: int) -> torch.Tensor:
        """The response half of a read: row s of the result is ``size``
        rows of target t's window at s's displacement (K3 from the target
        rows); ranks that read nothing get zeros."""
        out = torch.zeros((self.axis_size, size) + tuple(self.buffer.shape[2:]),
                          dtype=self.buffer.dtype, device=self.buffer.device)
        for s, t in perm:
            if not 0 <= offs[s] <= self.buffer.shape[1] - size:
                raise ValueError(f"read of {size} rows at offset {offs[s]} "
                                 "overruns the window shard")
        for off in sorted(set(offs.values())):
            pairs = [(t, s) for s, t in perm if offs[s] == off]
            self._write_rows(self.buffer[:, off:off + size], out, pairs,
                             {t: 0 for t, _ in pairs}, stream)
        return out

    def _land(self, data: torch.Tensor, perm: Perm, stream: int
              ) -> torch.Tensor:
        """Ship ``data`` along ``perm`` into a zeroed staging tensor: row t
        holds what its origin sent (non-targets read zeros)."""
        staged = torch.zeros(data.shape, dtype=data.dtype, device=data.device)
        self._write_rows(data, staged, perm, {s: 0 for s, _ in perm}, stream)
        return staged

    # -- transport primitives ---------------------------------------------
    def put(self, data: torch.Tensor, perm: Perm, *, offset=0,
            stream: int = 0, shm: bool = False) -> "Substrate":
        """Origin-addressed write (``MPI_Put``): row t of the window gets
        its origin's payload at the origin's displacement.  K3."""
        data = self._payload(data)
        self._write_rows(data, self.buffer, perm, self._offsets(offset, perm),
                         stream)
        self.ledger.bill("put", 1 + (0 if _is_static(offset) else 1), shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self

    def put_multi(self, datas: Sequence[torch.Tensor], perm: Perm, *,
                  offsets: Sequence[int], stream: int = 0,
                  shm: bool = False) -> "Substrate":
        """Gather-write: several same-peer puts billed as one phase (one
        packet with a scatter-gather list); static displacements only."""
        for off in offsets:
            if not _is_static(off):
                raise ValueError(
                    "put_multi requires static (int) offsets; per-rank "
                    "displacements cannot share one gather-write packet")
        for d, off in zip(datas, offsets):
            self._write_rows(self._payload(d), self.buffer, perm,
                             {s: off for s, _ in perm}, stream)
        self.ledger.bill("put", 1, shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self

    def get(self, perm: Perm, *, offset=0, size: int, stream: int = 0,
            shm: bool = False) -> tuple["Substrate", torch.Tensor]:
        """Read (``MPI_Get``): origin s receives ``size`` rows of target t's
        window at the origin's displacement; other ranks read zeros.  The
        response is a K3 put from the target rows."""
        out = self._read(perm, self._offsets(offset, perm), size, stream)
        self.ledger.bill("get", 2 + (0 if _is_static(offset) else 1), shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self, out

    def channel_send(self, payload: torch.Tensor, perm: Perm, *,
                     stream: int = 0, shm: bool = False
                     ) -> tuple["Substrate", torch.Tensor]:
        """Raw one-phase transfer (the ring hop primitive): returns what
        each rank received (zeros where nothing arrived).  No cast.  K3."""
        if payload.shape[0] != self.axis_size:
            raise ValueError(f"stacked payload must lead with "
                             f"{self.axis_size}, got {tuple(payload.shape)}")
        payload = payload.contiguous()
        if payload.dim() == 1:
            recvd = self._land(payload.view(-1, 1), perm, stream).view(-1)
        else:
            recvd = self._land(payload, perm, stream)
        self.ledger.bill("send", 1, shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self, recvd

    def rmw(self, data: torch.Tensor, perm: Perm, op: str, *, path: str,
            offset=0, stream: int = 0, shm: bool = False) -> "Substrate":
        """Remote read-modify-write — the accumulate transport, by routed
        path: ``intrinsic`` issues K2 atomics from the origin (1 phase);
        ``tiled`` lands the update with K3 and folds it with K1 (1 phase);
        ``software`` lands it and has the target runtime fold it, then pays
        a completion ack (2 phases)."""
        from repro_torch.core.rma import accumulate as _engine

        data = self._payload(data)
        n, m = self.axis_size, data.shape[1]
        offs = self._offsets(offset, perm)
        for s, _ in perm:
            if not 0 <= offs[s] <= self.buffer.shape[1] - m:
                raise ValueError(f"accumulate of {m} rows at offset "
                                 f"{offs[s]} overruns the window shard")
        flat = self.buffer.reshape(n, -1)
        inner = flat.shape[1] // self.buffer.shape[1]
        if path == _engine.PATH_INTRINSIC:
            for off in sorted(set(offs.values())):
                pairs = [(s, t) for s, t in perm if offs[s] == off]
                accumulate_rows_atomic(data.reshape(n, -1), flat,
                                       self._targets(pairs), op=op,
                                       offset=off * inner)
        else:
            staged = self._land(data, perm, stream)
            combine = _engine.path_combine(path, op)
            targets = sorted(t for _, t in perm)
            src_of = {t: s for s, t in perm}
            if (_is_static(offset) and targets == list(range(n))
                    and flat.stride(1) == 1):
                region = flat[:, offset * inner:(offset + m) * inner]
                combine(region, staged.reshape(n, -1))
            else:
                for t in targets:
                    off = offs[src_of[t]] * inner
                    combine(flat[t:t + 1, off:off + m * inner],
                            staged[t:t + 1].reshape(1, -1))
        software = path == _engine.PATH_SOFTWARE
        self.ledger.bill("accumulate", (2 if software else 1)
                         + (0 if _is_static(offset) else 1), shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self

    def fetch_rmw(self, data: torch.Tensor, perm: Perm, op: str, *,
                  offset=0, stream: int = 0, shm: bool = False
                  ) -> tuple["Substrate", torch.Tensor]:
        """Atomic fetch-and-op (``MPI_Fetch_and_op``): origin s receives
        target t's region at its displacement as it was before, and the
        target folds in ``data[s]``.  One round trip (2 phases), plus the
        address word of a per-rank displacement."""
        from repro_torch.core.rma.accumulate import apply_op

        data = self._payload(data)
        offs = self._offsets(offset, perm)
        m = data.shape[1]
        old = self._read(perm, offs, m, stream)
        staged = self._land(data, perm, stream)
        for s, t in perm:
            region = self.buffer[t, offs[s]:offs[s] + m]
            region.copy_(apply_op(region, staged[t], op))
        self.ledger.bill("fetch_op", 2 + (0 if _is_static(offset) else 1),
                         shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self, old

    def compare_swap(self, compare: torch.Tensor, new: torch.Tensor,
                     perm: Perm, *, offset=0, stream: int = 0,
                     shm: bool = False) -> tuple["Substrate", torch.Tensor]:
        """``MPI_Compare_and_swap`` on one element of a 1-D shard: where
        target t's word at origin s's displacement equals ``compare[s]`` it
        becomes ``new[s]``; origin s receives the old word (others zero).
        One round trip (2 phases), plus a per-rank displacement's word."""
        if self.buffer.dim() != 2:
            raise ValueError("compare_swap works on windows of 1-D shards")
        offs = self._offsets(offset, perm)
        dev, dt = self.buffer.device, self.buffer.dtype
        for s, _ in perm:
            if not 0 <= offs[s] < self.buffer.shape[1]:
                raise ValueError(f"compare_swap at offset {offs[s]} is "
                                 "outside the window shard")
        src = torch.tensor([s for s, _ in perm], device=dev)
        tgt = torch.tensor([t for _, t in perm], device=dev)
        at = torch.tensor([offs[s] for s, _ in perm], device=dev)
        cur = self.buffer[tgt, at]
        old = torch.zeros(self.axis_size, dtype=dt, device=dev)
        old[src] = cur
        swap = cur == compare.to(device=dev, dtype=dt)[src]
        self.buffer[tgt, at] = torch.where(
            swap, new.to(device=dev, dtype=dt)[src], cur)
        self.ledger.bill("compare_swap", 2 + (0 if _is_static(offset) else 1),
                         shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self, old

    def target_ack(self, perm: Perm, *, stream: int = 0) -> "Substrate":
        """One completion-ack phase back along ``perm`` (the conservative
        accumulate protocol's per-op round trip)."""
        self.ledger.bill("ack", 1)
        return self

    # -- a payload and its doorbell in one launch (K4, K6) -----------------
    def _flag_rows(self, flag: torch.Tensor, flag_offset: int):
        """The flag payload and the window rows it lands in, flattened: a
        flag displacement counts rows of a shard, a flag word elements."""
        n = self.axis_size
        flat = self.buffer.reshape(n, -1)
        inner = flat.shape[1] // self.buffer.shape[1]
        return flag.reshape(n, -1), flat, flag_offset * inner

    @staticmethod
    def _one_origin_per_target(perm: Perm) -> None:
        """K4/K6 fold and flag with plain stores: exact only when no two
        origins reach one target (a permutation, as the reference's
        collective permutes require)."""
        targets = [t for _, t in perm]
        if len(set(targets)) != len(targets):
            raise ValueError(f"perm {tuple(perm)} sends two origins to one "
                             "target; put/accumulate+signal move a "
                             "permutation")

    def _rank_offsets(self, offset, perm: Perm):
        if _is_static(offset):
            return offset
        offs = self._offsets(offset, perm)
        return [offs.get(r, 0) for r in range(self.axis_size)]

    def launch_signal(self, data: torch.Tensor, perm: Perm, *,
                      op: str | None = None, dst: torch.Tensor | None = None,
                      offset=0, flag: torch.Tensor, flag_offset: int,
                      flag_op: str, flag_sub: "Substrate | None" = None,
                      ordered: bool = True, stream: int = 0) -> None:
        """One K4 (``op=None``: copy) or K6 (fold with ``op``) launch: the
        payload along ``perm``, then its flag words at ``flag_offset`` of
        ``flag_sub``'s window (default: this one).  The payload lands in
        this window at ``offset``, or in ``dst`` (stacked rows, as a
        two-sided send lands) when given.  Ticks this family's completion
        counters on ``stream``; billing is the caller's."""
        self._one_origin_per_target(perm)
        fsub = self if flag_sub is None else flag_sub
        flag, flat, foff = fsub._flag_rows(flag, flag_offset)
        if dst is None:
            data, dst = self._payload(data), self.buffer
            offset = self._rank_offsets(offset, perm)
        common = dict(flag=flag, flag_dst=flat, offset=offset,
                      flag_offset=foff, flag_op=flag_op, ordered=ordered,
                      counters=self.counters, stream=stream,
                      stalls=self.stalls, scratch=self.scratch)
        if op is None:
            ticks = put_signal_rows(data, dst, self._targets(perm), **common)
        else:
            ticks = accumulate_signal_rows(data, dst, self._targets(perm),
                                           op=op, **common)
        for s, _ in perm:
            self.expected[s][stream] += ticks

    def put_signal(self, data: torch.Tensor, perm: Perm, *, offset=0,
                   flag: torch.Tensor, flag_offset: int, flag_op: str,
                   flag_path: str, stream: int = 0, shm: bool = False,
                   ordered: bool = True, scope: str = SCOPE_THREAD
                   ) -> "Substrate":
        """A put and then its flag accumulate at ``flag_offset``, in one K4
        launch.  Ordered (P2), the flag chains behind the payload: put 1 +
        flag phases.  Unordered (Listing 1), the flush between them is the
        launch's grid-wide completion wait: the streams the flush drains are
        waited for first and billed 2 each, as :meth:`flush` bills them."""
        from repro_torch.core.rma import accumulate as _engine

        drained = {} if ordered else self.queues.take(scope, stream)
        for s in drained:
            self._wait(s)
        self.launch_signal(data, perm, offset=offset, flag=flag,
                           flag_offset=flag_offset, flag_op=flag_op,
                           ordered=ordered, stream=stream)
        self.ledger.bill("put", 1 + (0 if _is_static(offset) else 1), shm=shm)
        if not ordered:
            self.ledger.bill("flush", 2 * len(set(drained) | (
                set() if shm else {stream})))
        software = flag_path == _engine.PATH_SOFTWARE
        self.ledger.bill("accumulate", 2 if software else 1, shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self

    def acc_signal(self, data: torch.Tensor, perm: Perm, op: str, *,
                   path: str, offset=0, flag: torch.Tensor, flag_offset: int,
                   flag_op: str, flag_path: str, stream: int = 0,
                   shm: bool = False) -> "Substrate":
        """An ordered accumulate (already routed to ``path``) and its flag
        accumulate in one K6 launch: the update folds straight into the
        target rows, the flag chains behind it.  Billed as the two routed
        accumulates."""
        from repro_torch.core.rma import accumulate as _engine

        self.launch_signal(data, perm, op=op, offset=offset, flag=flag,
                           flag_offset=flag_offset, flag_op=flag_op,
                           stream=stream)
        for p, addr in ((path, 0 if _is_static(offset) else 1), (flag_path, 0)):
            self.ledger.bill("accumulate",
                             (2 if p == _engine.PATH_SOFTWARE else 1) + addr,
                             shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self

    # -- the epoch engine ---------------------------------------------------
    def _wait(self, stream: int) -> None:
        wait_counters(self.counters, [owed[stream] for owed in self.expected],
                      stream=stream, stalls=self.stalls)

    def flush(self, *, scope: str = SCOPE_PROCESS,
              stream: int | None = None) -> "Substrate":
        """``MPI_Win_flush`` (remote completion).  Thread scope (P1) drains
        one stream's queue: one ack round trip (2 phases) and one K3 wait on
        that stream's counters, if it had ops in flight.  Process scope
        walks every pending stream, serialized: one wait each."""
        pending = self.queues.take(scope, stream)
        for s in pending:
            self._wait(s)
        self.ledger.bill("flush", 2 * len(pending))
        return self

    def completion_ok(self) -> bool:
        """Whether every K3 block issued on this family has released its
        completion tick and no flush found a counter short (reads the
        counters: synchronizes with the card)."""
        return (self.counters.cpu().tolist() == self.expected
                and int(self.stalls.item()) == 0)


__all__ = ["SCOPE_PROCESS", "SCOPE_THREAD", "FlushQueues", "PhaseLedger",
           "Substrate"]
