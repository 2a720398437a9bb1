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

A per-rank tensor displacement, a memory handle (``memhandle.py``) or a
queried registration (``dynamic.py``) is an address in device memory: K3
and K2 read it on the card (with the handle's lifetime guard), one launch
per layer of the map, and the host reads nothing; such a displacement is
placed as the reference's ``lax.dynamic_update_slice`` places a traced one
(clamped), where a static int that overruns raises.

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
CUDA stream, whose issue order is completion order at the target.  Ordering
*across* windows (a doorbell on a control window behind a data window's
flush epoch) takes a :class:`CompletionToken`: a CUDA event recorded on the
issuing stream, which another stream waits for on the card.  The
substrate is mutable — operations update the buffer in place and return the
substrate, so ``sub = sub.put(...)`` reads like the JAX package's functional
calls.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Sequence

import torch

from repro_torch.kernels.accumulate import accumulate_rows
from repro_torch.kernels.intrinsic import accumulate_rows_atomic
from repro_torch.kernels.ordered_put_signal import (accumulate_signal_rows,
                                                    put_signal_rows)
from repro_torch.kernels.rma_put import (map_host, perm_targets, put_rows,
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
    in-flight operations; ``slot_releases`` counts ``memhandle_release``
    calls per registration slot (the call-time half of the P5 lifetime
    guarantee).  One object per family, aliased by every view, so
    synchronization through one handle completes operations issued through
    all of them."""

    def __init__(self):
        self.pending: dict[int, tuple] = {}
        self.slot_releases: dict[int, int] = {}

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

    def queued_streams(self, scope: str, stream: int | None) -> list[int]:
        """Streams a local-completion point covers (no dequeue): thread
        scope the named stream (and it must name one), process scope every
        pending stream."""
        if scope == SCOPE_THREAD:
            if stream is None:
                raise ValueError(
                    "thread-scope flush_local must name the stream it "
                    "orders (flush_local(stream=...)); a stream-less call "
                    "would silently tie every pending stream together")
            return [stream]
        return list(self.pending)

    def note_release(self, slot: int) -> None:
        self.slot_releases[slot] = self.slot_releases.get(slot, 0) + 1

    def release_count(self, slot: int) -> int:
        return self.slot_releases.get(slot, 0)


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


#: the ledgers of the dup families allocated inside :func:`recorded_ledgers`
#: (None outside it)
_recording: list | None = None


@contextlib.contextmanager
def recorded_ledgers():
    """Collect the phase ledger of every dup family allocated inside the
    ``with`` block, windows a call makes for itself included: the phases
    of everything the block runs, as the JAX package counts the collective
    permutes of a function's lowered program.  Yields the list of ledgers;
    a block nested in another also reports to the outer one."""
    global _recording
    outer, ledgers = _recording, []
    _recording = ledgers
    try:
        yield ledgers
    finally:
        _recording = outer
        if outer is not None:
            outer.extend(ledgers)


@dataclasses.dataclass(frozen=True)
class CompletionToken:
    """A point in a window family's issue order, for ordering work on
    another window behind it (the reference's channel token and its tie).

    It stands for every operation issued on the family before it was taken
    — on its lane and, since every launch goes to one CUDA stream, on the
    others — and, after a flush of the lane, for their completion at the
    target: the flush's wait is itself in that order.  On the card it is a
    CUDA event recorded on the current stream when the token is taken: no
    launch and no host read.  ``event`` is None on the CPU, where every
    operation has completed when its call returns.  A flush whose bounded
    spin gave up counts into the family's stall word and does not block:
    ``stalls`` is that word, and a doorbell ordered behind the token
    (``put_signal(..., after=token)``) reads it on the card and is not
    raised while it is not 0."""

    stream: int
    device: torch.device
    event: "torch.cuda.Event | None" = None
    stalls: "torch.Tensor | None" = dataclasses.field(default=None,
                                                      compare=False)

    def wait(self) -> None:
        """Order what is issued next on the current CUDA stream of the
        token's card behind the token, on the card: no host
        synchronization."""
        if self.event is not None:
            torch.cuda.current_stream(self.device).wait_event(self.event)


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
                 n_streams: int = 1, device=None) -> "Substrate":
        """``device``: where the control state (counters, target maps)
        lives, default the buffer's.  A buffer in pinned host memory may
        sit under control state on the card: K3 then puts into it and reads
        from it at its device-mapped address (checked here, once)."""
        if buffer.dim() < 2 or buffer.shape[0] != axis_size:
            raise ValueError(
                f"a window buffer is the stacked (axis_size={axis_size}, "
                f"...) shards of every rank, got {tuple(buffer.shape)}")
        dev = buffer.device if device is None else torch.device(device)
        if dev.type == buffer.device.type and dev.index in (
                None, buffer.device.index):
            dev = buffer.device
        elif dev.type == "cuda" and buffer.device.type == "cpu" and \
                buffer.is_pinned():
            map_host(buffer)
        else:
            raise ValueError(
                f"a window buffer on {buffer.device} (pinned: "
                f"{buffer.is_pinned()}) cannot sit under control state on "
                f"{dev}: only pinned host memory beside the card")
        counters = torch.zeros((axis_size, n_streams), dtype=torch.int32,
                               device=dev)
        ledger = PhaseLedger()
        if _recording is not None:
            _recording.append(ledger)
        return cls(buffer, axis, axis_size, FlushQueues(), n_streams,
                   counters, [[0] * n_streams for _ in range(axis_size)],
                   torch.zeros(1, dtype=torch.int32, device=dev), ledger,
                   torch.zeros(axis_size + 2, dtype=torch.int32, device=dev))

    @property
    def device(self) -> torch.device:
        """Where the control state lives and the operations' results land:
        the buffer's device, or the card under a pinned host buffer."""
        return self.counters.device

    def token(self, stream: int) -> CompletionToken:
        """The completion token of ``stream`` (see :class:`CompletionToken`):
        on the card an event recorded on the current CUDA stream.  Bills
        nothing."""
        if self.device.type != "cuda":
            return CompletionToken(stream, self.device, stalls=self.stalls)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return CompletionToken(stream, self.device, event, self.stalls)

    # -- helpers ----------------------------------------------------------
    def _launches(self, pairs) -> list:
        """The layers of a map (each sends every origin once: one launch
        each) with their origin lists and target maps on the device, worked
        out once per map."""
        key = ("layers",) + tuple(map(tuple, pairs))
        out = self.targets.get(key)
        if out is None:
            out = self.targets[key] = [
                ([s for s, _ in g], self._targets(g)) for g in _layers(pairs)]
        return out

    def prepare(self, perm: Perm) -> None:
        """Put ``perm``'s target maps, and its inverse's (a read's
        response), on the device now, so that later operations along it
        copy nothing to the card."""
        self._launches(perm)
        self._launches([(t, s) for s, t in perm])

    def _targets(self, pairs) -> torch.Tensor:
        key = tuple(perm_targets(pairs, self.axis_size))
        t = self.targets.get(key)
        if t is None:
            t = targets_tensor(key, self.axis_size, self.device)
            self.targets[key] = t
        return t

    def index(self, ranks) -> torch.Tensor:
        """A list of ranks as a long tensor on the device, built once per
        list (a host-to-device copy) and reused."""
        key = ("index",) + tuple(ranks)
        t = self.targets.get(key)
        if t is None:
            t = self.targets[key] = torch.tensor(
                key[1:], dtype=torch.long).to(self.device)
        return t

    def _payload(self, data: torch.Tensor) -> torch.Tensor:
        if data.shape[0] != self.axis_size:
            raise ValueError(
                f"payloads are stacked per rank: leading dim must be "
                f"{self.axis_size}, got {tuple(data.shape)}")
        return data.to(device=self.device,
                       dtype=self.buffer.dtype).contiguous()

    def _offsets(self, offset, perm: Perm) -> dict[int, int]:
        """origin → displacement on the host (fetch-and-op, compare-and-swap
        and the K4/K6 launches; reads a per-rank tensor back)."""
        if _is_static(offset):
            return {s: offset for s, _ in perm}
        offs = torch.as_tensor(offset).reshape(-1).tolist()
        return {s: int(offs[s]) for s, _ in perm}

    def disp(self, offset) -> torch.Tensor:
        """A per-rank displacement as the kernels read it: int32 ``(n,)``
        on the window's device (no copy when it is already that)."""
        d = torch.as_tensor(offset)
        if d.shape != (self.axis_size,):
            raise ValueError(f"a per-rank displacement has one entry per "
                             f"rank ({self.axis_size},), got "
                             f"{tuple(d.shape)}")
        return d.to(device=self.device, dtype=torch.int32).contiguous()

    def _address(self, offset) -> dict:
        """K3's and K2's address of a window operation: a static int (the
        wrappers check it), or a per-rank tensor read on the card."""
        if _is_static(offset):
            return dict(offset=offset)
        return dict(disp=self.disp(offset))

    def _write_rows(self, src: torch.Tensor, dst: torch.Tensor, perm: Perm,
                    stream: int, **addr) -> None:
        """dst[t] at the address of origin s ← src[s] for (s, t) in perm,
        through K3: one launch per layer of the map (a layer sends each
        origin once).  ``addr`` is K3's address: a static ``offset``, or a
        ``disp`` vector and memory ``handles`` read on the card (the
        guard's ``regs`` and ``err`` with them)."""
        for senders, tmap in self._launches(perm):
            ticks = put_rows(src, dst, tmap, counters=self.counters,
                             stream=stream, **addr)
            for s in senders:
                self.expected[s][stream] += ticks

    def _read_rows(self, perm: Perm, size: int, stream: int,
                   **addr) -> torch.Tensor:
        """The response half of a read at K3's address rule: row s of the
        result is ``size`` rows of target t's window at origin s's address
        (read on the card: a per-origin ``disp``, memory ``handles``, the
        guard's zeros for a stale one); ranks that read nothing get zeros.
        One launch per layer of the inverse map."""
        out = torch.zeros((self.axis_size, size) + tuple(self.buffer.shape[2:]),
                          dtype=self.buffer.dtype, device=self.device)
        for senders, tmap in self._launches([(t, s) for s, t in perm]):
            ticks = put_rows(self.buffer, out, tmap, counters=self.counters,
                             stream=stream, read=True, **addr)
            for t in senders:
                self.expected[t][stream] += ticks
        return out

    def _land(self, data: torch.Tensor, perm: Perm, stream: int
              ) -> torch.Tensor:
        """Ship ``data`` along ``perm`` into a zeroed staging tensor: row t
        holds what its origin sent (non-targets read zeros)."""
        staged = torch.zeros(data.shape, dtype=data.dtype, device=data.device)
        self._write_rows(data, staged, perm, stream)
        return staged

    def rmw_rows(self, data: torch.Tensor, perm: Perm, op: str, *,
                 path: str, stream: int, **addr) -> None:
        """Fold ``data[s]`` into target t's window at origin s's address,
        read on the card (K3's address rule and guard).  ``intrinsic``: one
        K2 launch per layer.  ``tiled``/``software``: K3 reads the target
        regions into a staging tensor by origin, K1 folds the update into
        it, K3 writes it back under the guard — three launches for a
        permutation, and the host reads nothing."""
        from repro_torch.core.rma import accumulate as _engine

        if path == _engine.PATH_INTRINSIC:
            for _, tmap in self._launches(perm):
                accumulate_rows_atomic(data, self.buffer, tmap, op=op, **addr)
            return
        targets = [t for _, t in perm]
        if len(set(targets)) != len(targets):
            raise ValueError(f"perm {tuple(perm)} sends two origins to one "
                             "target: a read-modify-write at a device "
                             "address folds a permutation")
        fetch = {k: v for k, v in addr.items() if k not in ("regs", "err")}
        region = self._read_rows(perm, data.shape[1], stream, **fetch)
        n = self.axis_size
        accumulate_rows(region.view(n, -1), data.reshape(n, -1), op=op)
        self._write_rows(region, self.buffer, perm, stream, **addr)

    # -- transport primitives ---------------------------------------------
    def put(self, data: torch.Tensor, perm: Perm, *, offset=0,
            stream: int = 0, shm: bool = False) -> "Substrate":
        """Origin-addressed write (``MPI_Put``): row t of the window gets
        its origin's payload at the origin's displacement — a static int
        (checked), or a per-rank tensor read on the card and clamped to the
        shard as the reference clamps a traced one.  K3."""
        self._write_rows(self._payload(data), self.buffer, perm, stream,
                         **self._address(offset))
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
            self._write_rows(self._payload(d), self.buffer, perm, stream,
                             offset=off)
        self.ledger.bill("put", 1, shm=shm)
        if not shm:
            self.queues.note_op(stream, perm)
        return self

    def get(self, perm: Perm, *, offset=0, size: int, stream: int = 0,
            shm: bool = False) -> tuple["Substrate", torch.Tensor]:
        """Read (``MPI_Get``): origin s receives ``size`` rows of target t's
        window at the origin's displacement; other ranks read zeros.  The
        response is a K3 put from the target rows."""
        out = self._read_rows(perm, size, stream, **self._address(offset))
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
        a completion ack (2 phases).  A per-rank tensor displacement adds
        its address phase and runs :meth:`rmw_rows` (read on the card,
        clamped)."""
        from repro_torch.core.rma import accumulate as _engine

        data = self._payload(data)
        n, m = self.axis_size, data.shape[1]
        if path == _engine.PATH_INTRINSIC or not _is_static(offset):
            self.rmw_rows(data, perm, op, path=path, stream=stream,
                          **self._address(offset))
        else:
            if not 0 <= offset <= self.buffer.shape[1] - m:
                raise ValueError(f"accumulate of {m} rows at offset "
                                 f"{offset} overruns the window shard")
            flat = self.buffer.reshape(n, -1)
            inner = flat.shape[1] // self.buffer.shape[1]
            staged = self._land(data, perm, stream)
            combine = _engine.path_combine(path, op)
            targets = sorted({t for _, t in perm})
            if targets == list(range(n)) and flat.stride(1) == 1:
                region = flat[:, offset * inner:(offset + m) * inner]
                combine(region, staged.reshape(n, -1))
            else:
                for t in targets:
                    combine(flat[t:t + 1, offset * inner:(offset + m) * inner],
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
        for s, _ in perm:
            if not 0 <= offs[s] <= self.buffer.shape[1] - m:
                raise ValueError(f"read of {m} rows at offset {offs[s]} "
                                 "overruns the window shard")
        old = self._read_rows(perm, m, stream, **self._address(offset))
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
        dev, dt = self.device, self.buffer.dtype
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
                      ordered: bool = True, stream: int = 0,
                      hold: torch.Tensor | None = None) -> None:
        """One K4 (``op=None``: copy) or K6 (fold with ``op``) launch: the
        payload along ``perm``, then its flag words at ``flag_offset`` of
        ``flag_sub``'s window (default: this one).  The payload lands in
        this window at ``offset``, or in ``dst`` (stacked rows, as a
        two-sided send lands) when given.  ``hold`` (K4 only): another
        family's stall word; while it is not 0 the flags are withheld and
        counted in this family's ``stalls``.  Ticks this family's
        completion counters on ``stream``; billing is the caller's."""
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
            ticks = put_signal_rows(data, dst, self._targets(perm),
                                    hold=hold, **common)
        else:
            ticks = accumulate_signal_rows(data, dst, self._targets(perm),
                                           op=op, **common)
        for s, _ in perm:
            self.expected[s][stream] += ticks

    def put_signal(self, data: torch.Tensor, perm: Perm, *, offset=0,
                   flag: torch.Tensor, flag_offset: int, flag_op: str,
                   flag_path: str, stream: int = 0, shm: bool = False,
                   ordered: bool = True, scope: str = SCOPE_THREAD,
                   hold: torch.Tensor | None = None) -> "Substrate":
        """A put and then its flag accumulate at ``flag_offset``, in one K4
        launch.  Ordered (P2), the flag chains behind the payload: put 1 +
        flag phases.  Unordered (Listing 1), the flush between them is the
        launch's grid-wide completion wait: the streams the flush drains are
        waited for first and billed 2 each, as :meth:`flush` bills them.
        ``hold``: the stall word of the family a token orders this behind
        (:meth:`launch_signal`)."""
        from repro_torch.core.rma import accumulate as _engine

        drained = {} if ordered else self.queues.take(scope, stream)
        for s in drained:
            self._wait(s)
        self.launch_signal(data, perm, offset=offset, flag=flag,
                           flag_offset=flag_offset, flag_op=flag_op,
                           ordered=ordered, stream=stream, hold=hold)
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

    def flush_local(self, *, scope: str = SCOPE_PROCESS,
                    stream: int | None = None) -> "Substrate":
        """``MPI_Win_flush_local``: local completion only — no round trip,
        no phase.  The origin's buffers are free to reuse once the launches
        that read them are issued, and one CUDA stream orders them: nothing
        to wait for.  Thread scope must name its stream."""
        self.queues.queued_streams(scope, stream)
        return self

    def fence(self) -> "Substrate":
        """Active-target fence: a collective barrier that completes every
        stream (always process scope).  The reference's token all-reduce is
        no collective-permute, so no phase is billed; on the card it is one
        K3 wait per stream with ops in flight."""
        for s in self.queues.take(SCOPE_PROCESS, None):
            self._wait(s)
        return self

    def completion_ok(self) -> bool:
        """Whether every K3 block issued on this family has released its
        completion tick and no flush found a counter short (reads the
        counters: synchronizes with the card)."""
        return (self.counters.cpu().tolist() == self.expected
                and int(self.stalls.item()) == 0)


__all__ = ["SCOPE_PROCESS", "SCOPE_THREAD", "CompletionToken", "FlushQueues",
           "PhaseLedger", "Substrate", "recorded_ledgers"]
