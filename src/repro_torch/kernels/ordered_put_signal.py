"""K4 put+signal and K6 accumulate+signal — a payload and its doorbell in one
launch (paper Listings 1 and 2, P2).

Every origin rank moves its payload into a target rank's row of a stacked
``(n, ...)`` window — K4 copies it, K6 folds it in with one op of the atomic
set — and then raises its flag words in the target's flag row with the
window's declared op.  ``ordered=True`` (P2) chains the flag behind the
payload with no grid-wide wait; ``ordered=False`` is the Listing-1 shape, in
which every flag waits for every payload of the launch to complete.

Replaces ``repro/kernels/ordered_put_signal.py::put_signal`` (K4, the
``pallas_call`` at ``ordered_put_signal.py:72``) and ``::accumulate_signal``
(K6, at ``ordered_put_signal.py:144``).  CUDA source: ``csrc/put_signal.cu``.
Bound on an H100: bytes (the payload read and written once; K6 also reads
the target region), plus a few flag words.

The substrate lowers ``put_signal``/``accumulate_signal`` and the plan's
chained data+doorbell pairs (the all-to-all's per-peer sends and combine
hops) to :func:`put_signal_rows` and :func:`accumulate_signal_rows`.
"""
from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import (ATOMIC_KERNEL_OPS, BITWISE_OPS,
                                        DTYPE_CODES, OP_CODES, LaunchCounter,
                                        cdiv, check_launch, combine_op,
                                        is_integer)
from repro_torch.kernels.rma_put import _row_contiguous, targets_tensor

PUT_COUNTER = LaunchCounter("put_signal")
ACC_COUNTER = LaunchCounter("accumulate_signal")

#: flag words one launch raises at most (csrc/put_signal.cu)
MAX_FLAG_WORDS = 1024


def _offsets(offset, n: int) -> list[int]:
    """One displacement per origin, from an int or a per-rank sequence."""
    if isinstance(offset, int) and not isinstance(offset, bool):
        return [offset] * n
    offs = torch.as_tensor(offset).reshape(-1).tolist()
    if len(offs) != n:
        raise ValueError(f"per-rank offsets need {n} entries, got {len(offs)}")
    return [int(o) for o in offs]


def _check(src, dst, targets, offsets, flag, flag_dst, flag_offset,
           flag_op, *, cast: bool = False) -> None:
    """Shapes, dtypes and bounds of one launch.  A target map given as a
    host sequence is checked against the window too; one already on the
    card was built by the substrate from a checked permutation."""
    if src.dim() < 2 or dst.dim() != src.dim() or src.shape[2:] != dst.shape[2:]:
        raise ValueError(f"payloads are stacked (n, m, ...) with the "
                         f"window's trailing shape, got {tuple(src.shape)} -> "
                         f"{tuple(dst.shape)}")
    if src.dtype != dst.dtype and not cast:
        raise TypeError(f"payload {src.dtype} into a {dst.dtype} window")
    n, m = src.shape[0], src.shape[1]
    for r, off in enumerate(offsets):
        if not 0 <= off <= dst.shape[1] - m:
            raise ValueError(f"payload of {m} rows at offset {off} (rank {r}) "
                             f"overruns the {dst.shape[1]}-row window shard")
    if not (isinstance(targets, torch.Tensor) and targets.is_cuda):
        tgt = targets_tensor(targets, n, "cpu").tolist()
        for r, t in enumerate(tgt):
            if not -1 <= t < dst.shape[0]:
                raise ValueError(f"rank {r} targets row {t} of a "
                                 f"{dst.shape[0]}-rank window")
        sent = [t for t in tgt if t >= 0]
        if len(set(sent)) != len(sent):
            raise ValueError(f"targets {tgt} send two origins to one rank: "
                             "one launch moves a permutation")
    if flag.dim() != 2 or flag.shape[0] != n or flag_dst.dim() != 2:
        raise ValueError(f"flags are stacked (n, words) into (n, F) flag "
                         f"rows, got {tuple(flag.shape)} -> "
                         f"{tuple(flag_dst.shape)}")
    fw = flag.shape[1]
    if not 1 <= fw <= MAX_FLAG_WORDS or \
            not 0 <= flag_offset <= flag_dst.shape[1] - fw:
        raise ValueError(f"{fw} flag words at offset {flag_offset} overrun "
                         f"the {flag_dst.shape[1]}-word flag row")
    if flag_op not in ATOMIC_KERNEL_OPS:
        raise ValueError(f"flag op {flag_op!r} not in {ATOMIC_KERNEL_OPS}")
    if flag_op in BITWISE_OPS and not is_integer(flag_dst.dtype):
        raise ValueError(f"bitwise flag op {flag_op!r} needs integer flag "
                         f"words, got {flag_dst.dtype}")


def _host_targets(targets, n: int) -> list[int]:
    return targets_tensor(targets, n, "cpu").tolist()


def _raise_flags_plain(flag, flag_dst, tgt, flag_offset, flag_op) -> None:
    fw = flag.shape[1]
    words = flag.to(flag_dst.dtype)
    for r, t in enumerate(tgt):
        if t >= 0:
            region = flag_dst[t, flag_offset:flag_offset + fw]
            region.copy_(combine_op(region, words[r], flag_op))


def _tick_plain(counters, tgt, stream) -> None:
    if counters is not None:
        for r, t in enumerate(tgt):
            if t >= 0:
                counters[r, stream] += 1


def put_signal_rows_plain(src, dst, targets, *, flag, flag_dst, offset=0,
                          flag_offset: int = 0, flag_op: str = "sum",
                          ordered: bool = True, counters=None,
                          stream: int = 0, stalls=None, check=None,
                          scratch=None, hold=None) -> int:
    """The plain PyTorch version of K4: same contract, copying by element.
    In check mode ``check[0]`` gains the payload elements that differ from
    what their origin sent (0 here: the plain version runs in program
    order)."""
    del ordered, scratch
    offs = _offsets(offset, src.shape[0])
    _check(src, dst, targets, offs, flag, flag_dst, flag_offset, flag_op)
    tgt = _host_targets(targets, src.shape[0])
    m = src.shape[1]
    for r, t in enumerate(tgt):
        if t >= 0:
            dst[t, offs[r]:offs[r] + m] = src[r]
    if hold is not None and int(hold.reshape(-1)[0]) != 0:
        if stalls is not None:              # one withheld flag per origin
            stalls += sum(t >= 0 for t in tgt)
    else:
        _raise_flags_plain(flag, flag_dst, tgt, flag_offset, flag_op)
    _tick_plain(counters, tgt, stream)
    if check is not None:
        for r, t in enumerate(tgt):
            if t >= 0:
                got = dst[t, offs[r]:offs[r] + m]
                check += (got != src[r]).sum().to(check.dtype)
    return 1


def _launch_setup(src, dst, counters, offs, targets, device):
    n = src.shape[0]
    if not (_row_contiguous(src) and _row_contiguous(dst)):
        raise ValueError("K4/K6 need operands whose rows are contiguous")
    if counters is not None and (counters.shape[0] != n or
                                 counters.dtype != torch.int32 or
                                 not counters.is_contiguous() or
                                 counters.device != device):
        raise ValueError("counters must be a contiguous (n, streams) int32 "
                         "tensor on the payload's device")
    offs_t = None
    if len(set(offs)) > 1:
        offs_t = torch.tensor(offs, dtype=torch.int64).to(device)
    return targets_tensor(targets, n, device), offs_t


def _flag_args(flag, flag_dst):
    if flag_dst.stride(1) != 1:
        raise ValueError("flag rows must be contiguous")
    words = flag.to(device=flag_dst.device, dtype=flag_dst.dtype).contiguous()
    return words, DTYPE_CODES[flag_dst.dtype]


def _blocks(units: int, n: int, cooperative: bool) -> int:
    """Blocks per origin: about 1024 units a block, at most 512 blocks in
    all — 264 (two per SM) when every block must be resident at once."""
    cap = (264 if cooperative else 512) // n
    return max(1, min(cdiv(units, 1024), cap))


def _scratch(scratch, n: int, device) -> torch.Tensor:
    """The launch's arrival counters: the caller's (zero, and left at zero
    by every launch), or fresh ones."""
    if scratch is None:
        return torch.zeros(n + 2, dtype=torch.int32, device=device)
    if scratch.shape != (n + 2,) or scratch.dtype != torch.int32 or \
            scratch.device != device:
        raise ValueError(f"scratch must be ({n + 2},) int32 on {device}")
    return scratch


def copy_unit(src: torch.Tensor, dst: torch.Tensor, offset=0) -> int:
    """The bytes K4 moves per load/store for this payload and window: the
    widest of 16, 8, 4, 2, 1 that divides both addresses, the payload
    row, both row strides and every displacement."""
    es = src.element_size()
    inner = 1
    for d in src.shape[2:]:
        inner *= d
    sizes = [src.data_ptr(), dst.data_ptr(), src.shape[1] * inner * es,
             src.stride(0) * es, dst.stride(0) * es]
    sizes += [o * inner * es for o in _offsets(offset, src.shape[0])]
    return next(u for u in (16, 8, 4, 2, 1) if all(v % u == 0 for v in sizes))


def put_signal_rows(src: torch.Tensor, dst: torch.Tensor, targets, *,
                    flag: torch.Tensor, flag_dst: torch.Tensor, offset=0,
                    flag_offset: int = 0, flag_op: str = "sum",
                    ordered: bool = True,
                    counters: torch.Tensor | None = None, stream: int = 0,
                    stalls: torch.Tensor | None = None,
                    check: torch.Tensor | None = None,
                    scratch: torch.Tensor | None = None,
                    hold: torch.Tensor | None = None) -> int:
    """For every rank r with ``targets[r] >= 0``: ``dst[t, off_r:off_r+m] =
    src[r]`` (``off_r`` = ``offset``, or ``offset[r]`` per rank), then —
    behind that payload — ``flag_dst[t, flag_offset:+f] = flag_op(...,
    flag[r])``.  ``ordered=False`` makes every flag wait for every payload
    of the launch (Listing 1).  ``hold`` (a stall word, int32, on the flag
    rows' device): while it is not 0 the payloads land but every flag stays
    as it is, and ``stalls[0]`` gains one per flag withheld — a doorbell
    ordered behind a flush that gave up is not raised.  With ``counters``,
    each payload block adds one to ``counters[r, stream]``; returns those
    ticks per sending rank.
    ``check`` (a (1,) int32 tensor, K4's check mode): the launch — the
    same instance and launch mode as without it — gains one consumer block
    per origin, which spins on the origin's first flag word (4-byte flag
    dtypes, zero before the launch) and adds the copy units
    (:func:`copy_unit`) read behind it that differ from what was sent.
    ``scratch``: ``(n + 2,)`` int32 zeros the launch may use and leaves at
    zero (launches sharing one run in stream order); fresh when omitted.
    CPU tensors take the plain version; CUDA tensors launch K4 or raise."""
    n = src.shape[0]
    offs = _offsets(offset, n)
    _check(src, dst, targets, offs, flag, flag_dst, flag_offset, flag_op)
    if not _common.on_device(src, dst, flag_dst):
        return put_signal_rows_plain(
            src, dst, targets, flag=flag, flag_dst=flag_dst, offset=offset,
            flag_offset=flag_offset, flag_op=flag_op, ordered=ordered,
            counters=counters, stream=stream, stalls=stalls, check=check,
            hold=hold)
    if hold is not None and (hold.dtype != torch.int32 or
                             hold.device != flag_dst.device):
        raise ValueError(f"hold must be an int32 word on {flag_dst.device}, "
                         f"got {hold.dtype} on {hold.device}")
    tgt, offs_t = _launch_setup(src, dst, counters, offs, targets, src.device)
    words, fcode = _flag_args(flag, flag_dst)
    es = src.element_size()
    inner = 1
    for d in src.shape[2:]:
        inner *= d
    unit = copy_unit(src, dst, offs)
    m_u = src.shape[1] * inner * es // unit
    blocks = _blocks(m_u, n, not ordered)
    scratch = _scratch(scratch, n, src.device)
    if check is not None and (check.shape != (1,) or
                              check.dtype != torch.int32):
        raise ValueError("check must be a (1,) int32 tensor")
    if offs_t is not None:
        offs_t = offs_t * (inner * es // unit)      # rows -> units
    fn = _build.lib("put_signal")
    rc = fn(src.data_ptr(), src.stride(0) * es // unit, dst.data_ptr(),
            dst.stride(0) * es // unit,
            offs[0] * inner * es // unit if offs_t is None else 0,
            None if offs_t is None else offs_t.data_ptr(),
            tgt.data_ptr(), n, m_u, unit, words.data_ptr(), words.stride(0),
            flag_dst.data_ptr(), flag_dst.stride(0), flag_offset,
            words.shape[1], fcode, OP_CODES[flag_op], scratch.data_ptr(),
            None if counters is None else counters.data_ptr(),
            1 if counters is None else counters.shape[1],
            stream if counters is not None else 0, blocks, int(ordered),
            None if check is None else check.data_ptr(),
            None if stalls is None else stalls.data_ptr(),
            None if hold is None else hold.data_ptr(),
            _common.stream_ptr(src.device))
    check_launch("put_signal", rc)
    PUT_COUNTER.bump()
    return blocks


def _check_fold(update, buffer, op) -> None:
    if op not in ATOMIC_KERNEL_OPS:
        raise ValueError(f"op {op!r} not in {ATOMIC_KERNEL_OPS} (the fused "
                         "kernel signals on the atomic path)")
    if op in BITWISE_OPS and not is_integer(buffer.dtype):
        raise ValueError(f"bitwise op {op!r} needs an integer buffer, "
                         f"got {buffer.dtype}")


def accumulate_signal_rows_plain(update, buffer, targets, *, op: str = "sum",
                                 flag, flag_dst, offset=0,
                                 flag_offset: int = 0, flag_op: str = "sum",
                                 ordered: bool = True, counters=None,
                                 stream: int = 0, stalls=None,
                                 scratch=None) -> int:
    """The plain PyTorch version of K6: same contract."""
    del ordered, stalls, scratch
    _check_fold(update, buffer, op)
    upd = update.to(buffer.dtype)
    offs = _offsets(offset, upd.shape[0])
    _check(upd, buffer, targets, offs, flag, flag_dst, flag_offset, flag_op)
    tgt = _host_targets(targets, upd.shape[0])
    m = upd.shape[1]
    for r, t in enumerate(tgt):
        if t >= 0:
            region = buffer[t, offs[r]:offs[r] + m]
            region.copy_(combine_op(region, upd[r], op))
    _raise_flags_plain(flag, flag_dst, tgt, flag_offset, flag_op)
    _tick_plain(counters, tgt, stream)
    return 1


def accumulate_signal_rows(update: torch.Tensor, buffer: torch.Tensor,
                           targets, *, op: str = "sum", flag: torch.Tensor,
                           flag_dst: torch.Tensor, offset=0,
                           flag_offset: int = 0, flag_op: str = "sum",
                           ordered: bool = True,
                           counters: torch.Tensor | None = None,
                           stream: int = 0,
                           stalls: torch.Tensor | None = None,
                           scratch: torch.Tensor | None = None) -> int:
    """For every rank r with ``targets[r] >= 0``: fold ``update[r]`` into
    ``buffer[t, off_r:off_r+m]`` with ``op`` (in place; the update is cast
    to the buffer's dtype), then raise the flag words as
    :func:`put_signal_rows` does.  ``op`` must be in ``ATOMIC_KERNEL_OPS``
    and a bitwise op needs an integer buffer.  Returns the completion ticks
    per sending rank; ``scratch`` as for :func:`put_signal_rows`.  CPU tensors take the plain version; CUDA tensors
    launch K6 or raise."""
    _check_fold(update, buffer, op)
    n = update.shape[0]
    offs = _offsets(offset, n)
    _check(update, buffer, targets, offs, flag, flag_dst, flag_offset,
           flag_op, cast=True)
    if not _common.on_device(update, buffer, flag_dst):
        return accumulate_signal_rows_plain(
            update, buffer, targets, op=op, flag=flag, flag_dst=flag_dst,
            offset=offset, flag_offset=flag_offset, flag_op=flag_op,
            ordered=ordered, counters=counters, stream=stream, stalls=stalls,
            scratch=scratch)
    if buffer.dtype not in DTYPE_CODES:
        raise TypeError(f"K6 does not fold {buffer.dtype}")
    upd = update.to(buffer.dtype).contiguous()
    tgt, offs_t = _launch_setup(upd, buffer, counters, offs, targets,
                                buffer.device)
    words, fcode = _flag_args(flag, flag_dst)
    inner = 1
    for d in upd.shape[2:]:
        inner *= d
    m = upd.shape[1] * inner
    blocks = _blocks(m, n, not ordered)
    scratch = _scratch(scratch, n, buffer.device)
    if offs_t is not None:
        offs_t = offs_t * inner                     # rows -> elements
    fn = _build.lib("put_signal", "rt_accumulate_signal")
    rc = fn(upd.data_ptr(), upd.stride(0), buffer.data_ptr(),
            buffer.stride(0), offs[0] * inner if offs_t is None else 0,
            None if offs_t is None else offs_t.data_ptr(),
            tgt.data_ptr(), n, m, DTYPE_CODES[buffer.dtype], OP_CODES[op],
            words.data_ptr(), words.stride(0), flag_dst.data_ptr(),
            flag_dst.stride(0), flag_offset, words.shape[1], fcode,
            OP_CODES[flag_op], scratch.data_ptr(),
            None if counters is None else counters.data_ptr(),
            1 if counters is None else counters.shape[1],
            stream if counters is not None else 0, blocks, int(ordered),
            None if stalls is None else stalls.data_ptr(),
            _common.stream_ptr(buffer.device))
    check_launch("accumulate_signal", rc)
    ACC_COUNTER.bump()
    return blocks


def _ring(n: int, shift: int) -> list[int]:
    return [(r + shift) % n for r in range(n)]


def put_signal(x: torch.Tensor, flag: torch.Tensor, *, axis_size: int,
               shift: int = 1, ordered: bool = True, config=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ring put of the stacked ``x`` plus a flag word per rank; returns
    ``(received, received_flag)`` — row r holds what rank r−shift sent.
    ``config``: a ``WindowConfig`` whose ``order`` selects the path, as the
    JAX kernel's ``config=`` does."""
    n = axis_size
    if config is not None:
        ordered = config.order
    if x.shape[0] != n or flag.shape[0] != n:
        raise ValueError(f"put_signal expects {n} stacked shards and flags")
    if x.dim() == 1:
        got, gflag = put_signal(x.view(n, 1), flag, axis_size=n, shift=shift,
                                ordered=ordered)
        return got.view(n), gflag
    x = x.contiguous()
    f2 = flag.reshape(n, -1)
    out = torch.empty_like(x)
    oflag = torch.zeros_like(f2)
    put_signal_rows(x, out, _ring(n, shift), flag=f2, flag_dst=oflag,
                    flag_op="replace", ordered=ordered)
    return out, oflag.view(flag.shape)


def accumulate_signal(update: torch.Tensor, buffer: torch.Tensor,
                      flag: torch.Tensor, *, axis_size: int, shift: int = 1,
                      op: str = "sum", offset: int = 0, ordered: bool = True,
                      config=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank folds its ``update`` row into its ring neighbour's
    ``buffer`` row at ``offset`` with ``op`` and raises its flag there.
    Returns ``(updated_buffer, received_flag)`` (``buffer`` is not
    modified)."""
    n = axis_size
    _check_fold(update, buffer, op)
    if config is not None:
        ordered = config.order
    out = buffer.clone()
    f2 = flag.reshape(n, -1)
    oflag = torch.zeros_like(f2)
    accumulate_signal_rows(update, out, _ring(n, shift), op=op, flag=f2,
                           flag_dst=oflag, offset=offset, flag_op="replace",
                           ordered=ordered)
    return out, oflag.view(flag.shape)


__all__ = ["put_signal", "accumulate_signal", "put_signal_rows",
           "put_signal_rows_plain", "accumulate_signal_rows",
           "accumulate_signal_rows_plain", "PUT_COUNTER", "ACC_COUNTER",
           "MAX_FLAG_WORDS", "copy_unit"]
