"""K3 — one-sided put with thread-scope completion (P1).

Every origin rank writes its shard into a target rank's row of a stacked
``(n, ...)`` window; each write bumps the origin's per-(rank, stream)
completion counter.  The substrate lowers put, send, ring hops and the
response half of get to :func:`put_rows`.  Its flush of one stream is
:func:`wait_counters`: a launch that waits, on the card, for that stream's
counters to reach what its puts owe — one column of counters, never a
device-wide synchronisation.

Replaces ``repro/kernels/rma_put.py::ring_put`` (the ``pallas_call`` at
``rma_put.py:47``; ``rdma.start()`` is the put, ``rdma.wait()`` the flush).
CUDA source: ``csrc/rma_put.cu``.  Bound on an H100: bytes (one read and
one write of the payload, in 16-byte words where the layout allows); the
wait reads 4 bytes per rank and is bound by its launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import LaunchCounter, cdiv, check_launch

COUNTER = LaunchCounter("ring_put")
WAIT_COUNTER = LaunchCounter("put_wait")

#: ranks one wait launch can cover (RT_MAX_WAIT_RANKS in csrc/rma_put.cu)
MAX_WAIT_RANKS = 256


def targets_tensor(targets, n: int, device) -> torch.Tensor:
    """``targets`` as the kernel takes it: int32 of length n, -1 where a
    rank sends nothing."""
    if isinstance(targets, torch.Tensor):
        t = targets
    else:
        t = torch.tensor(list(targets), dtype=torch.int32)
    if t.shape != (n,):
        raise ValueError(f"targets must have length {n}, got {tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int32)   # no copy if already there


def perm_targets(perm, n: int) -> list[int]:
    """The origin → target map of a permutation given as (src, tgt) pairs."""
    out = [-1] * n
    for s, t in perm:
        if out[s] != -1:
            raise ValueError(f"rank {s} appears twice as an origin in {perm}")
        out[s] = t
    return out


def _row_contiguous(x: torch.Tensor) -> bool:
    expect = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _check(src, dst, offset: int) -> None:
    if src.dim() < 2 or dst.dim() != src.dim() or src.shape[2:] != dst.shape[2:]:
        raise ValueError(f"put needs stacked (n, m, ...) operands of equal "
                         f"trailing shape, got {tuple(src.shape)} -> "
                         f"{tuple(dst.shape)}")
    if src.dtype != dst.dtype:
        raise TypeError(f"put payload {src.dtype} into a {dst.dtype} window")
    if not 0 <= offset <= dst.shape[1] - src.shape[1]:
        raise ValueError(f"put of {src.shape[1]} rows at offset {offset} "
                         f"overruns the {dst.shape[1]}-row window shard")


def put_rows_plain(src, dst, targets, *, offset: int = 0, counters=None,
                   stream: int = 0) -> int:
    """The plain PyTorch version of K3: same contract.  Returns the
    completion ticks each sending rank added to its counter (1)."""
    _check(src, dst, offset)
    m = src.shape[1]
    for r, t in enumerate(targets_tensor(targets, src.shape[0], "cpu").tolist()):
        if t >= 0:
            dst[t, offset:offset + m] = src[r]
            if counters is not None:
                counters[r, stream] += 1
    return 1


def put_rows(src: torch.Tensor, dst: torch.Tensor, targets, *,
             offset: int = 0, counters: torch.Tensor | None = None,
             stream: int = 0) -> int:
    """For every rank r with ``targets[r] >= 0``: ``dst[targets[r],
    offset:offset+m] = src[r]``, then add to ``counters[r, stream]``.

    Returns the ticks each sending rank's counter gained (the number of
    blocks that wrote its row), so a caller can tell when a stream's puts
    have all completed.  CPU tensors take the plain version; CUDA tensors
    launch K3 or raise."""
    _check(src, dst, offset)
    if not _common.on_device(src, dst):
        return put_rows_plain(src, dst, targets, offset=offset,
                              counters=counters, stream=stream)
    if not (_row_contiguous(src) and _row_contiguous(dst)):
        raise ValueError("K3 needs operands whose rows are contiguous")
    n, m = src.shape[0], src.shape[1]
    if m == 0:
        return 0
    if counters is None:
        counters = torch.zeros((n, 1), dtype=torch.int32, device=src.device)
        stream = 0
    if counters.shape[0] != n or counters.dtype != torch.int32 or \
            not counters.is_contiguous() or counters.device != src.device:
        raise ValueError("counters must be a contiguous (n, streams) int32 "
                         "tensor on the payload's device")
    tgt = targets_tensor(targets, n, src.device)
    es = src.element_size()
    inner = 1
    for d in src.shape[2:]:
        inner *= d
    row_b, off_b = m * inner * es, offset * inner * es
    src_b, dst_b = src.stride(0) * es, dst.stride(0) * es
    unit = next(u for u in (16, 8, 4, 2, 1)
                if all(v % u == 0 for v in (src.data_ptr(), dst.data_ptr(),
                                            row_b, off_b, src_b, dst_b)))
    m_u = row_b // unit
    blocks = max(1, min(cdiv(m_u, 1024), 512 // n))
    fn = _build.lib("rma_put")
    rc = fn(src.data_ptr(), src_b // unit, dst.data_ptr(), dst_b // unit,
            off_b // unit, tgt.data_ptr(), n, m_u, unit, counters.data_ptr(),
            counters.shape[1], stream, blocks, _common.stream_ptr(src.device))
    check_launch("ring_put", rc)
    COUNTER.bump()
    return blocks


def _check_wait(counters, owed, stream: int, stalls) -> None:
    n = counters.shape[0] if counters.dim() == 2 else -1
    if n < 1 or counters.dtype != torch.int32 or len(owed) != n:
        raise ValueError(f"counters must be (n, streams) int32 with one owed "
                         f"count per rank, got {tuple(counters.shape)} "
                         f"{counters.dtype} and {len(owed)} counts")
    if not 0 <= stream < counters.shape[1]:
        raise ValueError(f"stream {stream} outside the counters' "
                         f"{counters.shape[1]} streams")
    if stalls.shape != (1,) or stalls.dtype != torch.int32:
        raise ValueError("stalls must be a (1,) int32 tensor")


def wait_counters_plain(counters, owed, *, stream: int, stalls) -> None:
    """The plain PyTorch version of the wait: adds to ``stalls[0]`` the
    ranks whose counter ``(r, stream)`` has not reached ``owed[r]`` (modulo
    2^32, as the kernel compares)."""
    _check_wait(counters, owed, stream, stalls)
    want = torch.tensor([o & 0xFFFFFFFF for o in owed], dtype=torch.int64,
                        device=counters.device)
    short = (counters[:, stream].long() - want) % 2**32 >= 2**31
    stalls += short.sum().to(torch.int32)


def wait_counters(counters: torch.Tensor, owed, *, stream: int,
                  stalls: torch.Tensor) -> None:
    """Thread-scope completion of one stream: wait until every rank r's
    counter ``(r, stream)`` has reached ``owed[r]``, the ticks its issued
    puts owe.  On the card the wait is a launch on the current stream that
    spins on those counters only; a count still short after a bounded spin
    adds one to ``stalls[0]`` instead of hanging.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    _check_wait(counters, owed, stream, stalls)
    if not _common.on_device(counters, stalls):
        wait_counters_plain(counters, owed, stream=stream, stalls=stalls)
        return
    n = counters.shape[0]
    if n > MAX_WAIT_RANKS or not counters.is_contiguous():
        raise ValueError(f"the wait kernel covers at most {MAX_WAIT_RANKS} "
                         f"ranks of contiguous counters, got {n}")
    fn = _build.lib("rma_put", "rt_put_wait")
    words = (ctypes.c_uint32 * n)(*(o & 0xFFFFFFFF for o in owed))
    rc = fn(counters.data_ptr(), n, counters.shape[1], stream, words,
            stalls.data_ptr(), _common.stream_ptr(counters.device))
    check_launch("put_wait", rc)
    WAIT_COUNTER.bump()


def ring_put(x: torch.Tensor, *, axis_size: int, shift: int = 1
             ) -> torch.Tensor:
    """Every rank puts its shard into its ring neighbour's window; returns
    the stacked received buffers (row r = what rank r-shift put into rank
    r's window).  ``x`` is the stacked ``(axis_size, ...)`` shards."""
    n = axis_size
    if x.shape[0] != n:
        raise ValueError(f"ring_put expects {n} stacked shards, got "
                         f"{tuple(x.shape)}")
    if x.dim() == 1:
        return ring_put(x.view(n, 1), axis_size=n, shift=shift).view(n)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    put_rows(x, out, [(r + shift) % n for r in range(n)])
    return out


__all__ = ["ring_put", "put_rows", "put_rows_plain", "wait_counters",
           "wait_counters_plain", "perm_targets", "targets_tensor", "COUNTER",
           "WAIT_COUNTER", "MAX_WAIT_RANKS"]
