"""K5 — the one-sided ring all-reduce (sum) as one persistent kernel.

Reduce-scatter then all-gather over n stacked ranks: 2(n−1) hops per rank,
each chained behind the previous on release/acquire words — the kernel twin
of the plan's P2-ordered ring (``core.rma.collectives.plan_all_reduce`` with
``order=True``).  It sums in the ring's own order — at hop k rank r adds the
partial of chunk (r−k−1) that rank r−1 holds to its own — so its result is
bit-identical to the op-by-op ring.

Replaces ``repro/kernels/ring_allreduce.py::ring_all_reduce`` (the
``pallas_call`` at ``ring_allreduce.py:108``).  CUDA source:
``csrc/ring_allreduce.cu``.  The ranks are rows of one tensor, so a rank
reads its neighbour's row in place behind the neighbour's ready word: no
landing slot and no credit word.  Each warp is a ring agent that walks its
tiles of every chunk and runs the ring's steps on each tile, all ranks on
the same tiles at once, so a partial is read back out of L2;
:func:`agent_program` is that step program in Python, which
``tests/test_torch_ring.py`` runs under random interleavings.  Bound on an
H100: bytes (one read and one write of x).
"""
from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import LaunchCounter, cdiv, check_launch

COUNTER = LaunchCounter("ring_all_reduce")


def _check_order(config) -> None:
    if config is not None and not config.order:
        raise ValueError(
            "ring_all_reduce is the mpi_win_order=true fast path; the "
            "supplied WindowConfig declares order=False — use "
            "repro_torch.core.rma.plan_all_reduce(order=False) for the "
            "flush-separated baseline")


def ring_all_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K5, in place on the stacked ``(n, L)``
    float32 matrix (``L % n == 0``), summing in the ring's order."""
    n, length = x.shape
    chunk = length // n
    xv = x.view(n, n, chunk)
    ranks = torch.arange(n, device=x.device)
    prev = (ranks - 1) % n
    for k in range(n - 1):
        # rank r receives rank r-1's partial of chunk (r-k-1) and adds its own
        recv_c = (ranks - k - 1) % n
        incoming = xv[prev, recv_c]
        xv[ranks, recv_c] = xv[ranks, recv_c] + incoming
    for k in range(n - 1):
        # rank r forwards chunk (r+1-k) into rank r+1's row
        c = (ranks + 1 - k) % n
        xv[(ranks + 1) % n, c] = xv[ranks, c]
    return x


def agent_program(n: int, chunk: int, tile: int, agents: int, r: int,
                  g: int):
    """The steps agent ``g`` of rank ``r`` runs in ``ring_ar_kernel``, in
    order, over the same words: ``("wait", rank, value)`` — spin until
    ``ready[rank][g] >= value``; ``("add", c, lo, hi, also)`` — row r's
    chunk c += row r−1's over ``[lo, hi)``, and store the sum into row
    ``also`` too when it is not None; ``("copy", c, lo, hi)`` — row r+1's
    chunk c = row r's; ``("release", value)`` — ``ready[r][g] = value``.

    The agent's tiles are g, g + G, ... (G = ``agents``; the kernel's tile
    is 2048 floats).  A tile takes S = 2(n−1) − 1 steps, and step s of the
    agent's j-th tile releases ``j·S + s + 1``; it waits for the
    neighbour's step s − 1 of the same tile, except at step 0, which reads
    only what the neighbour held at the start.  The last reduce-scatter hop
    also stores into the next row: all-gather hop 0, fused."""
    steps = 2 * (n - 1) - 1
    nxt = (r + 1) % n
    for j, t in enumerate(range(g, cdiv(chunk, tile), agents)):
        base = j * steps
        lo, hi = t * tile, min(t * tile + tile, chunk)
        for k in range(n - 1):
            if k > 0:
                yield ("wait", (r - 1) % n, base + k)
            yield ("add", (r - k - 1) % n, lo, hi,
                   nxt if k == n - 2 else None)
            yield ("release", base + k + 1)
        for k in range(1, n - 1):
            s = n - 2 + k
            yield ("wait", (r - 1) % n, base + s)
            yield ("copy", (r + 1 - k) % n, lo, hi)
            yield ("release", base + s + 1)


def _launch(x: torch.Tensor) -> None:
    """Launch K5 on the contiguous ``(n, L)`` matrix ``x``; the kernel
    spreads every block the card holds at once over the n ranks and takes
    one ready word for each of their warps."""
    fn = _build.lib("ring_allreduce")
    n, length = x.shape
    chunk = length // n
    if chunk >= 2**31 - 4:
        raise ValueError(f"K5 takes chunks below 2^31 - 4 floats, got "
                         f"{chunk}")
    # an SM of sm_90 holds at most 64 warps
    words = torch.cuda.get_device_properties(
        x.device).multi_processor_count * 64
    ready = torch.empty(words, dtype=torch.int32, device=x.device)
    rc = fn(x.data_ptr(), length, n, chunk, ready.data_ptr(), words,
            _common.stream_ptr(x.device))
    if rc == -2:
        raise ValueError(f"K5: the card cannot hold a block for each of "
                         f"{n} ranks at once")
    check_launch("ring_all_reduce", rc)
    COUNTER.bump()


def ring_all_reduce(x: torch.Tensor, *, axis_size: int, config=None,
                    inplace: bool = False) -> torch.Tensor:
    """Sum all-reduce over the stacked rank axis: ``x`` is ``(axis_size,
    m, ...)`` float32 (row r = rank r's contribution); every row of the
    result holds the sum.  A row length not divisible by ``axis_size`` is
    padded with zeros (a copy).  ``inplace=True`` reduces into ``x`` when
    no padding is needed, as the gradient ring does with its ``(n, P)``
    matrix.  ``config``: a ``WindowConfig`` that must declare
    ``order=True``.  CPU tensors take the plain version; CUDA tensors launch
    K5 or raise."""
    _check_order(config)
    n = axis_size
    if x.shape[0] != n:
        raise ValueError(f"ring_all_reduce expects {n} stacked rows, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"K5 reduces float32, got {x.dtype}")
    if n == 1:
        return x if inplace else x.clone()
    flat = x.reshape(n, -1)
    length = flat.shape[1]
    pad = (-length) % n
    if pad:
        work = torch.cat([flat, flat.new_zeros((n, pad))], dim=1)
    elif inplace and x.is_contiguous():
        work = flat
    else:
        work = flat.contiguous().clone()
    if _common.on_device(work):
        _launch(work)
    else:
        ring_all_reduce_plain(work)
    if pad:
        out = work[:, :length].reshape(x.shape)
        if inplace:
            x.copy_(out)
            return x
        return out
    return x if work is flat else work.view(x.shape)


__all__ = ["ring_all_reduce", "ring_all_reduce_plain", "agent_program",
           "COUNTER"]
