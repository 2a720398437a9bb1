"""K5 — the one-sided ring all-reduce (sum) as one persistent kernel.

Reduce-scatter then all-gather over n stacked ranks: 2(n−1) hops per rank,
each chained behind the previous on release/acquire flag words, with a
double-buffered landing slot and a credit word back to the previous rank —
the kernel twin of the plan's P2-ordered ring
(``core.rma.collectives.plan_all_reduce`` with ``order=True``).  It sums in
the ring's own order — at hop k rank r adds the incoming partial of chunk
(r−k−1) to its own — so its result is bit-identical to the op-by-op ring.

Replaces ``repro/kernels/ring_allreduce.py::ring_all_reduce`` (the
``pallas_call`` at ``ring_allreduce.py:108``).  CUDA source:
``csrc/ring_allreduce.cu``: n × B co-resident blocks (cooperative launch,
n·B ≤ the SM count), block (r, b) acting for rank r on column slice b.
Bound on an H100: bytes.
"""
from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import LaunchCounter, cdiv, check_launch

COUNTER = LaunchCounter("ring_all_reduce")

_THREADS = 512   # kThreads in csrc/ring_allreduce.cu


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


def _launch(x: torch.Tensor) -> None:
    fn = _build.lib("ring_allreduce")
    n, length = x.shape
    chunk = length // n
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if n > sms:
        raise ValueError(f"K5 needs n <= {sms} co-resident ranks, got {n}")
    blocks = max(1, min(sms // n, cdiv(chunk, 4 * _THREADS)))
    landing = torch.empty((n, 2, chunk), dtype=torch.float32, device=x.device)
    flags = torch.empty((2, n, blocks), dtype=torch.int32, device=x.device)
    rc = fn(x.data_ptr(), length, n, chunk, landing.data_ptr(),
            flags.data_ptr(), blocks, _common.stream_ptr(x.device))
    if rc == -2:
        raise RuntimeError(f"K5: {n * blocks} blocks cannot all be resident")
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


__all__ = ["ring_all_reduce", "ring_all_reduce_plain", "COUNTER"]
