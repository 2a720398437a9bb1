"""K2 — origin-issued atomic accumulate, the P3 latency path.

The small-count, declared-single-op side of the accumulate crossover
(router: ``repro_torch.core.rma.accumulate``).  Each origin rank folds its
update straight into the target rank's row with hardware atomics — no
staging slot, no work at the target: the paper's "intrinsic to the origin"
accumulate.  Restricted the way NIC atomics are: ops from
``ATOMIC_KERNEL_OPS`` only, one declared op per launch, and a ``config``
(a ``WindowConfig``) is checked against the router so a declaration that
routes elsewhere cannot be lowered here by accident.

Replaces ``repro/kernels/intrinsic.py::ring_accumulate`` (the
``pallas_call`` at ``intrinsic.py:90``).  CUDA source: ``csrc/intrinsic.cu``.
Bound on an H100: launch and atomic latency (the path carries at most the
crossover's few elements).
"""
from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import (ATOMIC_KERNEL_OPS, DTYPE_CODES,
                                        OP_CODES, LaunchCounter,
                                        check_launch, combine_op, is_integer)
from repro_torch.kernels.rma_put import targets_tensor

COUNTER = LaunchCounter("ring_accumulate")

#: dtypes the atomic kernel covers (the 32/64-bit envelope torch can index)
ATOMIC_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _check(update, buffer, op, offset, config) -> None:
    if op not in ATOMIC_KERNEL_OPS:
        raise ValueError(f"op {op!r} not in {ATOMIC_KERNEL_OPS} (NIC "
                         "atomics; route other ops to repro_torch.kernels."
                         "accumulate)")
    if op in ("band", "bor", "bxor") and not is_integer(buffer.dtype):
        raise ValueError(f"bitwise op {op!r} needs an integer buffer, "
                         f"got {buffer.dtype}")
    if config is not None:
        from repro_torch.core.rma import accumulate as _engine

        path = _engine.route(op, update[0].numel(), update.dtype, config)
        if path != _engine.PATH_INTRINSIC:
            raise ValueError(
                f"declared usage routes this accumulate to the {path!r} "
                "path; the atomic kernel only lowers intrinsic-routed "
                "configurations (declared single-op, count <= crossover)")
    if update.dim() != 2 or buffer.dim() != 2 or \
            update.shape[0] != buffer.shape[0]:
        raise ValueError(f"ring_accumulate takes stacked (n, m) update and "
                         f"(n, M) buffer, got {tuple(update.shape)} and "
                         f"{tuple(buffer.shape)}")
    if update.shape[1] + offset > buffer.shape[1] or offset < 0:
        raise ValueError(
            f"accumulate of {update.shape[1]} elems at offset {offset} "
            f"overruns the {buffer.shape[1]}-elem window buffer")


def accumulate_rows_atomic_plain(update, buffer, targets, *, op: str = "sum",
                                 offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K2: rank r folds ``update[r]`` into
    ``buffer[targets[r], offset:]`` in place."""
    m = update.shape[1]
    upd = update.to(buffer.dtype)
    for r, t in enumerate(targets_tensor(targets, update.shape[0],
                                         "cpu").tolist()):
        if t >= 0:
            region = buffer[t, offset:offset + m]
            region.copy_(combine_op(region, upd[r], op))
    return buffer


def accumulate_rows_atomic(update: torch.Tensor, buffer: torch.Tensor,
                           targets, *, op: str = "sum", offset: int = 0,
                           config=None) -> torch.Tensor:
    """Rank r atomically folds ``update[r]`` into ``buffer[targets[r],
    offset:offset+m]`` (in place; ``targets[r] == -1`` sends nothing).
    Returns ``buffer``.  CPU tensors take the plain version; CUDA tensors
    launch K2 or raise."""
    _check(update, buffer, op, offset, config)
    if not _common.on_device(update, buffer):
        return accumulate_rows_atomic_plain(update, buffer, targets, op=op,
                                            offset=offset)
    if buffer.dtype not in ATOMIC_DTYPES:
        raise TypeError(f"no {buffer.dtype} atomics in the envelope")
    if buffer.stride(1) != 1:
        raise ValueError("K2 needs a buffer with contiguous rows")
    n, m = update.shape
    if m == 0:
        return buffer
    upd = update.to(buffer.dtype).contiguous()
    tgt = targets_tensor(targets, n, buffer.device)
    fn = _build.lib("intrinsic")
    rc = fn(buffer.data_ptr(), buffer.stride(0), offset, upd.data_ptr(), m,
            tgt.data_ptr(), n, DTYPE_CODES[buffer.dtype], OP_CODES[op],
            _common.stream_ptr(buffer.device))
    check_launch("ring_accumulate", rc)
    COUNTER.bump()
    return buffer


def ring_accumulate(update: torch.Tensor, buffer: torch.Tensor, *,
                    axis_size: int, shift: int = 1, op: str = "sum",
                    offset: int = 0, config=None) -> torch.Tensor:
    """Every rank atomically accumulates its ``update`` row into its ring
    neighbour's ``buffer`` row at ``offset``.  Stacked layout: ``update``
    (n, m), ``buffer`` (n, M).  Updates ``buffer`` in place and returns it
    (row r = what rank r's window holds after its neighbour's atomic)."""
    n = axis_size
    _check(update, buffer, op, offset, config)
    return accumulate_rows_atomic(
        update, buffer, [(r + shift) % n for r in range(n)], op=op,
        offset=offset)


__all__ = ["ring_accumulate", "accumulate_rows_atomic",
           "accumulate_rows_atomic_plain", "ATOMIC_DTYPES", "COUNTER"]
