"""K1 — the tiled accumulate kernel, the P3 bandwidth path (paper §2.3).

Element-wise ``buffer op= update`` for accumulates outside the atomic
envelope (large counts, ops or dtypes no hardware atomic covers).  The
intrinsic (small-count) side of the crossover is K2 in
``repro_torch.kernels.intrinsic``; ``core.rma.accumulate.route`` picks.

Replaces ``repro/kernels/accumulate.py::accumulate`` (the ``pallas_call`` at
``accumulate.py:84``).  CUDA source: ``csrc/accumulate.cu`` — one compiled
kernel per (dtype, op), 16-byte vectors wherever a row's two operands share
their offset from a 16-byte boundary (scalar head and tail), the blocks the
card holds at once walking the rows when both operands fit in L2 and one
block a tile past it; it masks the ragged tail instead of padding it with
the op's identity, updating the buffer in place.  Bound on an H100: bytes
(two reads and one write per element).

``op_identity`` stays: the identity table is part of the accumulate
contract (``test_op_identity_table``) even though the kernel needs no pad.
"""
from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import (ACC_OPS, BITWISE_OPS, DTYPE_CODES,
                                        OP_CODES, LaunchCounter, as_dtype,
                                        check_launch, combine_op,
                                        is_integer)

COUNTER = LaunchCounter("accumulate")


def op_identity(op: str, dtype):
    """The identity element of ``op`` over ``dtype`` (``x op id == x``), or
    ``None`` for ops without one (``replace``)."""
    dt = as_dtype(dtype)
    if op in ("sum", "bor", "bxor"):
        return 0.0 if dt.is_floating_point else 0
    if op == "prod":
        return 1.0 if dt.is_floating_point else 1
    if op in ("min", "max"):
        info = torch.finfo(dt) if dt.is_floating_point else _iinfo(dt)
        return info.max if op == "min" else info.min
    if op == "band":
        return -1 if dt.is_signed else (1 << (8 * dt.itemsize)) - 1
    if op == "replace":
        return None
    raise ValueError(f"op {op!r} not in {ACC_OPS}")


class _IntInfo:
    def __init__(self, dt: torch.dtype):
        bits = 8 * dt.itemsize
        self.min = -(1 << (bits - 1)) if dt.is_signed else 0
        self.max = (1 << (bits - 1)) - 1 if dt.is_signed else (1 << bits) - 1


def _iinfo(dt: torch.dtype):
    try:
        return torch.iinfo(dt)
    except TypeError:  # unsigned widths torch.iinfo does not describe
        return _IntInfo(dt)


def _check(buffer: torch.Tensor, update: torch.Tensor, op: str) -> None:
    if op not in ACC_OPS:
        raise ValueError(f"op {op!r} not in {ACC_OPS}")
    if op in BITWISE_OPS and not is_integer(buffer.dtype):
        raise ValueError(f"bitwise op {op!r} needs an integer buffer, "
                         f"got {buffer.dtype}")
    if buffer.shape != update.shape:
        raise ValueError(f"shape mismatch {tuple(buffer.shape)} vs "
                         f"{tuple(update.shape)}")


def accumulate_plain(buffer: torch.Tensor, update: torch.Tensor, *,
                     op: str = "sum") -> torch.Tensor:
    """The plain PyTorch version of K1: same contract, in place."""
    _check(buffer, update, op)
    buffer.copy_(combine_op(buffer, update.to(buffer.dtype), op))
    return buffer


def accumulate_rows(buffer: torch.Tensor, update: torch.Tensor, *,
                    op: str = "sum") -> torch.Tensor:
    """``buffer op= update`` in place over ``(rows, m)`` operands whose rows
    are each contiguous (``buffer`` may be a column slice of a wider
    window, e.g. ``win[:, off:off+m]``).  Returns ``buffer``.

    CPU tensors take the plain version; CUDA tensors launch K1 or raise."""
    _check(buffer, update, op)
    if not _common.on_device(buffer, update):
        return accumulate_plain(buffer, update, op=op)
    if buffer.dim() != 2 or buffer.stride(1) != 1:
        raise ValueError("K1 needs (rows, m) operands with contiguous rows")
    if buffer.dtype not in DTYPE_CODES:
        raise TypeError(f"K1 does not take dtype {buffer.dtype}")
    if buffer.device != update.device:
        raise ValueError("buffer and update on different devices")
    update = update.to(buffer.dtype).contiguous()
    rows, m = buffer.shape
    if rows == 0 or m == 0:
        return buffer
    fn = _build.lib("accumulate")
    rc = fn(buffer.data_ptr(), buffer.stride(0), update.data_ptr(), m, rows, m,
            DTYPE_CODES[buffer.dtype], OP_CODES[op],
            _common.stream_ptr(buffer.device))
    check_launch("accumulate", rc)
    COUNTER.bump()
    return buffer


def accumulate(buffer: torch.Tensor, update: torch.Tensor, *,
               op: str = "sum") -> torch.Tensor:
    """Element-wise ``buffer op= update`` (1-D, equal shapes), in place;
    returns ``buffer``.  The update is cast to the buffer's dtype."""
    _check(buffer, update, op)
    if buffer.dim() != 1:
        raise ValueError(f"accumulate takes 1-D operands, got "
                         f"{tuple(buffer.shape)}")
    if not _common.on_device(buffer, update):
        return accumulate_plain(buffer, update, op=op)
    if not buffer.is_contiguous():
        raise ValueError("K1 needs a contiguous buffer")
    accumulate_rows(buffer.view(1, -1), update.reshape(1, -1), op=op)
    return buffer


__all__ = ["accumulate", "accumulate_rows", "accumulate_plain", "op_identity",
           "COUNTER"]
