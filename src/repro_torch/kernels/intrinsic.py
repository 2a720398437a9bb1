"""K2 — origin-issued atomic accumulate, the P3 latency path.

The small-count, declared-single-op side of the accumulate crossover
(router: ``repro_torch.core.rma.accumulate``).  Each origin rank folds its
update straight into the target rank's row with hardware atomics — no
staging slot, no work at the target: the paper's "intrinsic to the origin"
accumulate.  Restricted the way NIC atomics are: ops from
``ATOMIC_KERNEL_OPS`` only, one declared op per launch, and a ``config``
(a ``WindowConfig``) is checked against the router so a declaration that
routes elsewhere cannot be lowered here by accident.

The P5 path: the displacement may come from device memory (a per-origin
vector, memory handles), with K3's lifetime guard (a stale handle's update
is dropped and counted at the target), so a handle accumulate routed here
is one launch and the host reads nothing.

Replaces ``repro/kernels/intrinsic.py::ring_accumulate`` (the
``pallas_call`` at ``intrinsic.py:90``).  CUDA source: ``csrc/intrinsic.cu``:
no-return reductions (``red``, four float32 sums in one
``red.global.add.v4.f32`` where aligned), one block for every rank's few
words.  Bound on an H100: one launch (the path carries at most the
crossover's few elements).
"""
from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import (ATOMIC_KERNEL_OPS, DTYPE_CODES,
                                        OP_CODES, LaunchCounter,
                                        check_launch, combine_op, is_integer)
from repro_torch.kernels.rma_put import (_check_address, _row_contiguous,
                                         resolve_rows, shift_targets,
                                         targets_tensor)

COUNTER = LaunchCounter("ring_accumulate")

#: dtypes the atomic kernel covers (the 32/64-bit envelope torch can index)
ATOMIC_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _check(update, buffer, op, offset, config, dynamic=False) -> None:
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
    if update.dim() < 2 or buffer.dim() != update.dim() or \
            update.shape[0] != buffer.shape[0] or \
            update.shape[2:] != buffer.shape[2:]:
        raise ValueError(f"ring_accumulate takes stacked (n, m, ...) update "
                         f"and (n, M, ...) buffer of equal trailing shape, "
                         f"got {tuple(update.shape)} and "
                         f"{tuple(buffer.shape)}")
    m, rows = update.shape[1], buffer.shape[1]
    if m > rows or (not dynamic and not 0 <= offset <= rows - m):
        raise ValueError(
            f"accumulate of {m} elems at offset {offset} "
            f"overruns the {rows}-elem window buffer")


def accumulate_rows_atomic_plain(update, buffer, targets, *, op: str = "sum",
                                 offset: int = 0, disp=None,
                                 disp_unit: int = 1, handles=None, regs=None,
                                 err=None) -> torch.Tensor:
    """The plain PyTorch version of K2: rank r folds ``update[r]`` into
    ``buffer[targets[r], rows:]`` in place, at K3's address rule
    (:func:`~repro_torch.kernels.rma_put.resolve_rows`)."""
    n, m = update.shape[0], update.shape[1]
    _check_address(n, buffer.device, disp, handles, regs, err)
    upd = update.to(buffer.dtype)
    for r, t in enumerate(targets_tensor(targets, n, "cpu").tolist()):
        if t < 0:
            continue
        rows, fresh = resolve_rows(r, t, offset=offset, disp=disp,
                                   disp_unit=disp_unit, handles=handles,
                                   regs=regs, span=buffer.shape[1], m=m)
        if not fresh:
            if err is not None:
                err[t] += 1
            continue
        region = buffer[t, rows:rows + m]
        region.copy_(combine_op(region, upd[r], op))
    return buffer


def accumulate_rows_atomic(update: torch.Tensor, buffer: torch.Tensor,
                           targets, *, op: str = "sum", offset: int = 0,
                           config=None, disp: torch.Tensor | None = None,
                           disp_unit: int = 1,
                           handles: torch.Tensor | None = None,
                           regs: torch.Tensor | None = None,
                           err: torch.Tensor | None = None) -> torch.Tensor:
    """Rank r atomically folds ``update[r]`` into ``buffer[targets[r],
    rows:rows+m]`` (in place; ``targets[r] == -1`` sends nothing).  Stacked
    ``(n, m, ...)`` update into an ``(n, M, ...)`` buffer; ``rows`` follows
    K3's address rule: ``offset`` (static, checked), plus ``disp[r] *
    disp_unit`` and ``handles[r, 1]`` from device memory (clamped to the
    row), and with ``regs`` a stale handle's update is dropped and counted
    in ``err[targets[r]]``.  Returns ``buffer``.  CPU tensors take the plain
    version; CUDA tensors launch K2 or raise."""
    dynamic = disp is not None or handles is not None
    _check(update, buffer, op, offset, config, dynamic)
    if not _common.on_device(update, buffer):
        return accumulate_rows_atomic_plain(
            update, buffer, targets, op=op, offset=offset, disp=disp,
            disp_unit=disp_unit, handles=handles, regs=regs, err=err)
    if buffer.dtype not in ATOMIC_DTYPES:
        raise TypeError(f"no {buffer.dtype} atomics in the envelope")
    if not _row_contiguous(buffer):
        raise ValueError("K2 needs a buffer with contiguous rows")
    n, m = update.shape[0], update.shape[1]
    _check_address(n, buffer.device, disp, handles, regs, err)
    if m == 0:
        return buffer
    upd = update.to(buffer.dtype).contiguous()
    inner = upd[0, 0].numel()
    tgt = targets_tensor(targets, n, buffer.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    fn = _build.lib("intrinsic")
    rc = fn(buffer.data_ptr(), buffer.stride(0), buffer.shape[1], inner,
            offset, upd.data_ptr(), m, tgt.data_ptr(), n,
            DTYPE_CODES[buffer.dtype], OP_CODES[op], ptr(disp), disp_unit,
            ptr(handles), ptr(regs), 0 if regs is None else regs.shape[1],
            ptr(err), _common.stream_ptr(buffer.device))
    check_launch("ring_accumulate", rc)
    COUNTER.bump("guarded" if regs is not None else
                 "device" if dynamic else "static")
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
        update, buffer, shift_targets(n, shift, buffer.device), op=op,
        offset=offset)


__all__ = ["ring_accumulate", "accumulate_rows_atomic",
           "accumulate_rows_atomic_plain", "ATOMIC_DTYPES", "COUNTER"]
