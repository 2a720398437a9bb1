"""Shared kernel vocabulary: the accumulate op table, tiling helpers, the
dtype/op codes the CUDA libraries take, launch counters and the device
dispatch rule every wrapper follows.

The TPU shims of the JAX package (``remote_device_id``, ``sync_copy``,
``interpret_mode``) have no counterpart: on one card a "remote" write is a
store into another rank's row, and a kernel runs only on the card.

Dispatch rule: a wrapper given CPU tensors computes its plain PyTorch
version; given CUDA tensors it launches its kernel or raises — never the
plain version.  Tensors on the ``meta`` device (the dry-run's shape-only
build) take the plain version too, which there carries shapes alone, and
count no launch.
"""
from __future__ import annotations

import torch

#: Ops the atomic (intrinsic-path) kernels implement — the accumulate subset
#: of the hardware envelope (``core.rma.intrinsic.INTRINSIC_OPS`` minus the
#: non-accumulate ``cas``/``no_op`` entries).
ATOMIC_KERNEL_OPS = ("sum", "min", "max", "replace", "band", "bor", "bxor")

#: Every op the tiled kernel implements, in the order of the CUDA op codes.
ACC_OPS = ("sum", "min", "max", "replace", "prod", "band", "bor", "bxor")
BITWISE_OPS = ("band", "bor", "bxor")
OP_CODES = {op: i for i, op in enumerate(ACC_OPS)}

#: torch dtype → the CUDA libraries' dtype code (rt_common.cuh)
DTYPE_CODES = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3,
    torch.int32: 4, torch.int64: 5,
}

_DTYPE_NAMES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES.update({n: getattr(torch, n) for n in ("uint16", "uint32", "uint64")
                     if hasattr(torch, n)})


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a dtype name, or anything numpy
    understands as a dtype (so callers may pass numpy or JAX dtypes)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    else:
        import numpy as np

        name = np.dtype(dtype).name
    if name not in _DTYPE_NAMES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPE_NAMES[name]


def is_integer(dtype) -> bool:
    dt = as_dtype(dtype)
    return not dt.is_floating_point and not dt.is_complex and dt != torch.bool


def combine_op(cur: torch.Tensor, upd: torch.Tensor, op: str) -> torch.Tensor:
    """Element-wise combine — THE accumulate op table, shared by every plain
    version and by ``core.rma.accumulate.apply_op``, so the kernels' twins
    and the transport cannot drift.  ``prod`` is tiled-only (NICs don't
    multiply): ``ATOMIC_KERNEL_OPS`` is the whitelist the atomic kernel
    enforces before reaching here."""
    if op == "sum":
        return cur + upd
    if op == "min":
        return torch.minimum(cur, upd)
    if op == "max":
        return torch.maximum(cur, upd)
    if op == "prod":
        return cur * upd
    if op == "band":
        return cur & upd
    if op == "bor":
        return cur | upd
    if op == "bxor":
        return cur ^ upd
    if op == "replace":
        return upd.clone()
    raise ValueError(f"unsupported accumulate op {op!r}")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


class LaunchCounter:
    """Number of times one kernel was launched on the card.  Each wrapper
    adds one where it launches its kernel and nowhere else, so a run can
    show that its main path went through the kernel.  A kernel built in
    variants names the one it launched: ``by_variant`` splits the count."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.by_variant: dict[str, int] = {}

    def bump(self, variant: str | None = None) -> None:
        self.count += 1
        if variant is not None:
            self.by_variant[variant] = self.by_variant.get(variant, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_variant.clear()


def on_device(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (the wrapper must launch
    its kernel), False when they lie on the CPU or on ``meta`` (the
    wrapper computes its plain version; on ``meta`` that carries shapes
    only).  Mixed placements raise (K3's one exception:
    :func:`host_window`)."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind == "cuda":
        return True
    if kind in ("cpu", "meta"):
        return False
    raise ValueError(f"unsupported device type {kind!r}")


#: observers of a plain version run on ``meta`` (the dry-run's traffic
#: counter, ``launch.dryrun.TrafficMode``): each has ``kernel_enter()`` and
#: ``kernel_exit(operands, results)``
META_KERNEL_OBSERVERS: list = []


def plain(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` — a wrapper's plain version.  On ``meta``
    tensors an active observer sees the call as one kernel, as the card runs
    it: its operands read once and its results written once, none of the
    plain version's temporaries."""
    obs = META_KERNEL_OBSERVERS[-1] if META_KERNEL_OBSERVERS else None
    if obs is None or not any(isinstance(a, torch.Tensor) and a.is_meta
                              for a in args):
        return fn(*args, **kwargs)
    obs.kernel_enter()
    out = None
    try:
        out = fn(*args, **kwargs)
    finally:
        obs.kernel_exit((args, kwargs), out)
    return out


#: pinned host storages K3 reaches at a device-mapped address: storage
#: base -> that address (``kernels.rma_put.map_host`` fills it, once each)
MAPPED_HOST: dict[int, int] = {}


def pinned_host(t: torch.Tensor) -> bool:
    """Whether ``t`` lies in pinned host memory.  Inside a CUDA graph
    capture, which may forbid the pointer query, only a storage already
    mapped for K3 counts."""
    if t.device.type != "cpu":
        return False
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return t.untyped_storage().data_ptr() in MAPPED_HOST
    return t.is_pinned()


def host_window(operands, control) -> bool:
    """K3's exception to :func:`on_device`: True when an operand (a window
    buffer) lies in pinned host memory beside CUDA tensors — the kernel
    then reaches it at its device-mapped address — and every other tensor
    is on the card (else raises).  False when no pinned host operand sits
    beside a CUDA tensor: :func:`on_device` decides, and an unpinned CPU
    operand beside CUDA tensors raises there."""
    everything = (*operands, *control)
    if not any(t.is_cuda for t in everything) or not any(
            pinned_host(t) for t in operands):
        return False
    if not all(t.is_cuda for t in control) or not all(
            t.is_cuda or pinned_host(t) for t in operands):
        raise ValueError(
            "a pinned host window buffer needs every other operand on the "
            f"card, got {[str(t.device) for t in everything]}")
    return True


def check_launch(name: str, rc: int) -> None:
    """Raise on a refused launch (the C entry point's return code)."""
    if rc == -1:
        raise ValueError(f"{name}: the kernel refused its arguments")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with code {rc}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


__all__ = [
    "ATOMIC_KERNEL_OPS", "ACC_OPS", "BITWISE_OPS", "OP_CODES", "DTYPE_CODES",
    "as_dtype", "is_integer", "combine_op", "cdiv", "round_up",
    "LaunchCounter", "on_device", "plain", "META_KERNEL_OBSERVERS",
    "host_window", "pinned_host",
    "MAPPED_HOST", "check_launch",
    "stream_ptr",
]
