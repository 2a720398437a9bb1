"""Precision of the plain references: float32 with TF32 off, and the
control's lower precision.

The configurations compute in bfloat16, so the control is the same
reference with every product's operands rounded to float8 (e4m3, one scale
per tensor: its largest magnitude maps to 448) before a float32 product —
the step down a later change would be tempted to take.  Rounding passes the
gradient straight through, so a control's backward differentiates the
rounded forward."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Products in true float32 (no TF32), restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32; the gradient passes straight through."""
    with torch.no_grad():
        amax = t.detach().abs().amax().float().clamp(min=1e-30)
        scale = FP8_MAX / amax
        r = (t.detach().float() * scale).to(torch.float8_e4m3fn).float() \
            / scale
    return t + (r - t.detach())


PRECISIONS = {"float32": identity, "fp8": fp8}


def mm(a: torch.Tensor, b: torch.Tensor, q=identity) -> torch.Tensor:
    """``a @ b`` in float32 with both operands through ``q``."""
    return q(a.float()) @ q(b.float())
