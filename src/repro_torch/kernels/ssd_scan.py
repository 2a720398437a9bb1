"""K8 — the Mamba2 SSD intra-chunk kernel (the SSM prefill hot spot).

The chunked SSD algorithm splits into a quadratic *intra-chunk* part (this
kernel) and a cheap linear *inter-chunk* recurrence (``kernels.ops.ssd_scan``,
the glue).  Per (batch, chunk) and head it computes the cumsum of the
log-decays ``a``, the dual matrix C·Bᵀ (chunk × chunk), the causal decays
exp(cum_i − cum_j) masked to i ≥ j *before* the exp, ``y_intra`` = (C·Bᵀ ∘
L_h)·x_h and the chunk's input state x_hᵀ·(B ∘ exp(cum_last − cum)).

Replaces ``repro/kernels/ssd_scan.py::ssd_intra_chunk`` (the ``pallas_call``
at ``ssd_scan.py:62``, body ``_ssd_kernel``).  CUDA source:
``csrc/ssd_scan.cu`` — one CTA per (batch, chunk, group of heads), C·Bᵀ
computed once per group into shared memory and never written out, float32
arithmetic on the CUDA cores.  Bound on an H100: bytes (the float32 states
are most of them).

Shapes the kernel takes (the JAX kernel test's and the model's): chunk ≤ 64,
d_state N ≤ 128, headdim P ≤ 64, and L a multiple of the chunk; the wrapper
raises outside them, on either device.  It has no backward: on the card an
input that requires grad raises (SSM training is ROADMAP item 11).
"""
from __future__ import annotations

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import DTYPE_CODES, LaunchCounter, check_launch

COUNTER = LaunchCounter("ssd_intra_chunk")

#: the largest chunk, d_state and headdim the CUDA kernel's tiles hold
MAX_CHUNK, MAX_STATE, MAX_HEADDIM = 64, 128, 64


def _check(xdt, a, Bm, Cm, chunk: int, nheads: int, headdim: int) -> None:
    if xdt.dim() != 3 or a.dim() != 3 or Bm.dim() != 3 or \
            Cm.shape != Bm.shape:
        raise ValueError(f"xdt {tuple(xdt.shape)}, a {tuple(a.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}: want (B, "
                         "L, H·P), (B, L, H) and two equal (B, L, N)")
    b, length, hp = xdt.shape
    if hp != nheads * headdim or tuple(a.shape) != (b, length, nheads) or \
            tuple(Bm.shape[:2]) != (b, length):
        raise ValueError(f"shapes do not fit nheads={nheads}, headdim="
                         f"{headdim}: xdt {tuple(xdt.shape)}, a "
                         f"{tuple(a.shape)}, Bm {tuple(Bm.shape)}")
    if length % chunk:
        raise ValueError(f"L={length} is not a multiple of chunk={chunk} "
                         "(kernels.ops.ssd_scan pads it)")
    n = Bm.shape[-1]
    if not (1 <= chunk <= MAX_CHUNK and 1 <= n <= MAX_STATE
            and 1 <= headdim <= MAX_HEADDIM):
        raise ValueError(f"K8 takes chunk <= {MAX_CHUNK}, d_state <= "
                         f"{MAX_STATE} and headdim <= {MAX_HEADDIM}; got "
                         f"chunk={chunk}, d_state={n}, headdim={headdim}")


def ssd_intra_chunk_plain(xdt, a, Bm, Cm, *, chunk: int, nheads: int,
                          headdim: int):
    """The plain PyTorch version of K8, every chunk and head at once."""
    b, length, hp = xdt.shape
    n, h, p = Bm.shape[-1], nheads, headdim
    nc = length // chunk
    x = xdt.reshape(b, nc, chunk, h, p).float()
    cum = torch.cumsum(a.reshape(b, nc, chunk, h).float(), dim=2)
    Bc = Bm.reshape(b, nc, chunk, n).float()
    Cc = Cm.reshape(b, nc, chunk, n).float()
    CB = Cc @ Bc.transpose(-1, -2)                            # (b, c, i, j)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xdt.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b, c, i, j, h)
    # mask BEFORE exp: exp of a positive (i < j) difference overflows to
    # inf, and inf * 0 = NaN
    Lij = torch.exp(torch.where(tri[:, :, None], diff,
                                diff.new_full((), float("-inf"))))
    y = torch.einsum("bcijh,bcjhp->bcihp", CB[..., None] * Lij, x)
    decay = torch.exp(cum[:, :, -1:, :] - cum)                # (b, c, j, h)
    st = torch.einsum("bcjhp,bcjhn->bchpn", x,
                      Bc[:, :, :, None, :] * decay[..., None])
    return (y.reshape(b, length, hp).to(xdt.dtype),
            st.reshape(b, nc, hp, n), cum.reshape(b, length, h))


def ssd_intra_chunk(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, *, chunk: int, nheads: int,
                    headdim: int):
    """xdt (B, L, H·P), a (B, L, H), Bm/Cm (B, L, N) →
    y_intra (B, L, H·P) in xdt's dtype, states (B, nc, H·P, N) float32,
    cum (B, L, H) float32.

    CPU tensors take the plain version; CUDA tensors launch K8 or raise."""
    _check(xdt, a, Bm, Cm, chunk, nheads, headdim)
    if not _common.on_device(xdt, a, Bm, Cm):
        return ssd_intra_chunk_plain(xdt, a, Bm, Cm, chunk=chunk,
                                     nheads=nheads, headdim=headdim)
    if any(t.requires_grad for t in (xdt, a, Bm, Cm)):
        raise NotImplementedError(
            "K8 (ssd_intra_chunk) has no backward kernel: SSM training on "
            "the card is not ported yet (ROADMAP queue 1, item 11)")
    if xdt.dtype not in (torch.float32, torch.bfloat16) or \
            Bm.dtype != xdt.dtype or Cm.dtype != xdt.dtype or \
            not a.dtype.is_floating_point:
        raise TypeError(f"K8 takes float32 or bfloat16 xdt/Bm/Cm of one "
                        f"dtype and a floating a, got {xdt.dtype}/"
                        f"{Bm.dtype}/{Cm.dtype}, a {a.dtype}")
    b, length, hp = xdt.shape
    n = Bm.shape[-1]
    nc = length // chunk
    xdt, Bm, Cm = xdt.contiguous(), Bm.contiguous(), Cm.contiguous()
    a = a.float().contiguous()
    y = torch.empty_like(xdt)
    st = torch.empty((b, nc, hp, n), dtype=torch.float32, device=xdt.device)
    cum = torch.empty((b, length, nheads), dtype=torch.float32,
                      device=xdt.device)
    fn = _build.lib("ssd_scan")
    rc = fn(xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), st.data_ptr(), cum.data_ptr(), b, nc, chunk,
            nheads, headdim, n, DTYPE_CODES[xdt.dtype],
            _common.stream_ptr(xdt.device))
    check_launch("ssd_intra_chunk", rc)
    COUNTER.bump()
    return y, st, cum


__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_plain", "COUNTER",
           "MAX_CHUNK", "MAX_STATE", "MAX_HEADDIM"]
