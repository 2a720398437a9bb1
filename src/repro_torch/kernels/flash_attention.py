"""K7 — flash attention, forward (the prefill hot spot).

Blockwise online-softmax attention on ``(batch, heads, seq, head_dim)``:
float32 running max, denominator and accumulator, causal masking by absolute
position with the finite ``NEG_INF = -2**30``, output ``acc / max(l, 1e-30)``
in the input's dtype.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the
``pallas_call`` at ``flash_attention.py:84``).  CUDA source:
``csrc/flash_attention.cu`` — one CTA per (batch·head, 64-row query tile)
walking 64-key tiles in a loop, skipping the tiles wholly above the causal
diagonal; float32 arithmetic on the CUDA cores.  Bound on an H100:
operations (the bf16 tensor-core peak at the prefill shape).

Heads: ``k``/``v`` may carry fewer heads than ``q`` (GQA); query head ``h``
reads kv head ``h // (H // KV)`` — the expanded call's result, without
expanding.  With equal head counts this is exactly the JAX contract.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import DTYPE_CODES, LaunchCounter, check_launch

NEG_INF = -2.0**30

COUNTER = LaunchCounter("flash_attention")

#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 96, 128)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
           block_kv: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, H, S, D) and equal k/v")
    b, h, sq, hd = q.shape
    kb, kvh, sk, khd = k.shape
    if kb != b or khd != hd or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (batch, head_dim, and kv heads dividing heads)")
    if sq % block_q or sk % block_kv:
        raise ValueError(f"seq {sq}/{sk} not divisible by blocks "
                         f"{block_q}/{block_kv}")


def _expand_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    return t if t.shape[1] == h else t.repeat_interleave(h // t.shape[1], 1)


def flash_attention_plain(q, k, v, *, causal: bool = True, block_q: int = 128,
                          block_kv: int = 128, sm_scale: float | None = None
                          ) -> torch.Tensor:
    """The plain PyTorch version of K7: the TPU kernel's online-softmax
    loop over ``block_kv`` key blocks, every query row at once."""
    _check(q, k, v, block_q, block_kv)
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    k, v = _expand_heads(k, h), _expand_heads(v, h)
    qf = q.float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    m = q.new_full((b, h, sq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, sq), dtype=torch.float32)
    acc = q.new_zeros((b, h, sq, hd), dtype=torch.float32)
    for k0 in range(0, sk, block_kv):
        kb = k[:, :, k0:k0 + block_kv].float()
        vb = v[:, :, k0:k0 + block_kv].float()
        s = qf @ kb.transpose(-1, -2)
        if causal:
            kpos = torch.arange(k0, k0 + block_kv, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, s.new_full((), NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vb
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_kv: int = 128, sm_scale: float | None = None
                    ) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, KV, Sk, D) with KV dividing H → (B, H, S, D).

    ``S``/``Sk`` must divide by ``block_q``/``block_kv`` (the JAX
    contract).  CPU tensors take the plain version; CUDA tensors launch K7
    or raise."""
    _check(q, k, v, block_q, block_kv)
    if not _common.on_device(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, block_q=block_q,
                                     block_kv=block_kv, sm_scale=sm_scale)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K7 takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    b, h, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"K7 is built for head_dim in {HEAD_DIMS}, got {hd}")
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _build.lib("flash_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], sq, k.shape[2], hd, ctypes.c_float(scale),
            int(causal), DTYPE_CODES[q.dtype], _common.stream_ptr(q.device))
    check_launch("flash_attention", rc)
    COUNTER.bump()
    return out


__all__ = ["flash_attention", "flash_attention_plain", "NEG_INF", "COUNTER",
           "HEAD_DIMS"]
