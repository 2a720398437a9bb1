"""K7 — flash attention, forward (the prefill hot spot).

Blockwise online-softmax attention on ``(batch, heads, seq, head_dim)``:
float32 running max, denominator and accumulator, causal masking by absolute
position with the finite ``NEG_INF = -2**30``, output ``acc / max(l, 1e-30)``
in the input's dtype.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the
``pallas_call`` at ``flash_attention.py:84``).  CUDA source:
``csrc/flash_attention.cu``, in two variants picked by dtype:

* ``bf16_wgmma_tma`` (bfloat16): 128 query rows per CTA in two warpgroups,
  Q·Kᵀ and P·V by ``wgmma`` on the tensor cores, the softmax on the
  accumulator registers, P rounded to bfloat16 before P·V (as the JAX
  serving path rounds its weights), K/V tiles of 128 keys through a
  two-stage ring of TMA loads.  It reads q, k, v and writes its output
  through strided views (unit last stride; bases and strides multiples of
  16 bytes, else it raises), so a head-transposed view costs no copy.
* ``f32_simt`` (float32): 64 × 64 tiles in float32 on the CUDA cores —
  float32 inputs must meet the reference's 2e-5, which TF32 does not.

Both skip the kv tiles wholly above the causal diagonal.  Bound on an H100:
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
from repro_torch.kernels.common import LaunchCounter, check_launch

NEG_INF = -2.0**30

#: the C entry point's code for a tensor map cuTensorMapEncodeTiled refused
TMA_REFUSED = -2

COUNTER = LaunchCounter("flash_attention")

#: head dims the CUDA kernels take
HEAD_DIMS = (16, 32, 64, 96, 128)

#: the kernel variant each dtype launches (``COUNTER.by_variant`` keys)
VARIANTS = {torch.bfloat16: "bf16_wgmma_tma", torch.float32: "f32_simt"}


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


def _tma_strides(t: torch.Tensor, what: str) -> list[int]:
    """The (batch, head, seq) element strides of a bf16 (B, heads, S, D)
    operand as the TMA descriptors take them, or raise: a unit last stride,
    and a base and strides that are multiples of 16 bytes.  A dimension of
    extent 1 is never stepped, so its stride is replaced by a valid one."""
    if t.stride(3) != 1:
        raise ValueError(f"K7 {what}: last dim stride {t.stride(3)}, want 1")
    natural = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3],
               t.shape[3])
    strides = [st if n > 1 else nat for st, n, nat in
               zip(t.stride()[:3], t.shape[:3], natural)]
    esz = t.element_size()
    if t.data_ptr() % 16 or any(st * esz % 16 for st in strides):
        raise ValueError(
            f"K7 {what}: TMA needs a base and strides that are multiples of "
            f"16 bytes, got base {t.data_ptr()} (mod 16: {t.data_ptr() % 16})"
            f" and strides {tuple(st * esz for st in strides)} bytes")
    return strides


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_kv: int = 128, sm_scale: float | None = None
                    ) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, KV, Sk, D) with KV dividing H → (B, H, S, D).

    ``S``/``Sk`` must divide by ``block_q``/``block_kv`` (the JAX
    contract; on the card the kernels tile by their own sizes).  CPU
    tensors take the plain version; CUDA tensors launch K7 or raise.  A
    bfloat16 output has q's layout (``empty_like``): for a head-transposed
    view of a (B, S, H, D) tensor, a view of one too."""
    _check(q, k, v, block_q, block_kv)
    if not _common.on_device(q, k, v):
        return _common.plain(flash_attention_plain, q, k, v, causal=causal,
                             block_q=block_q, block_kv=block_kv,
                             sm_scale=sm_scale)
    if q.dtype not in VARIANTS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K7 takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    b, h, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"K7 is built for head_dim in {HEAD_DIMS}, got {hd}")
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    kvh, sk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        out = torch.empty_like(q)
        strides = [st for t, what in ((q, "q"), (k, "k"), (v, "v"),
                                      (out, "out"))
                   for st in _tma_strides(t, what)]
        fn = _build.lib("flash_attention", "rt_flash_attention_bf16")
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                (ctypes.c_int64 * 12)(*strides), b, h, kvh, sq, sk, hd,
                ctypes.c_float(scale), int(causal),
                _common.stream_ptr(q.device))
        if rc == TMA_REFUSED:
            raise RuntimeError("K7: cuTensorMapEncodeTiled refused a tensor "
                               "map")
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = torch.empty_like(q)
        fn = _build.lib("flash_attention")
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                h, kvh, sq, sk, hd, ctypes.c_float(scale), int(causal),
                _common.stream_ptr(q.device))
    check_launch("flash_attention", rc)
    COUNTER.bump(VARIANTS[q.dtype])
    return out


__all__ = ["flash_attention", "flash_attention_plain", "NEG_INF", "COUNTER",
           "HEAD_DIMS", "VARIANTS"]
