"""GQA attention, train/prefill path: full (materialized) and blockwise
(online-softmax over KV blocks) attention, and the GQA layer without caches.

Shapes (batch B, sequence S, query heads H, kv heads KV, head_dim hd):
weights wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d); activations
(B, S, H, hd) — the JAX package's layout.  The decode path, paged caches and
MLA arrive with serving and the other families (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers

NEG_INF = -2.0**30  # large-but-finite: avoids NaNs from (-inf) - (-inf)


def init_gqa(gen, cfg, device) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.parameter_dtype
    p = {
        "wq": layers.trunc_normal(gen, (d, H, hd), 1.0, pd, device),
        "wk": layers.trunc_normal(gen, (d, KV, hd), 1.0, pd, device),
        "wv": layers.trunc_normal(gen, (d, KV, hd), 1.0, pd, device),
        "wo": layers.trunc_normal(gen, (H, hd, d), 1.0, pd, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(hd, pd, device)
        p["k_norm"] = layers.init_rmsnorm(hd, pd, device)
    if cfg.attn_bias:
        p["bq"] = torch.zeros((H, hd), dtype=pd, device=device)
        p["bk"] = torch.zeros((KV, hd), dtype=pd, device=device)
        p["bv"] = torch.zeros((KV, hd), dtype=pd, device=device)
        p["bo"] = torch.zeros((d,), dtype=pd, device=device)
    return p


def _expand_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat KV heads to match query heads, (B,S,KV,hd)->(B,S,KV*rep,hd)."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def _causal_mask(sq: int, sk: int, q_offset: int, device, k0: int = 0):
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device) + k0
    return qpos[:, None] >= kpos[None, :]


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Materialized-scores attention (small sequences / oracle)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, q.device)
        scores = torch.where(mask[None, None], scores,
                             scores.new_full((), NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def blockwise_attention(q, k, v, *, causal: bool, block_kv: int = 1024,
                        q_offset: int = 0):
    """Online-softmax attention over KV blocks: O(S·block) memory."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sk % block_kv != 0:
        return full_attention(q, k, v, causal=causal, q_offset=q_offset)
    qf = q.float() * hd ** -0.5
    m = q.new_full((b, h, sq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, sq), dtype=torch.float32)
    acc = q.new_zeros((b, h, sq, hd), dtype=torch.float32)
    for blk in range(sk // block_kv):
        kblk = k[:, blk * block_kv:(blk + 1) * block_kv].float()
        vblk = v[:, blk * block_kv:(blk + 1) * block_kv].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk)
        if causal:
            mask = _causal_mask(sq, block_kv, q_offset, q.device,
                                k0=blk * block_kv)
            s = torch.where(mask[None, None], s, s.new_full((), NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def gqa_attention(params: dict, x: torch.Tensor, cfg, *,
                  positions: torch.Tensor, causal: bool = True,
                  block_kv: int = 1024) -> torch.Tensor:
    """GQA self-attention over ``x`` (B, S, d); returns (B, S, d)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    kk = _expand_kv(k, H // KV)
    vv = _expand_kv(v, H // KV)
    impl = cfg.attn_impl
    if impl == "auto":
        impl = ("blockwise" if x.shape[1] * kk.shape[1] > cfg.blockwise_threshold
                else "full")
    if impl == "blockwise":
        out = blockwise_attention(q, kk, vv, causal=causal, block_kv=block_kv)
    else:
        out = full_attention(q, kk, vv, causal=causal)
    proj = torch.einsum("bshk,hkd->bsd", out.to(dt), params["wo"].to(dt))
    if "bo" in params:
        proj = proj + params["bo"].to(dt)
    return proj


__all__ = ["init_gqa", "gqa_attention", "full_attention",
           "blockwise_attention"]
