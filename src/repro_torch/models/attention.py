"""Attention: GQA (+qk-norm, biases, cross-attention for enc-dec) and MLA
(DeepSeek-V2 multi-head latent attention); full (materialized) and
blockwise (online-softmax over KV blocks) attention for training, and the
KV-cache path for serving — dense and paged caches, prefill through kernel
K7 and decode over the cache.

Shapes (batch B, sequence S, query heads H, kv heads KV, head_dim hd):
weights wq (d, H, hd), wk/wv (d, KV, hd), wo (H, hd, d); activations
(B, S, H, hd); caches k/v (B, S_max, KV, hd), or the paged layout of
``repro_torch.serve.disagg.paginate_cache`` — the JAX package's layouts.
MLA caches the compressed pair (c_kv (B, S_max, kv_lora), k_rope (B, S_max,
qk_rope)) instead; a cross-attention layer caches the encoder's k/v
(B, enc_len, KV, hd).

Where the JAX package returns a new cache, the port writes the given cache
in place (its tensors, ``pos`` included), so a decode step copies no cache.
K7 takes a prefill's attention wherever the prefill computes the same
function as the reference: the prompt's causal self-attention, an
encoder's self-attention and the cross-attention over the encoder output
(non-causal).  MLA's head dims (192 for q and k, 128 for v; 576 and 512
absorbed) are none K7 is built for, so MLA stays torch products, as the
reference's are XLA einsums.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers
from repro_torch.sharding import logical_constraint

NEG_INF = -2.0**30  # large-but-finite: avoids NaNs from (-inf) - (-inf)

#: K7's query tile on the card (the bfloat16 variant's BQ): a prompt longer
#: than this takes a second tile of queries and keys
PREFILL_BLOCK = 128


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


def gqa_spec(cfg) -> dict:
    p = {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv_heads", None),
        "wv": ("embed", "kv_heads", None),
        "wo": ("heads", None, "embed"),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.rmsnorm_spec()
        p["k_norm"] = layers.rmsnorm_spec()
    if cfg.attn_bias:
        p.update({"bq": ("heads", None), "bk": ("kv_heads", None),
                  "bv": ("kv_heads", None), "bo": ("embed",)})
    return p


#: the leaves :func:`gqa_attention` reads cast whole to the compute dtype
#: (the qk-norm scales are read in float32)
GQA_COMPUTE_DTYPE = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv",
                               "bo"})


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


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Attention of a prefill's queries over keys it holds whole, through
    K7: q (B, S, H, hd), k/v (B, Sk, KV, hd) unexpanded → (B, S, H, hd);
    causal for a prompt over its own keys (Sk = S), non-causal for an
    encoder's self-attention or a cross-attention over the encoder output.

    K7 takes the head-transposed views as they are: on the card its
    bfloat16 variant reads them and writes its output through strides (the
    output a view of a (B, S, H, hd) tensor), and rows past S or Sk are
    TMA's zeros and clipped stores, so no pad and no layout copy.  The call
    is one block of the JAX contract (``block_q = S``, ``block_kv = Sk``):
    the plain version on CPU tensors then is the softmax over every key."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          block_q=q.shape[1], block_kv=k.shape[1])
    return out.transpose(1, 2)


def _write_dense(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 cols: torch.Tensor) -> None:
    """``buf[r, cols[r]] = new[r]`` in place (``buf`` (B, S_max, ...),
    ``new`` (B, S, ...)), dropping writes at cols >= S_max as the JAX
    scatter drops them.  A dropped write is aimed at the row's last position
    carrying the value that position ends with, so no two writes to one
    place disagree."""
    B, s_max = buf.shape[:2]
    S = new.shape[1]
    tail = (1,) * (new.dim() - 2)
    rows = torch.arange(B, device=buf.device)
    last = s_max - 1 - pos.long()                    # the write to s_max - 1
    hits_last = (last >= 0) & (last < S)
    fill = torch.where(hits_last.view(B, *tail),
                       new[rows, last.clamp(0, S - 1)].to(buf.dtype),
                       buf[:, s_max - 1])
    valid = (cols < s_max).view(B, S, *tail)
    buf[rows[:, None], cols.clamp(max=s_max - 1)] = torch.where(
        valid, new.to(buf.dtype), fill[:, None])


def _write_paged(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new tokens through the page table into the physical pools in
    place; return each row's gathered logical (B, pages·pt, KV, hd) K and V.

    A write with no page (a row at ``pos == max_seq``), aimed at a
    write-protected shared page (``page_ro``) or at a non-resident page
    (``page_hot``) is dropped, as the JAX scatter drops its out-of-range
    ids: it lands on the parking page carrying the value already there.
    The parking page is the sink of parked rows' writes anyway, and no live
    row reads it."""
    kp, vp, table = cache["k_pages"], cache["v_pages"], cache["page_table"]
    B = table.shape[0]
    park = kp.shape[0] - 1
    pt, ppr = kp.shape[1], table.shape[-1]
    rows = torch.arange(B, device=kp.device)[:, None]
    page_idx = cols // pt
    valid = page_idx < ppr
    phys = table[rows, page_idx.clamp(max=ppr - 1)].long()
    gather_table = table.long()
    if "page_ro" in cache:
        valid &= ~cache["page_ro"][phys]
    if "page_hot" in cache:
        hot = cache["page_hot"]
        valid &= hot[phys]
        gather_table = torch.where(hot[gather_table], gather_table, park)
    dest = torch.where(valid, phys, park)
    in_page = cols % pt
    keep = valid[..., None, None]
    for pool, new in ((kp, k), (vp, v)):
        pool[dest, in_page] = torch.where(keep, new.to(pool.dtype),
                                          pool[park, in_page])
    KV, hd = kp.shape[2], kp.shape[3]
    return (kp[gather_table].reshape(B, -1, KV, hd),
            vp[gather_table].reshape(B, -1, KV, hd))


def _cached_attention(q, k, v, cache: dict, *, prefill: bool) -> torch.Tensor:
    """Write the new k/v at each row's ``pos`` and attend; advances
    ``pos`` in place.  Prefill (rows at position 0) attends over its own
    keys through K7; decode over the whole cache with a masked softmax."""
    B, S, H, hd = q.shape
    pos = cache["pos"]
    cols = pos.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    if "k_pages" in cache:
        ck, cv = _write_paged(cache, k, v, cols)
    else:
        _write_dense(cache["k"], k, pos, cols)
        _write_dense(cache["v"], v, pos, cols)
        ck, cv = cache["k"], cache["v"]
    ck = logical_constraint(ck, "batch", "kv_seq", "kv_heads", None)
    cv = logical_constraint(cv, "batch", "kv_seq", "kv_heads", None)
    pos += S
    if prefill:
        return flash_prefill(q, k, v)
    dt = q.dtype
    KV = ck.shape[2]
    # grouped heads: query head h reads kv head h // (H // KV), unexpanded
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bsgrd,bkgd->bgrsk", qg,
                          ck.to(dt).float()) * hd ** -0.5
    kpos = torch.arange(ck.shape[1], device=q.device)
    mask = cols[:, None, None, :, None] >= kpos
    scores = torch.where(mask, scores, scores.new_full((), NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrsk,bkgd->bsgrd", w.to(dt), cv.to(dt))
    return out.reshape(B, S, H, hd)


def gqa_attention(params: dict, x: torch.Tensor, cfg, *,
                  positions: torch.Tensor, causal: bool = True,
                  cache: dict | None = None, block_kv: int = 1024,
                  prefill: bool = False,
                  kv_input: torch.Tensor | None = None,
                  cross_cached: bool = False) -> torch.Tensor:
    """GQA attention over ``x`` (B, S, d); returns (B, S, d).

    With ``cache``: the serving path — the new k/v are written at each
    row's ``cache['pos']`` (in place) and attended over the cache.
    With ``kv_input``: cross-attention (keys and values from the encoder
    output, no RoPE, no mask); with a cache the prefill memoizes the
    encoder's k/v into it and ``cross_cached=True`` (decode) reads them
    back instead of recomputing them.
    ``prefill=True`` (the model's prefill: rows starting at position 0, no
    gradient) runs the attention through K7: the prompt's causal
    self-attention, an encoder's (``causal=False``, no cache) and the
    cross-attention."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    cross = kv_input is not None
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
    if cross and cross_cached:
        k, v = cache["k"].to(dt), cache["v"].to(dt)
    else:
        src = kv_input if cross else x
        k = torch.einsum("bsd,dhk->bshk", src, params["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bshk", src, params["wv"].to(dt))
        if "bk" in params:
            k = k + params["bk"].to(dt)
            v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        if not (cross and cross_cached):
            k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta and not cross:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    if cache is not None and not cross:
        out = _cached_attention(q, k, v, cache, prefill=prefill)
    elif prefill:
        out = flash_prefill(q, k, v, causal=causal and not cross)
    else:
        kk = _expand_kv(k, H // KV)
        vv = _expand_kv(v, H // KV)
        impl = cfg.attn_impl
        if impl == "auto":
            impl = ("blockwise"
                    if x.shape[1] * kk.shape[1] > cfg.blockwise_threshold
                    and not cross else "full")
        if impl == "blockwise" and not cross:
            out = blockwise_attention(q, kk, vv, causal=causal,
                                      block_kv=block_kv)
        else:
            out = full_attention(q, kk, vv, causal=causal and not cross)
    if cross and cache is not None and not cross_cached:
        if cache["k"].shape[1] != k.shape[1]:
            raise ValueError(
                f"the cross-attention cache holds {cache['k'].shape[1]} "
                f"encoder rows, the encoder gave {k.shape[1]}: make the cache "
                f"with init_cache(..., enc_len={k.shape[1]})")
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    out = logical_constraint(out, "batch", "seq", "heads", None)
    proj = torch.einsum("bshk,hkd->bsd", out.to(dt), params["wo"].to(dt))
    if "bo" in params:
        proj = proj + params["bo"].to(dt)
    return proj


def init_gqa_cache(cfg, batch: int, max_seq: int, dtype, device) -> dict:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_seq, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, KV, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def gqa_cache_spec(cfg) -> dict:
    return {
        "k": ("batch", "kv_seq", "kv_heads", None),
        "v": ("batch", "kv_seq", "kv_heads", None),
        "pos": ("batch",),
    }


def init_paged_gqa_cache(cfg, batch: int, max_seq: int, dtype, device,
                         page_tokens: int) -> dict:
    """Paged-layout GQA cache: a physical page pool (plus the parking page)
    and a per-row page table, built by ``serve.disagg.paginate_cache`` — the
    one definition of the layout."""
    from repro_torch.serve.disagg import paginate_cache

    return paginate_cache(init_gqa_cache(cfg, batch, max_seq, dtype, device),
                          page_tokens)


# -- MLA — multi-head latent attention (DeepSeek-V2) ------------------------------

def init_mla(gen, cfg, device) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    pd = cfg.parameter_dtype
    return {
        "w_dq": layers.trunc_normal(gen, (d, m.q_lora), 1.0, pd, device),
        "q_norm": layers.init_rmsnorm(m.q_lora, pd, device),
        "w_uq": layers.trunc_normal(gen, (m.q_lora, H, m.qk_nope + m.qk_rope),
                                    1.0, pd, device),
        "w_dkv": layers.trunc_normal(gen, (d, m.kv_lora), 1.0, pd, device),
        "kv_norm": layers.init_rmsnorm(m.kv_lora, pd, device),
        "w_kr": layers.trunc_normal(gen, (d, m.qk_rope), 1.0, pd, device),
        "w_uk": layers.trunc_normal(gen, (m.kv_lora, H, m.qk_nope), 1.0, pd,
                                    device),
        "w_uv": layers.trunc_normal(gen, (m.kv_lora, H, m.v_head), 1.0, pd,
                                    device),
        "wo": layers.trunc_normal(gen, (H, m.v_head, d), 1.0, pd, device),
    }


def mla_spec(cfg) -> dict:
    return {
        "w_dq": ("embed", "q_lora"),
        "q_norm": layers.rmsnorm_spec(),
        "w_uq": ("q_lora", "heads", None),
        "w_dkv": ("embed", "kv_lora"),
        "kv_norm": layers.rmsnorm_spec(),
        "w_kr": ("embed", None),
        "w_uk": ("kv_lora", "heads", None),
        "w_uv": ("kv_lora", "heads", None),
        "wo": ("heads", None, "embed"),
    }


#: the leaves :func:`mla_attention` reads cast whole to the compute dtype
#: (the two norms' scales are read in float32)
MLA_COMPUTE_DTYPE = frozenset({"w_dq", "w_uq", "w_dkv", "w_kr", "w_uk",
                               "w_uv", "wo"})


def mla_attention(params: dict, x: torch.Tensor, cfg, *,
                  positions: torch.Tensor, cache: dict | None = None,
                  prefill: bool = False) -> torch.Tensor:
    """DeepSeek-V2 multi-head latent attention over ``x`` (B, S, d);
    returns (B, S, d).

    The cache stores only (c_kv: kv_lora, k_rope: qk_rope) a token, written
    at each row's ``pos`` in place.  Scores take the absorbed-weight form,
    ``q_nope·(W_uk c) + q_rope·k_rope``: q is projected through W_uk once,
    the scores and softmax are float32, and the weights, cast back to the
    activation dtype, attend in the latent space before one expansion by
    W_uv — the reference's products and casts in its order.  A prefill
    (rows at position 0) attends over the prompt's own latents: its causal
    mask leaves no other cache row a weight, as in the reference's masked
    softmax over the whole cache."""
    m = cfg.mla
    B, S, _ = x.shape
    dt = x.dtype
    cq = layers.rms_norm(torch.einsum("bsd,dr->bsr", x, params["w_dq"].to(dt)),
                         params["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"].to(dt))
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = layers.rms_norm(
        torch.einsum("bsd,dr->bsr", x, params["w_dkv"].to(dt)),
        params["kv_norm"], cfg.norm_eps)
    k_rope = torch.einsum("bsd,dr->bsr", x, params["w_kr"].to(dt))
    k_rope = layers.apply_rope(k_rope[:, :, None, :], positions,
                               cfg.rope_theta)[:, :, 0]
    qpos = torch.arange(S, device=x.device)[None, :]            # (1, S)
    if cache is not None:
        pos = cache["pos"]
        cols = pos.long()[:, None] + qpos
        _write_dense(cache["c_kv"], c_kv, pos, cols)
        _write_dense(cache["k_rope"], k_rope, pos, cols)
        pos += S
        if not prefill:
            c_kv, k_rope = cache["c_kv"].to(dt), cache["k_rope"].to(dt)
            qpos = cols
    # absorbed weights: the cache stays compressed, no per-token K expansion
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"].to(dt))
    s_lat = torch.einsum("bshr,btr->bhst", q_lat.float(), c_kv.float())
    s_rope = torch.einsum("bshk,btk->bhst", q_rope.float(), k_rope.float())
    scores = (s_lat + s_rope) * (m.qk_nope + m.qk_rope) ** -0.5
    kpos = torch.arange(c_kv.shape[1], device=x.device)
    mask = qpos[:, None, :, None] >= kpos                       # (B|1,1,S,K)
    scores = torch.where(mask, scores, scores.new_full((), NEG_INF))
    w = torch.softmax(scores, dim=-1)
    # attend in the latent space, then expand once: out_h = (w·c) @ W_uv
    ctx = torch.einsum("bhst,btr->bshr", w.to(dt), c_kv)
    out = torch.einsum("bshr,rhv->bshv", ctx, params["w_uv"].to(dt))
    out = logical_constraint(out, "batch", "seq", "heads", None)
    return torch.einsum("bshv,hvd->bsd", out, params["wo"].to(dt))


def init_mla_cache(cfg, batch: int, max_seq: int, dtype, device) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_seq, m.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_seq, m.qk_rope), dtype=dtype,
                              device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_cache_spec(cfg) -> dict:
    return {
        "c_kv": ("batch", "kv_seq", "kv_lora"),
        "k_rope": ("batch", "kv_seq", None),
        "pos": ("batch",),
    }


__all__ = ["init_gqa", "gqa_spec", "gqa_attention", "full_attention",
           "blockwise_attention", "flash_prefill", "init_gqa_cache",
           "gqa_cache_spec", "init_paged_gqa_cache", "init_mla", "mla_spec",
           "mla_attention", "init_mla_cache", "mla_cache_spec",
           "PREFILL_BLOCK", "GQA_COMPUTE_DTYPE", "MLA_COMPUTE_DTYPE"]
