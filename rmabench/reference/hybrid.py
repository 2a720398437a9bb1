"""Plain float32 reference of a hybrid Mamba2 / attention / MoE decoder's
forward (the Jamba block, arXiv:2403.19887, with the port's Mamba2 mixer).

One sequence at a time, full length, no cache: embedding; per layer a
pre-RMSNorm mixer — a Mamba2 SSD block (fused input projection into z, x,
B, C and dt; causal depthwise convolution with bias; SiLU; dt = softplus(dt
+ dt_bias); A = -exp(A_log); the scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t
B_t^T, y_t = h_t C_t + D x_t; a gate by SiLU(z); RMSNorm; the output
projection) or causal GQA attention (query head h reads key/value head
h // (H / KV), no positional encoding) — then a pre-RMSNorm SwiGLU FFN or
a top-k MoE of SwiGLU experts (softmax router in float32, the top k gates
renormalized, every routed token computed: no capacity); a final RMSNorm
and the head.  The layer kinds are read from the parameter tree.  The scan
is chunked (quadratic inside a chunk, a recurrence across chunks), all in
float32 unless ``q`` rounds the products' operands.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rmabench.reference.dense import blocks
from rmabench.reference.numerics import identity, mm

#: rows of queries attended at once
Q_BLOCK = 1024


def rmsnorm(x, p, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * p["scale"]


def ssd(xdt, a, B, C, chunk: int):
    """y (L, H, P) of the scan over xdt (L, H, P), a (L, H), B/C (L, N),
    from a zero state."""
    L, H, P = xdt.shape
    N = B.shape[-1]
    pad = (-L) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    x = xdt.view(nc, chunk, H, P)
    cum = torch.cumsum(a.view(nc, chunk, H), dim=1)            # (c, i, H)
    Bc, Cc = B.view(nc, chunk, N), C.view(nc, chunk, N)
    # inside a chunk: y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x_j
    diff = cum[:, :, None, :] - cum[:, None, :, :]              # (c, i, j, H)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=xdt.device).tril()[None, :, :, None]
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("cin,cjn->cij", Cc, Bc)
    y = torch.einsum("cijh,cjhp->cihp", cb[..., None] * decay, x)
    # across chunks: the state entering each chunk
    to_end = torch.exp(cum[:, -1:, :] - cum)                    # (c, j, H)
    contrib = torch.einsum("cjn,cjhp->chpn", Bc, x * to_end[..., None])
    state = x.new_zeros(H, P, N)
    states = []
    for c in range(nc):
        states.append(state)
        state = state * torch.exp(cum[c, -1])[:, None, None] + contrib[c]
    entering = torch.stack(states)                              # (c, H, P, N)
    y = y + torch.einsum("cin,chpn->cihp", Cc, entering) \
        * torch.exp(cum)[..., None]
    return y.reshape(nc * chunk, H, P)[:L]


def mamba(x, p, cfg, q=identity):
    s = cfg["ssm"]
    L, d = x.shape
    d_inner = s["expand"] * d
    H, P, N = d_inner // s["headdim"], s["headdim"], s["d_state"]
    h = mm(x, p["in_proj"], q)
    z, xbc, dt = (h[:, :d_inner], h[:, d_inner:2 * d_inner + 2 * N],
                  h[:, 2 * d_inner + 2 * N:])
    K = p["conv_w"].shape[1]
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[k:k + L] * p["conv_w"][:, k] for k in range(K))
    xbc = F.silu(conv + p["conv_b"])
    xs, Bm, Cm = xbc[:, :d_inner], xbc[:, d_inner:d_inner + N], \
        xbc[:, d_inner + N:]
    dt = F.softplus(dt + p["dt_bias"])                          # (L, H)
    a = dt * -torch.exp(p["A_log"])
    xh = xs.reshape(L, H, P)
    y = ssd(q(xh * dt[..., None]), a, q(Bm), q(Cm), s["chunk"])
    y = (y + p["D"][None, :, None] * xh).reshape(L, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg["norm_eps"])
    return mm(y, p["out_proj"], q)


def attention(x, p, cfg, q=identity):
    L, d = x.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    qh = mm(x, p["wq"].reshape(d, H * hd), q).view(L, H, hd)
    kh = mm(x, p["wk"].reshape(d, KV * hd), q).view(L, KV, hd)
    vh = mm(x, p["wv"].reshape(d, KV * hd), q).view(L, KV, hd)
    kh = q(kh.repeat_interleave(H // KV, dim=1))
    vh = q(vh.repeat_interleave(H // KV, dim=1))
    qh = q(qh)
    out = torch.empty(L, H, hd, device=x.device)
    kpos = torch.arange(L, device=x.device)
    for s in range(0, L, Q_BLOCK):
        e = min(L, s + Q_BLOCK)
        sc = torch.einsum("qhd,khd->hqk", qh[s:e], kh[:e]) / math.sqrt(hd)
        mask = kpos[None, :e] <= torch.arange(s, e, device=x.device)[:, None]
        w = torch.softmax(sc.masked_fill(~mask[None], float("-inf")), -1)
        out[s:e] = torch.einsum("hqk,khd->qhd", q(w), vh[:e])
    return mm(out.reshape(L, H * hd), p["wo"].reshape(H * hd, d), q)


def swiglu(x, wi, wo, q=identity):
    gate, up = mm(x, wi, q).chunk(2, dim=-1)
    return mm(F.silu(gate) * up, wo, q)


def moe(x, p, cfg, q=identity):
    """Top-k MoE, every routed token computed (no capacity)."""
    k = cfg["moe"]["top_k"]
    probs = torch.softmax(x @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    if cfg["moe"].get("renorm_gates", True):
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(x)
    for e in range(p["router"].shape[1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], p["wi"][e], p["wo"][e], q)
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def logits(params, tokens, cfg, *, rows=slice(None), q=identity):
    """Float32 logits of one sequence at the positions ``rows``."""
    eps = cfg["norm_eps"]
    x = params["embed"]["table"][tokens]
    for blk in blocks(params["stack"]):
        h = rmsnorm(x, blk["norm_mixer"], eps)
        x = x + (mamba(h, blk["mamba"], cfg, q) if "mamba" in blk
                 else attention(h, blk["attn"], cfg, q))
        if "norm_ffn" in blk:
            h = rmsnorm(x, blk["norm_ffn"], eps)
            x = x + (moe(h, blk["moe"], cfg, q) if "moe" in blk
                     else swiglu(h, blk["mlp"]["wi"], blk["mlp"]["wo"], q))
    x = rmsnorm(x[rows], params["final_norm"], eps)
    return (x @ params["lm_head"]["kernel"])[:, :cfg["vocab"]]
