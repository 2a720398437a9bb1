"""Plain float32 reference of a dense GQA decoder's training step.

The forward follows the published StarCoder2 block (arXiv:2402.19173):
pre-LayerNorm (or RMSNorm), grouped-query attention with biases and
half-split rotary embeddings (query head h reads key/value head
h // (H / KV)), a GELU (tanh) or SwiGLU MLP, a final norm and an untied
head; the loss is the mean next-token cross-entropy.  The step takes each
data-parallel rank's rows, the mean of their gradients, clips them to a
global norm and applies AdamW (linear warm-up, cosine decay), all in
float32 one sequence at a time, so only one sequence's activations are
alive.  Parameters are the benchmark's tree (the layout both sides are
handed); nothing here imports the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rmabench.reference.numerics import identity, mm


def blocks(stack: dict):
    """Every layer's parameters in order: the prefix blocks, then the
    stacked periods (row c of each ``scan/l{j}`` leaf)."""
    for blk in stack.get("prefix", []):
        yield blk
    scan = stack.get("scan")
    if not scan:
        return
    period = len(scan)
    count = _first(scan).shape[0]
    for c in range(count):
        for j in range(period):
            yield _index(scan[f"l{j}"], c)


def _first(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def _index(tree, c):
    if isinstance(tree, dict):
        return {k: _index(v, c) for k, v in tree.items()}
    return tree[c]


def norm(x, p, cfg):
    if cfg.get("norm") == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + cfg["norm_eps"]) * p["scale"] \
            + p["bias"]
    var = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + cfg["norm_eps"]) * p["scale"]


def rope(x, theta: float):
    """Half-split rotary embedding of ``x`` (S, heads, hd) at positions
    0 .. S-1."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                       dtype=torch.float64) / hd)
    ang = (torch.arange(S, device=x.device, dtype=torch.float64)[:, None]
           * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, p, cfg, q=identity):
    """Causal GQA self-attention of one sequence ``x`` (S, d)."""
    S, d = x.shape
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // H
    qh = mm(x, p["wq"].reshape(d, H * hd), q).view(S, H, hd)
    kh = mm(x, p["wk"].reshape(d, KV * hd), q).view(S, KV, hd)
    vh = mm(x, p["wv"].reshape(d, KV * hd), q).view(S, KV, hd)
    if "bq" in p:
        qh, kh, vh = qh + p["bq"], kh + p["bk"], vh + p["bv"]
    if cfg.get("rope_theta"):
        qh, kh = rope(qh, cfg["rope_theta"]), rope(kh, cfg["rope_theta"])
    rep = H // KV
    kh = kh.repeat_interleave(rep, dim=1)
    vh = vh.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q(qh), q(kh)) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("hqk,khd->qhd", q(w), q(vh)).reshape(S, H * hd)
    out = mm(out, p["wo"].reshape(H * hd, d), q)
    if "bo" in p:
        out = out + p["bo"]
    return out


def mlp(x, p, cfg, q=identity):
    if cfg.get("act") == "gelu":
        h = mm(x, p["wi"], q)
        if "bi" in p:
            h = h + p["bi"]
        h = F.gelu(h, approximate="tanh")
        out = mm(h, p["wo"], q)
        return out + p["bo"] if "bo" in p else out
    h = mm(x, p["wi"], q)
    gate, up = h.chunk(2, dim=-1)
    return mm(F.silu(gate) * up, p["wo"], q)


def logits(params, tokens, cfg, q=identity):
    """Float32 logits (S, vocab) of one sequence."""
    x = params["embed"]["table"][tokens]
    for blk in blocks(params["stack"]):
        x = x + attention(norm(x, blk["norm_mixer"], cfg), blk["attn"], cfg, q)
        x = x + mlp(norm(x, blk["norm_ffn"], cfg), blk["mlp"], cfg, q)
    x = norm(x, params["final_norm"], cfg)
    head = (params["embed"]["table"].t() if cfg.get("tie_embeddings")
            else params["lm_head"]["kernel"])
    return x @ head


def loss(params, tokens, labels, cfg, q=identity):
    lg = logits(params, tokens, cfg, q)[:, :cfg["vocab"]]
    return F.cross_entropy(lg, labels)


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``peak_lr``, then cosine decay to ``min_lr``."""
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(1, opt["warmup_steps"])
    frac = min(max((step - opt["warmup_steps"])
                   / max(1, opt["total_steps"] - opt["warmup_steps"]), 0.0),
               1.0)
    return opt["min_lr"] + 0.5 * (opt["peak_lr"] - opt["min_lr"]) * (
        1 + math.cos(math.pi * frac))


def train_steps(params, leaves, batches, cfg, opt: dict, norms,
                q=identity):
    """Run ``len(batches)`` steps in place on ``params``.  ``leaves`` lists
    ``(path, tensor)`` of every parameter (views into the tree);
    ``batches`` holds each step's ``(ranks, rows, S + 1)`` token tensor;
    ``norms`` maps a list of tensors in ``leaves`` order to named norms.
    Returns each step's loss, the norms of step 1's clipped gradients and
    the norms of every leaf's change over all the steps."""
    ts = [t for _, t in leaves]
    start = [t.detach().clone() for t in ts]
    m = [torch.zeros_like(t) for t in ts]
    v = [torch.zeros_like(t) for t in ts]
    losses, first = [], None
    for step, batch in enumerate(batches, start=1):
        acc = [torch.zeros_like(t) for t in ts]
        rows = batch.reshape(-1, batch.shape[-1])
        total = 0.0
        for r in range(rows.shape[0]):
            ps = [t.detach().requires_grad_(True) for t in ts]
            tree = _rebuild(params, leaves, ps)
            with torch.enable_grad():
                lo = loss(tree, rows[r, :-1].long(), rows[r, 1:].long(), cfg,
                          q)
                gs = torch.autograd.grad(lo, ps)
            total += float(lo.detach())
            for a, g in zip(acc, gs):
                a.add_(g)
            del gs, lo, tree, ps
        losses.append(total / rows.shape[0])
        for a in acc:
            a.div_(rows.shape[0])
        gnorm = math.sqrt(sum(float(a.square().sum()) for a in acc))
        scale = min(opt["grad_clip"] / max(gnorm, 1e-12), 1.0)
        lr = lr_at(opt, step)
        b1, b2 = opt["b1"], opt["b2"]
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for t, g, m_, v_ in zip(ts, acc, m, v):
                g.mul_(scale)
                m_.mul_(b1).add_(g, alpha=1 - b1)
                v_.mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m_ / bc1) / (torch.sqrt(v_ / bc2) + opt["eps"]) \
                    + opt["weight_decay"] * t
                t.sub_(lr * delta)
        if first is None:
            first = norms(acc)
        del acc
    with torch.no_grad():
        for s, t in zip(start, ts):
            s.sub_(t).neg_()
    return losses, first, norms(start)


def _rebuild(params, leaves, new):
    """``params`` with the leaves listed in ``leaves`` replaced by ``new``
    (matched by identity)."""
    swap = {id(t): n for (_, t), n in zip(leaves, new)}

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return swap.get(id(tree), tree)

    return walk(params)
