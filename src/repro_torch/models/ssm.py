"""Mamba2 — the state-space duality (SSD) layer: chunked scan for prefill and
forward, the O(1) recurrence for decode.

Ported from the JAX package's ``models/ssm.py``.  The reference's model
calls the pure-JAX ``ssd_chunked`` everywhere, and trains through it: its
Pallas kernel has no backward.  The port routes by what the caller
computes, as the reference's choice of function does: a call whose inputs
require grad (a train step) goes through :func:`ssd_chunked`, the port of
that very function, so autograd differentiates it; every other call —
prefill and the no-grad forward — goes through ``kernels.ops.ssd_scan``,
kernel K8 plus the SSD pass, the same function, so every prefill of a
Mamba2 or hybrid stack runs through K8.  No kernel failure leads to
``ssd_chunked``, and K8 and the pass still refuse grad inputs on the card.
``ssd_ref`` stays here as the sequential oracle.  Decode (one token against
a cache) is the plain recurrence in both packages.

Layout: d_inner = expand·d_model, nheads = d_inner/headdim, one B/C group.
Caches are written in place (the JAX package returns new ones).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import layers
from repro_torch.sharding import logical_constraint


def _dims(cfg) -> tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.headdim, d_inner + 2 * s.d_state


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_mamba2(gen, cfg, device) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = _dims(cfg)
    pd = cfg.parameter_dtype
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": layers.trunc_normal(
            gen, (d, 2 * d_inner + 2 * s.d_state + nheads), 1.0, pd, device),
        "conv_w": layers.trunc_normal(gen, (conv_dim, s.d_conv), 1.0, pd,
                                      device),
        "conv_b": torch.zeros((conv_dim,), dtype=pd, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          dtype=torch.float32, device=device)),
        "D": torch.ones((nheads,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=device),
        "norm": layers.init_rmsnorm(d_inner, pd, device),
        "out_proj": layers.trunc_normal(gen, (d_inner, d), 1.0, pd, device),
    }


def mamba2_spec(cfg) -> dict:
    return {
        "in_proj": ("embed", "mlp"),
        "conv_w": ("mlp", None),
        "conv_b": ("mlp",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm": {"scale": ("mlp",)},
        "out_proj": ("mlp", "embed"),
    }


#: the leaves :func:`mamba2_apply` reads cast whole to the compute dtype
#: (``A_log``, ``D``, ``dt_bias`` and the norm's scale are read in float32;
#: a prefill reads ``conv_w`` a column at a time)
MAMBA2_COMPUTE_DTYPE = frozenset({"in_proj", "out_proj", "conv_b"})


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv1d(u: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """u (B, L, C), w (C, K), b (C,) — causal depthwise conv as K shifted
    multiply-adds in u's dtype (the reference's rounding; no cuDNN, so no
    TF32)."""
    K = w.shape[1]
    L = u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for k in range(K):
        out = out + pad[:, k:k + L, :] * w[:, k].to(u.dtype)
    return out + b.to(u.dtype)


def causal_conv1d_step(u: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor):
    """Single-token conv: u (B, 1, C); conv_state (B, K-1, C).  Returns the
    output (B, 1, C) and the next conv state (B, K-1, C)."""
    window = torch.cat([conv_state, u], dim=1)          # (B, K, C)
    out = (window * w.t().to(u.dtype)).sum(1) + b.to(u.dtype)
    return out[:, None, :], window[:, 1:, :]


# ---------------------------------------------------------------------------
# chunked SSD: the plain versions
# ---------------------------------------------------------------------------

def ssd_chunked(xdt, a, Bm, Cm, *, chunk: int, initial_state=None):
    """Chunked SSD scan in plain PyTorch, the JAX package's ``ssd_chunked``:
    xdt (B, L, H, P), a (B, L, H), Bm/Cm (B, L, N) → (y (B, L, H, P),
    final_state (B, H, P, N)), rounding y once."""
    Bsz, L, H, Pd = xdt.shape
    N = Bm.shape[-1]
    pad = (-L) % chunk
    if pad:
        # zero-pad: a = 0 (decay exp(0) = 1) and x̃ = 0 leave the state
        # untouched, so the final state stays exact; padded rows are sliced
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    xc = xdt.reshape(Bsz, nc, chunk, H, Pd).float()
    ac = a.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, N).float()
    state = (initial_state.float() if initial_state is not None else
             xc.new_zeros((Bsz, H, Pd, N)))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xdt.device).tril()
    ys = []
    for c in range(nc):
        x_q, B_q, C_q = xc[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(ac[:, c], dim=1)                     # (B, q, H)
        CB = torch.einsum("bin,bjn->bij", C_q, B_q)
        # mask BEFORE exp: exp of a positive (i < j) difference overflows
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # (B, i, j, H)
        Lij = torch.exp(torch.where(tri[None, :, :, None], diff,
                                    diff.new_full((), float("-inf"))))
        y_intra = torch.einsum("bijh,bjhp->bihp", CB[..., None] * Lij, x_q)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", C_q, state,
                               torch.exp(cum))
        decay_out = torch.exp(cum[:, -1:, :] - cum)             # (B, q, H)
        state = (torch.einsum("bjn,bjh,bjhp->bhpn", B_q, decay_out, x_q)
                 + state * torch.exp(cum[:, -1])[:, :, None, None])
        ys.append((y_intra + y_inter).to(xdt.dtype))
    y = torch.stack(ys, 1).reshape(Bsz, -1, H, Pd)[:, :L]
    return y, state.to(xdt.dtype)


#: the sequential-recurrence oracle (exact, O(L) steps), by the JAX package's
#: name for it here
ssd_ref = ssd_scan_ref


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_apply(params: dict, x: torch.Tensor, cfg, *,
                 cache: dict | None = None) -> torch.Tensor:
    """Mamba2 block over x (B, S, d).  With ``cache`` (written in place):
    one-token decode when S == 1, else a prefill that continues from the
    cached state and stores the conv tail and final state.  Without:
    the full-sequence forward.  The chunked scan runs through K8 and the
    SSD pass, or, when its inputs require grad, through
    :func:`ssd_chunked`."""
    s = cfg.ssm
    B, S, _ = x.shape
    dt_ = x.dtype
    d_inner, nheads, _ = _dims(cfg)
    h = x @ params["in_proj"].to(dt_)
    z, rest = h[..., :d_inner], h[..., d_inner:]
    xbc = rest[..., :d_inner + 2 * s.d_state]
    dtr = rest[..., d_inner + 2 * s.d_state:]
    decode = cache is not None and S == 1

    if decode:
        xbc, conv_state = causal_conv1d_step(
            xbc, cache["conv"], params["conv_w"], params["conv_b"])
    else:
        if cache is not None and S < s.d_conv - 1:
            # the reference stores a tail shorter than the cache slot here,
            # and its next decode step fails on the shapes
            raise ValueError(
                f"a {S}-token prefill leaves a conv tail shorter than the "
                f"cache's {s.d_conv - 1} rows; prompts of 1 or at least "
                f"{s.d_conv - 1} tokens")
        xbc_raw = xbc                      # pre-conv inputs: the conv tail
        xbc = causal_conv1d(xbc, params["conv_w"], params["conv_b"])
    xbc = F.silu(xbc.float()).to(dt_)
    xin = xbc[..., :d_inner]
    Bm = xbc[..., d_inner:d_inner + s.d_state]
    Cm = xbc[..., d_inner + s.d_state:]

    A = -torch.exp(params["A_log"])                                  # (H,)
    dt_act = F.softplus(dtr.float() + params["dt_bias"])            # (B,S,H)
    xh = xin.reshape(B, S, nheads, s.headdim)
    xdt = xh * dt_act[..., None].to(dt_)
    a = dt_act * A                                                   # (B,S,H)

    if decode:
        state = cache["ssm"].float()
        decay = torch.exp(a[:, 0].float())
        state = state * decay[:, :, None, None] + (
            xdt[:, 0].float()[..., None] * Bm[:, 0].float()[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", state, Cm[:, 0].float())[:, None]
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(state)
    else:
        s0 = cache["ssm"] if cache is not None else None
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (xdt, a, Bm, Cm,
                                                            s0)):
            y, final_state = ssd_chunked(xdt, a, Bm, Cm, chunk=s.chunk,
                                         initial_state=s0)
        else:
            y, final_state = ops.ssd_scan(
                xdt, a, Bm, Cm, chunk=s.chunk, nheads=nheads,
                headdim=s.headdim, initial_state=s0)
        if cache is not None:
            cache["conv"].copy_(xbc_raw[:, -(s.d_conv - 1):, :])
            cache["ssm"].copy_(final_state)

    y = (y.float() + params["D"][None, None, :, None] * xh.float()).to(dt_)
    y = y.reshape(B, S, d_inner)
    y = logical_constraint(y, "batch", "seq", "mlp")
    gated = y * F.silu(z.float()).to(dt_)
    gated = layers.rms_norm(gated, params["norm"], cfg.norm_eps)
    return gated @ params["out_proj"].to(dt_)


def init_mamba2_cache(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    d_inner, nheads, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nheads, s.headdim, s.d_state),
                           dtype=dtype, device=device),
    }


def mamba2_cache_spec(cfg) -> dict:
    return {
        "conv": ("batch", None, "mlp"),
        "ssm": ("batch", None, None, "ssm_state"),
    }


__all__ = [
    "init_mamba2", "mamba2_spec", "mamba2_apply", "MAMBA2_COMPUTE_DTYPE",
    "init_mamba2_cache", "mamba2_cache_spec",
    "ssd_chunked", "ssd_ref", "causal_conv1d", "causal_conv1d_step",
]
