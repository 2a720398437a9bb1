"""Basic layers in plain PyTorch: norms, embeddings, MLPs, RoPE, learned
positions.

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``wi`` is ``(d, 2·ff)``, a linear maps ``x @ W``), so converted
reference parameters drop straight in.  Every ``init_*`` has a ``*_spec``
twin returning a tree of the same structure whose leaves are tuples of
logical axis names, one per dim (``None`` = replicated), the JAX package's
specs; ``repro_torch.sharding`` maps the names to mesh axes.
``cfg.dtype`` is the compute dtype, ``cfg.param_dtype`` the storage dtype;
weights are cast at use, as in the reference.  Beside each spec, a
``*_COMPUTE_DTYPE`` set names the leaves that every read casts whole to
the compute dtype: the serving engine holds those in that dtype
(``repro_torch.serve.engine.own_weights``), so the casts become no-ops.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def trunc_normal(gen: torch.Generator, shape, scale: float, dtype,
                 device) -> torch.Tensor:
    """Fan-in-scaled normal truncated at ±2σ."""
    stddev = scale / np.sqrt(max(1, shape[0] if len(shape) else 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev).to(dtype)     # in place: no second copy


def dense_init(gen, d_in: int, d_out: int, dtype, device, *,
               scale: float = 1.0) -> torch.Tensor:
    return trunc_normal(gen, (d_in, d_out), scale, dtype, device)


# -- norms ---------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_spec() -> dict:
    return {"scale": ("embed",)}


def rms_norm(x: torch.Tensor, params: dict, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def init_layernorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_spec() -> dict:
    return {"scale": ("embed",), "bias": ("embed",)}


def layer_norm(x: torch.Tensor, params: dict, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(dtype)


# -- embedding / unembedding ------------------------------------------------------

def init_embed(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"table": trunc_normal(gen, (vocab, d), 1.0, dtype, device)}


def embed_spec() -> dict:
    return {"table": ("vocab", "embed")}


def embed(x_tokens: torch.Tensor, params: dict, dtype) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first, without
    # materializing a cast copy of the whole table
    return F.embedding(x_tokens, params["table"]).to(dtype)


def unembed(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Vocab logits against the (tied) embedding table, in float32."""
    return x.float() @ params["table"].float().t()


def init_lm_head(gen, d: int, vocab: int, dtype, device) -> dict:
    return {"kernel": dense_init(gen, d, vocab, dtype, device)}


def lm_head_spec() -> dict:
    return {"kernel": ("embed", "vocab")}


def lm_head(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Vocab logits in float32 (a stable softmax and loss)."""
    return x.float() @ params["kernel"].float()


# -- MLPs ----------------------------------------------------------------------

def init_swiglu(gen, d: int, ff: int, dtype, device) -> dict:
    return {"wi": dense_init(gen, d, 2 * ff, dtype, device),
            "wo": dense_init(gen, ff, d, dtype, device)}


def swiglu_spec() -> dict:
    return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}


#: the leaves :func:`swiglu` reads cast whole to the compute dtype
SWIGLU_COMPUTE_DTYPE = frozenset({"wi", "wo"})


def swiglu(x: torch.Tensor, params: dict) -> torch.Tensor:
    dtype = x.dtype
    h = x @ params["wi"].to(dtype)
    gate, up = h.chunk(2, dim=-1)
    h = F.silu(gate.float()).to(dtype) * up
    return h @ params["wo"].to(dtype)


def init_gelu_mlp(gen, d: int, ff: int, dtype, device, *,
                  bias: bool = True) -> dict:
    p = {"wi": dense_init(gen, d, ff, dtype, device),
         "wo": dense_init(gen, ff, d, dtype, device)}
    if bias:
        p["bi"] = torch.zeros((ff,), dtype=dtype, device=device)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def gelu_mlp_spec(*, bias: bool = True) -> dict:
    p = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if bias:
        p["bi"] = ("mlp",)
        p["bo"] = ("embed",)
    return p


#: the leaves :func:`gelu_mlp` reads cast whole to the compute dtype
GELU_MLP_COMPUTE_DTYPE = frozenset({"wi", "wo", "bi", "bo"})


def gelu_mlp(x: torch.Tensor, params: dict) -> torch.Tensor:
    dtype = x.dtype
    h = x @ params["wi"].to(dtype)
    if "bi" in params:
        h = h + params["bi"].to(dtype)
    h = F.gelu(h.float(), approximate="tanh").to(dtype)
    out = h @ params["wo"].to(dtype)
    if "bo" in params:
        out = out + params["bo"].to(dtype)
    return out


# -- rotary position embeddings -----------------------------------------------------

@functools.lru_cache(maxsize=16)
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for RoPE (float32, computed as the reference with
    numpy), kept per device: copying them to the card at every call would
    wait for the card twice a layer."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return torch.from_numpy(np.asarray(1.0 / (theta ** exponents),
                                       np.float32)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by position-dependent angles
    (half-split, LLaMA/NeoX style); ``positions`` (..., seq)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    angles = positions.float()[..., :, None] * inv[None, :]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- learned absolute positions (whisper-style) ----------------------------------

def init_learned_pos(gen, max_len: int, d: int, dtype, device) -> dict:
    return {"pos": trunc_normal(gen, (max_len, d), 0.02 * np.sqrt(max_len),
                                dtype, device)}


def learned_pos_spec() -> dict:
    return {"pos": (None, "embed")}


def add_learned_pos(x: torch.Tensor, params: dict, offset: int = 0
                    ) -> torch.Tensor:
    """``x`` (..., seq, d) plus the table's rows ``offset … offset + seq``."""
    seq = x.shape[-2]
    return x + params["pos"][offset:offset + seq].to(x.dtype)


__all__ = [
    "trunc_normal", "dense_init", "init_rmsnorm", "rmsnorm_spec", "rms_norm",
    "init_layernorm", "layernorm_spec", "layer_norm", "init_embed",
    "embed_spec", "embed", "unembed", "init_lm_head", "lm_head_spec",
    "lm_head", "init_swiglu", "swiglu_spec", "swiglu", "init_gelu_mlp",
    "gelu_mlp_spec", "gelu_mlp", "SWIGLU_COMPUTE_DTYPE",
    "GELU_MLP_COMPUTE_DTYPE", "rope_frequencies", "apply_rope",
    "init_learned_pos", "learned_pos_spec", "add_learned_pos",
]
