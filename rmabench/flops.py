"""Model FLOPs and bytes, from a configuration and the traffic the benchmark
sent; nothing is read from the program.  A multiply-add is 2 FLOPs; causal
attention counts the keys each query sees (its position + 1); nothing
recomputed (rematerialization) is counted, and an MoE layer counts its
``top_k`` experts per token, not the padding of a capacity buffer.

``cfg`` is a configuration file's ``model`` dict (the port's field
names)."""
from __future__ import annotations


def head_dim(cfg) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def layer_kinds(cfg) -> list[tuple[str, str]]:
    """(mixer, ffn) of every layer: ``gqa``/``mamba`` and
    ``dense``/``moe``/``none``, the registered plan's rule."""
    out = []
    moe = cfg.get("moe")
    for i in range(cfg["n_layers"]):
        if cfg.get("ssm") and cfg.get("hybrid_period"):
            mixer = ("gqa" if i % cfg["hybrid_period"]
                     == cfg["hybrid_attn_offset"] else "mamba")
        elif cfg.get("ssm"):
            mixer = "mamba"
        else:
            mixer = "gqa"
        if cfg.get("family") == "ssm":
            ffn = "none"
        elif moe and i % moe["interleave_step"] == moe["interleave_offset"]:
            ffn = "moe"
        else:
            ffn = "dense"
        out.append((mixer, ffn))
    return out


def _mamba_dims(cfg):
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    heads = d_inner // s["headdim"]
    return d_inner, heads, s["d_state"], d_inner + 2 * s["d_state"]


def _ffn_mults(cfg, ffn: str) -> int:
    """Multiply-adds per token of one FFN (weights touched once each)."""
    d = cfg["d_model"]
    if ffn == "none":
        return 0
    if ffn == "moe":
        moe = cfg["moe"]
        return (d * moe["num_experts"]
                + moe["top_k"] * 3 * d * moe["d_ff_expert"])
    if cfg.get("act") == "gelu":
        return 2 * d * cfg["d_ff"]
    return 3 * d * cfg["d_ff"]


def _mixer_mults(cfg, mixer: str) -> int:
    """Multiply-adds per token of a mixer's projections."""
    d = cfg["d_model"]
    if mixer == "mamba":
        d_inner, heads, n, conv_dim = _mamba_dims(cfg)
        proj = d * (2 * d_inner + 2 * n + heads) + d_inner * d
        conv = conv_dim * cfg["ssm"]["d_conv"]
        scan = 2 * d_inner * n          # state update and read-out
        return proj + conv + scan
    hd = head_dim(cfg)
    return d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])


def forward_flops(cfg, seq_len: int, *, start: int = 0,
                  logits_rows: int | None = None) -> float:
    """FLOPs of one sequence's forward over positions ``start ..
    seq_len - 1`` (the earlier ones cached), with the LM head on
    ``logits_rows`` rows (default: every new row)."""
    new = seq_len - start
    rows = new if logits_rows is None else logits_rows
    # keys seen by the new queries: sum over p in [start, seq_len) of p + 1
    keys = (seq_len * (seq_len + 1) - start * (start + 1)) // 2
    hd = head_dim(cfg)
    mults = 0
    for mixer, ffn in layer_kinds(cfg):
        mults += new * (_mixer_mults(cfg, mixer) + _ffn_mults(cfg, ffn))
        if mixer == "gqa":
            mults += 2 * cfg["n_heads"] * hd * keys     # q.k and p.v
    mults += rows * cfg["d_model"] * cfg["vocab"]
    return 2.0 * mults


def train_step_flops(cfg, batch_rows: int, seq_len: int) -> float:
    """Model FLOPs of one training step: forward and backward (twice the
    forward) over every row."""
    return 3.0 * batch_rows * forward_flops(cfg, seq_len)


def dense_param_count(cfg) -> int:
    """Parameters of a dense GQA stack (LayerNorm or RMSNorm, GELU or
    SwiGLU, optional biases), embedding and untied head included."""
    d, hd = cfg["d_model"], head_dim(cfg)
    H, KV, ff = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    vocab = -(-cfg["vocab"] // 256) * 256
    norm = 2 * d if cfg.get("norm") == "layernorm" else d
    attn = d * hd * (2 * H + 2 * KV)
    if cfg.get("attn_bias"):
        attn += hd * (H + 2 * KV) + d
    if cfg.get("act") == "gelu":
        mlp = 2 * d * ff + ((ff + d) if cfg.get("attn_bias") else 0)
    else:
        mlp = 3 * d * ff
    layer = 2 * norm + attn + mlp
    head = 0 if cfg.get("tie_embeddings") else d * vocab
    return cfg["n_layers"] * layer + vocab * d + head + norm


def ring_width(params: int, ranks: int) -> int:
    """Columns of the gradient matrix the ring reduces: the parameters
    padded to whole, vector-aligned chunks (4 floats a rank)."""
    return -(-params // (4 * ranks)) * (4 * ranks)


def ring_bytes(params: int, ranks: int) -> float:
    """Bytes an all-reduce of the (ranks, width) float32 gradient matrix
    must move: every input byte read once, every output byte (each row
    holds the sum) written once."""
    return 2.0 * 4 * ranks * ring_width(params, ranks)


def ssd_scan_bytes(cfg, length: int) -> float:
    """Bytes the SSD scan of one Mamba2 layer over ``length`` prompt rows
    must move: x·dt (bf16), the decays a (float32), B and C (bf16) read
    once; y (bf16) and the final state (bf16) written once."""
    d_inner, heads, n, _ = _mamba_dims(cfg)
    return (2 * length * d_inner + 4 * length * heads + 2 * 2 * length * n
            + 2 * length * d_inner + 2 * d_inner * n)


def ssd_scan_flops(cfg, length: int) -> float:
    """The scan's own arithmetic: the state update and the read-out, one
    multiply-add each per state element per row."""
    d_inner, _, n, _ = _mamba_dims(cfg)
    return 2.0 * 2 * length * d_inner * n
