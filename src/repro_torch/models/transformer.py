"""Decoder stack for all ten architectures: the layer plan and its
[prefix] + [repeating period × count] decomposition, kept so the parameter
tree matches the JAX package's (scanned leaves stacked on a leading layer
axis).  A layer is a mixer — GQA attention, MLA (``mixer="mla"``,
DeepSeek) or a Mamba2 block (``mixer="mamba"``) — then, in an enc-dec
decoder (``cross=True``), a cross-attention over the encoder output, then
an FFN: dense, MoE, or none (pure Mamba2 blocks carry their own
projections).  A hybrid stack (``jamba``) puts attention where
``i % hybrid_period == hybrid_attn_offset`` and Mamba2 elsewhere, with the
MoE interleave on top: an 8-layer period of 7 Mamba2 layers and one
attention layer.  The reference scans the periods; here a Python loop
walks them.  Under ``remat="block"`` (the default, as in the reference) a
training forward wraps each scanned period — never a prefix layer — in a
non-reentrant ``torch.utils.checkpoint``, so the backward recomputes the
period from its input and saved nothing inside it; its side effects (an
MoE period's exchanges) run again in the recompute, as under the
reference's ``jax.checkpoint``.  MoE layers (``first_dense``,
``interleave_step``/``interleave_offset``) add their load-balancing loss to
the stack's aux sum; in a config with ``first_dense`` every dense FFN takes
``d_ff_first_dense``, as in the reference.

The serving caches follow the same decomposition: ``{"step", "prefix":
[...], "scan": {...}}`` with the scanned blocks' leaves stacked on a leading
layer axis, the JAX package's layout — ``{"attn": {k, v, pos}}`` for an
attention layer, ``{"attn": {c_kv, k_rope, pos}}`` for MLA, ``{"mamba":
{conv, ssm}}`` for a Mamba2 layer, plus ``{"cross": {k, v}}`` (``enc_len``
rows) in an enc-dec decoder.  ``apply_stack(cache=...)`` hands each block a
view of its slice, so the cache is written in place."""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.models import attention, layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.sharding import logical_constraint, map_specs
from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "gqa"   # gqa | mla | mamba
    ffn: str = "dense"   # dense | moe | none
    cross: bool = False  # add cross-attention (enc-dec decoder)


def layer_plan(cfg) -> list[LayerSpec]:
    """The per-layer structure of the decoder stack for ``cfg``, the JAX
    package's plan."""
    plan = []
    for i in range(cfg.n_layers):
        if cfg.ssm is not None and cfg.hybrid_period:
            mixer = ("gqa" if i % cfg.hybrid_period == cfg.hybrid_attn_offset
                     else "mamba")
        elif cfg.ssm is not None:
            mixer = "mamba"
        elif cfg.mla is not None:
            mixer = "mla"
        else:
            mixer = "gqa"
        if cfg.family == "ssm":
            ffn = "none"   # pure Mamba2 blocks carry their own projections
        elif cfg.moe is not None and i >= cfg.moe.first_dense and \
                i % cfg.moe.interleave_step == cfg.moe.interleave_offset:
            ffn = "moe"
        else:
            ffn = "dense"
        plan.append(LayerSpec(mixer=mixer, ffn=ffn,
                              cross=cfg.enc_layers > 0))
    return plan


def stage_plan(plan: list[LayerSpec]) -> tuple[int, int]:
    """Decompose ``plan`` into (prefix_len, period)."""
    n = len(plan)
    for prefix in (0, 1, 2):
        rest = plan[prefix:]
        if not rest:
            continue
        for period in (1, 2, 4, 8, 16):
            if len(rest) % period == 0 and all(
                    rest[i] == rest[i % period] for i in range(len(rest))):
                return prefix, period
    return n, 1


def _norm_init(cfg, device):
    if cfg.norm == "layernorm":
        return layers.init_layernorm(cfg.d_model, cfg.parameter_dtype, device)
    return layers.init_rmsnorm(cfg.d_model, cfg.parameter_dtype, device)


def _norm_spec(cfg):
    return (layers.layernorm_spec() if cfg.norm == "layernorm"
            else layers.rmsnorm_spec())


def _norm(x, p, cfg):
    if cfg.norm == "layernorm":
        return layers.layer_norm(x, p, cfg.norm_eps)
    return layers.rms_norm(x, p, cfg.norm_eps)


def init_block(gen, spec: LayerSpec, cfg, device) -> dict:
    pd = cfg.parameter_dtype
    p: dict = {"norm_mixer": _norm_init(cfg, device)}
    if spec.mixer == "mamba":
        p["mamba"] = ssm.init_mamba2(gen, cfg, device)
    elif spec.mixer == "mla":
        p["attn"] = attention.init_mla(gen, cfg, device)
    else:
        p["attn"] = attention.init_gqa(gen, cfg, device)
    if spec.cross:
        p["norm_cross"] = _norm_init(cfg, device)
        p["cross"] = attention.init_gqa(gen, cfg, device)
    if spec.ffn == "none":
        return p
    p["norm_ffn"] = _norm_init(cfg, device)
    if spec.ffn == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg, device)
        return p
    d_ff = cfg.d_ff
    if cfg.moe is not None and cfg.moe.first_dense and \
            cfg.moe.d_ff_first_dense:
        d_ff = cfg.moe.d_ff_first_dense
    if cfg.act == "gelu":
        p["mlp"] = layers.init_gelu_mlp(gen, cfg.d_model, d_ff, pd, device,
                                        bias=cfg.attn_bias)
    else:
        p["mlp"] = layers.init_swiglu(gen, cfg.d_model, d_ff, pd, device)
    return p


def block_spec(spec: LayerSpec, cfg) -> dict:
    """The logical-axis spec tree of one block's parameters."""
    p: dict = {"norm_mixer": _norm_spec(cfg)}
    if spec.mixer == "gqa":
        p["attn"] = attention.gqa_spec(cfg)
    elif spec.mixer == "mla":
        p["attn"] = attention.mla_spec(cfg)
    elif spec.mixer == "mamba":
        p["mamba"] = ssm.mamba2_spec(cfg)
    if spec.cross:
        p["norm_cross"] = _norm_spec(cfg)
        p["cross"] = attention.gqa_spec(cfg)
    if spec.ffn == "dense":
        p["norm_ffn"] = _norm_spec(cfg)
        p["mlp"] = (layers.gelu_mlp_spec(bias=cfg.attn_bias)
                    if cfg.act == "gelu" else layers.swiglu_spec())
    elif spec.ffn == "moe":
        p["norm_ffn"] = _norm_spec(cfg)
        p["moe"] = moe_lib.moe_spec(cfg)
    return p


def block_compute_dtype_leaves(spec: LayerSpec, cfg) -> list[tuple]:
    """Paths in one block's parameters of the leaves that every read casts
    whole to the compute dtype, gathered from the sets each module keeps
    beside its spec; a path the block lacks (a bias the config leaves out)
    names nothing."""
    mixer = {"gqa": (("attn",), attention.GQA_COMPUTE_DTYPE),
             "mla": (("attn",), attention.MLA_COMPUTE_DTYPE),
             "mamba": (("mamba",), ssm.MAMBA2_COMPUTE_DTYPE)}
    parts = [mixer[spec.mixer]]
    if spec.cross:
        parts.append((("cross",), attention.GQA_COMPUTE_DTYPE))
    if spec.ffn == "moe":
        parts += [(("moe",), moe_lib.MOE_COMPUTE_DTYPE),
                  (("moe", "shared"), layers.SWIGLU_COMPUTE_DTYPE)]
    elif spec.ffn == "dense":
        parts.append((("mlp",), layers.GELU_MLP_COMPUTE_DTYPE
                      if cfg.act == "gelu" else layers.SWIGLU_COMPUTE_DTYPE))
    return [where + (name,) for where, names in parts
            for name in sorted(names)]


def apply_block(params: dict, spec: LayerSpec, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, causal: bool = True,
                ep_ranks: int = 1, cache: dict | None = None,
                prefill: bool = False, enc_out: torch.Tensor | None = None,
                cross_cached: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block: a pre-norm attention, MLA or Mamba2 mixer, in an enc-dec
    decoder a pre-norm cross-attention over ``enc_out`` (``cross_cached``:
    the encoder's k/v come from the cache), then a pre-norm MLP, MoE, or no
    FFN.  Returns ``(x, aux)``; ``ep_ranks`` is the MoE's expert-parallel
    rank count.  ``cache`` (the block's, written in place) goes to the
    mixers, ``prefill`` to the attention (a Mamba2 block decodes exactly
    when it has a cache and one token)."""
    with obs.span(f"layer.{spec.mixer}"):
        h = _norm(x, params["norm_mixer"], cfg)
        if spec.mixer == "mamba":
            x = x + ssm.mamba2_apply(
                params["mamba"], h, cfg,
                cache=cache["mamba"] if cache is not None else None)
        elif spec.mixer == "mla":
            x = x + attention.mla_attention(
                params["attn"], h, cfg, positions=positions,
                cache=cache["attn"] if cache is not None else None,
                prefill=prefill)
        else:
            x = x + attention.gqa_attention(
                params["attn"], h, cfg, positions=positions, causal=causal,
                cache=cache["attn"] if cache is not None else None,
                block_kv=cfg.attn_block_kv, prefill=prefill)
    if spec.cross:
        h = _norm(x, params["norm_cross"], cfg)
        x = x + attention.gqa_attention(
            params["cross"], h, cfg, positions=positions, causal=False,
            cache=cache["cross"] if cache is not None else None,
            prefill=prefill, kv_input=enc_out if enc_out is not None else h,
            cross_cached=cross_cached)
    aux = x.new_zeros((), dtype=torch.float32)
    if spec.ffn != "none":
        with obs.span(f"layer.{spec.ffn}"):
            h = _norm(x, params["norm_ffn"], cfg)
            if spec.ffn == "moe":
                out, aux = moe_lib.moe_apply(params["moe"], h, cfg,
                                             ep_ranks=ep_ranks)
            else:
                mlp = layers.gelu_mlp if cfg.act == "gelu" else layers.swiglu
                out = mlp(h, params["mlp"])
            x = x + out
    return logical_constraint(x, "batch", "seq", "embed"), aux


def init_block_cache(spec: LayerSpec, cfg, batch: int, max_seq: int, dtype,
                     device, enc_len: int = 0) -> dict:
    if spec.mixer == "mamba":
        c = {"mamba": ssm.init_mamba2_cache(cfg, batch, dtype, device)}
    elif spec.mixer == "mla":
        c = {"attn": attention.init_mla_cache(cfg, batch, max_seq, dtype,
                                              device)}
    else:
        c = {"attn": attention.init_gqa_cache(cfg, batch, max_seq, dtype,
                                              device)}
    if spec.cross:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


def block_cache_spec(spec: LayerSpec, cfg) -> dict:
    if spec.mixer == "mamba":
        c = {"mamba": ssm.mamba2_cache_spec(cfg)}
    elif spec.mixer == "mla":
        c = {"attn": attention.mla_cache_spec(cfg)}
    else:
        c = {"attn": attention.gqa_cache_spec(cfg)}
    if spec.cross:
        c["cross"] = {"k": ("batch", None, "kv_heads", None),
                      "v": ("batch", None, "kv_heads", None)}
    return c


def init_stack(gen, cfg, device, plan: list[LayerSpec] | None = None) -> dict:
    plan = plan if plan is not None else layer_plan(cfg)
    prefix, period = stage_plan(plan)
    count = (len(plan) - prefix) // period
    params: dict = {"prefix": [init_block(gen, plan[i], cfg, device)
                               for i in range(prefix)]}
    if count:
        # each layer's leaves are drawn in order and copied into their slot
        # of the stacked leaves, so at most one layer is held twice
        scan: dict = {}
        for c in range(count):
            for j in range(period):
                blk = init_block(gen, plan[prefix + j], cfg, device)
                if c == 0:
                    scan[f"l{j}"] = tree_map(
                        lambda t: t.new_empty((count,) + tuple(t.shape)),
                        blk)
                tree_map(lambda dst, t: dst[c].copy_(t), scan[f"l{j}"], blk)
                del blk
        params["scan"] = scan
    return params


def stack_spec(cfg, plan: list[LayerSpec] | None = None) -> dict:
    """The stack's parameter spec tree: the prefix blocks', then the
    scanned blocks' with a leading (stacked, unsharded) layer axis."""
    plan = plan if plan is not None else layer_plan(cfg)
    prefix, period = stage_plan(plan)
    count = (len(plan) - prefix) // period
    spec: dict = {"prefix": [block_spec(plan[i], cfg) for i in range(prefix)]}
    if count:
        spec["scan"] = map_specs(
            lambda names: (None, *names),
            {f"l{j}": block_spec(plan[prefix + j], cfg)
             for j in range(period)})
    return spec


def stack_compute_dtype_leaves(cfg, plan: list[LayerSpec] | None = None
                               ) -> list[tuple]:
    """:func:`block_compute_dtype_leaves` of every block, as paths in the
    stack's parameter tree (a scanned leaf holds every period's layer)."""
    plan = plan if plan is not None else layer_plan(cfg)
    prefix, period = stage_plan(plan)
    count = (len(plan) - prefix) // period
    paths = [("prefix", i) + p for i in range(prefix)
             for p in block_compute_dtype_leaves(plan[i], cfg)]
    if count:
        paths += [("scan", f"l{j}") + p for j in range(period)
                  for p in block_compute_dtype_leaves(plan[prefix + j], cfg)]
    return paths


def init_stack_cache(cfg, batch: int, max_seq: int, dtype, device,
                     enc_len: int = 0, plan: list[LayerSpec] | None = None
                     ) -> dict:
    plan = plan if plan is not None else layer_plan(cfg)
    prefix, period = stage_plan(plan)
    count = (len(plan) - prefix) // period
    cache: dict = {
        "step": torch.zeros((batch,), dtype=torch.int32, device=device),
        "prefix": [init_block_cache(plan[i], cfg, batch, max_seq, dtype,
                                    device, enc_len) for i in range(prefix)]}
    if count:
        blk = {f"l{j}": init_block_cache(plan[prefix + j], cfg, batch,
                                         max_seq, dtype, device, enc_len)
               for j in range(period)}
        cache["scan"] = tree_map(
            lambda t: t[None].repeat((count,) + (1,) * t.dim()), blk)
    return cache


def stack_cache_spec(cfg, plan: list[LayerSpec] | None = None) -> dict:
    plan = plan if plan is not None else layer_plan(cfg)
    prefix, period = stage_plan(plan)
    count = (len(plan) - prefix) // period
    spec: dict = {"step": ("batch",),
                  "prefix": [block_cache_spec(plan[i], cfg)
                             for i in range(prefix)]}
    if count:
        # scanned leaves get a leading (stacked) layer axis
        spec["scan"] = {
            f"l{j}": {part: {leaf: (None, *names) for leaf, names in
                             sub.items()} for part, sub in
                      block_cache_spec(plan[prefix + j], cfg).items()}
            for j in range(period)}
    return spec


def _period_slices(tree: dict, count: int) -> list[dict]:
    """``count`` trees of the stacked ``tree``'s structure, the ``c``-th
    holding every leaf's ``c``-th slice, taken by one unbind per leaf:
    its backward stacks the periods' gradients once, where a ``p[c]`` per
    period gives each period a zero-filled whole-stack gradient and the
    backward a whole-stack add per period to sum them."""
    if isinstance(tree, dict):
        subs = {k: _period_slices(v, count) for k, v in tree.items()}
        return [{k: s[c] for k, s in subs.items()} for c in range(count)]
    return torch.unbind(tree)


def apply_stack(params: dict, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, causal: bool = True,
                plan: list[LayerSpec] | None = None, ep_ranks: int = 1,
                cache: dict | None = None, prefill: bool = False,
                enc_out: torch.Tensor | None = None,
                cross_cached: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the full stack.  Returns ``(x, aux_loss_sum)``.  With ``cache``
    every block reads and writes its slice in place and ``cache['step']``
    advances by the sequence length; ``enc_out`` and ``cross_cached`` go to
    the cross-attention of an enc-dec decoder."""
    plan = plan if plan is not None else layer_plan(cfg)
    prefix, period = stage_plan(plan)
    count = (len(plan) - prefix) // period
    aux_total = x.new_zeros((), dtype=torch.float32)

    def run(p, spec, x, aux, sub):
        x, a = apply_block(p, spec, x, cfg, positions=positions,
                           causal=causal, ep_ranks=ep_ranks, cache=sub,
                           prefill=prefill, enc_out=enc_out,
                           cross_cached=cross_cached)
        return x, aux + a

    for i in range(prefix):
        x, aux_total = run(params["prefix"][i], plan[i], x, aux_total,
                           cache["prefix"][i] if cache is not None else None)
    specs = plan[prefix:prefix + period]

    def apply_period(x, aux, block, bcache):
        for j, spec in enumerate(specs):
            x, aux = run(block[f"l{j}"], spec, x, aux,
                         bcache[f"l{j}"] if bcache is not None else None)
        return x, aux

    def remat_period(x, aux, *ps):
        return apply_period(x, aux, unflatten(params["scan"], list(ps)), None)

    # rematerialize only a forward that autograd records (never a serving
    # call: those carry a cache or run without grad)
    remat = (count > 0 and cfg.remat == "block" and cache is None
             and torch.is_grad_enabled()
             and (x.requires_grad or any(
                 p.requires_grad for p in leaves(params["scan"]))))
    blocks, bcaches = [], [None] * count
    if count:
        # the periods' parameter slices are taken outside the checkpoint
        # and handed in as its arguments
        with obs.span("stack.slice"):
            blocks = _period_slices(params["scan"], count)
            if cache is not None:
                bcaches = [tree_map(lambda t: t[c], cache["scan"])
                           for c in range(count)]
    for block, bcache in zip(blocks, bcaches):
        if remat:
            # non-reentrant: the step differentiates with autograd.grad,
            # and the first forward runs with grad (a Mamba2 block then
            # takes ssd_chunked in both passes); nothing in a period draws
            # random numbers, so no RNG state is kept
            x, aux_total = checkpoint(
                remat_period, x, aux_total, *leaves(block),
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux_total = apply_period(x, aux_total, block, bcache)
    if cache is not None:
        cache["step"] += x.shape[1]
    return x, aux_total


__all__ = ["LayerSpec", "layer_plan", "stage_plan", "init_block",
           "block_spec", "block_compute_dtype_leaves", "apply_block",
           "init_block_cache", "block_cache_spec", "init_stack", "stack_spec",
           "stack_compute_dtype_leaves", "apply_stack", "init_stack_cache",
           "stack_cache_spec"]
