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
view of its slice, so the cache is written in place.  ``block_parts`` alone
decides a block's parts; every block and stack walker maps over them."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

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


def _d_ff(cfg) -> int:
    """A dense FFN's width (``d_ff_first_dense`` beside dense-first MoE)."""
    mo = cfg.moe
    if mo is not None and mo.first_dense and mo.d_ff_first_dense:
        return mo.d_ff_first_dense
    return cfg.d_ff


def _cross_cache(cfg, batch, max_seq, dtype, device, enc_len):
    shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paths(names, *where) -> tuple:
    return tuple(where + (name,) for name in sorted(names))


@dataclasses.dataclass(frozen=True)
class _Kind:
    """A kind of block part: its parameters' init and spec, the paths in
    them of the leaves every read casts whole to the compute dtype (each
    module's set, kept beside its casts; a path the part lacks names
    nothing), and a mixer's cache init and spec."""
    init: Callable
    spec: Callable
    compute_dtype: tuple = ()
    cache: Callable | None = None
    cache_spec: Callable | None = None


_KINDS = {
    "norm": _Kind(lambda gen, cfg, device: _norm_init(cfg, device),
                  _norm_spec),
    "gqa": _Kind(attention.init_gqa, attention.gqa_spec,
                 _paths(attention.GQA_COMPUTE_DTYPE),
                 lambda cfg, b, s, dt, dev, _: attention.init_gqa_cache(
                     cfg, b, s, dt, dev),
                 attention.gqa_cache_spec),
    "mla": _Kind(attention.init_mla, attention.mla_spec,
                 _paths(attention.MLA_COMPUTE_DTYPE),
                 lambda cfg, b, s, dt, dev, _: attention.init_mla_cache(
                     cfg, b, s, dt, dev),
                 attention.mla_cache_spec),
    "mamba": _Kind(ssm.init_mamba2, ssm.mamba2_spec,
                   _paths(ssm.MAMBA2_COMPUTE_DTYPE),
                   lambda cfg, b, s, dt, dev, _: ssm.init_mamba2_cache(
                       cfg, b, dt, dev),
                   ssm.mamba2_cache_spec),
    # a GQA over the encoder output, its k/v cached for enc_len rows
    "cross": _Kind(attention.init_gqa, attention.gqa_spec,
                   _paths(attention.GQA_COMPUTE_DTYPE), _cross_cache,
                   lambda cfg: {"k": ("batch", None, "kv_heads", None),
                                "v": ("batch", None, "kv_heads", None)}),
    "moe": _Kind(moe_lib.init_moe, moe_lib.moe_spec,
                 _paths(moe_lib.MOE_COMPUTE_DTYPE)
                 + _paths(layers.SWIGLU_COMPUTE_DTYPE, "shared")),
    "gelu": _Kind(lambda gen, cfg, device: layers.init_gelu_mlp(
                      gen, cfg.d_model, _d_ff(cfg), cfg.parameter_dtype,
                      device, bias=cfg.attn_bias),
                  lambda cfg: layers.gelu_mlp_spec(bias=cfg.attn_bias),
                  _paths(layers.GELU_MLP_COMPUTE_DTYPE)),
    "swiglu": _Kind(lambda gen, cfg, device: layers.init_swiglu(
                        gen, cfg.d_model, _d_ff(cfg), cfg.parameter_dtype,
                        device),
                    lambda cfg: layers.swiglu_spec(),
                    _paths(layers.SWIGLU_COMPUTE_DTYPE)),
}


def block_parts(spec: LayerSpec, cfg) -> list[tuple[str, str]]:
    """The ordered ``(key, kind)`` parts of one block, the one place that
    decides them: ``norm_mixer`` and the mixer (``attn``: GQA or MLA, or
    ``mamba``), in an enc-dec decoder ``norm_cross`` and ``cross``, then
    ``norm_ffn`` and ``mlp`` (GELU or SwiGLU) or ``moe``, if any FFN."""
    parts = [("norm_mixer", "norm"),
             ("mamba", "mamba") if spec.mixer == "mamba"
             else ("attn", spec.mixer)]
    if spec.cross:
        parts += [("norm_cross", "norm"), ("cross", "cross")]
    if spec.ffn != "none":
        parts += [("norm_ffn", "norm"),
                  ("moe", "moe") if spec.ffn == "moe"
                  else ("mlp", "gelu" if cfg.act == "gelu" else "swiglu")]
    return parts


def _kinds(spec: LayerSpec, cfg) -> list[tuple[str, _Kind]]:
    return [(key, _KINDS[kind]) for key, kind in block_parts(spec, cfg)]


def init_block(gen, spec: LayerSpec, cfg, device) -> dict:
    return {key: k.init(gen, cfg, device) for key, k in _kinds(spec, cfg)}


def block_spec(spec: LayerSpec, cfg) -> dict:
    """The logical-axis spec tree of one block's parameters."""
    return {key: k.spec(cfg) for key, k in _kinds(spec, cfg)}


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
    aux = x.new_zeros((), dtype=torch.float32)
    parts = block_parts(spec, cfg)
    for (norm, _), (key, kind) in zip(parts[::2], parts[1::2]):
        span = {"norm_mixer": spec.mixer, "norm_ffn": spec.ffn}.get(norm)
        with obs.span(f"layer.{span}") if span else contextlib.nullcontext():
            h = _norm(x, params[norm], cfg)
            p, c = params[key], cache.get(key) if cache is not None else None
            if kind == "mamba":
                out = ssm.mamba2_apply(p, h, cfg, cache=c)
            elif kind == "mla":
                out = attention.mla_attention(p, h, cfg, positions=positions,
                                              cache=c, prefill=prefill)
            elif kind == "gqa":
                out = attention.gqa_attention(
                    p, h, cfg, positions=positions, causal=causal, cache=c,
                    block_kv=cfg.attn_block_kv, prefill=prefill)
            elif kind == "cross":
                out = attention.gqa_attention(
                    p, h, cfg, positions=positions, causal=False, cache=c,
                    prefill=prefill,
                    kv_input=enc_out if enc_out is not None else h,
                    cross_cached=cross_cached)
            elif kind == "moe":
                out, aux = moe_lib.moe_apply(p, h, cfg, ep_ranks=ep_ranks)
            else:
                out = (layers.gelu_mlp if kind == "gelu" else layers.swiglu)(
                    h, p)
            x = x + out
    return logical_constraint(x, "batch", "seq", "embed"), aux


def init_block_cache(spec: LayerSpec, cfg, batch: int, max_seq: int, dtype,
                     device, enc_len: int = 0) -> dict:
    return {key: k.cache(cfg, batch, max_seq, dtype, device, enc_len)
            for key, k in _kinds(spec, cfg) if k.cache}


def block_cache_spec(spec: LayerSpec, cfg) -> dict:
    return {key: k.cache_spec(cfg) for key, k in _kinds(spec, cfg)
            if k.cache_spec}


def _stages(cfg, plan) -> tuple[list[LayerSpec], int, int, int]:
    """``plan`` (default ``layer_plan(cfg)``), prefix, period, count."""
    plan = plan if plan is not None else layer_plan(cfg)
    prefix, period = stage_plan(plan)
    return plan, prefix, period, (len(plan) - prefix) // period


def _per_stage(cfg, plan, fn: Callable) -> tuple[list, dict, int]:
    """``fn`` of each prefix block's spec, of each of a period's keyed
    ``l{j}`` (``{}`` when no period is scanned), and the period count."""
    plan, prefix, period, count = _stages(cfg, plan)
    return ([fn(plan[i]) for i in range(prefix)],
            {f"l{j}": fn(plan[prefix + j]) for j in range(period)}
            if count else {}, count)


def init_stack(gen, cfg, device, plan: list[LayerSpec] | None = None) -> dict:
    plan, prefix, period, count = _stages(cfg, plan)
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


def _stacked_spec(cfg, plan, block_fn: Callable) -> dict:
    prefix, scan, count = _per_stage(cfg, plan, block_fn)
    spec: dict = {"prefix": prefix}
    if count:
        # scanned leaves get a leading (stacked, unsharded) layer axis
        spec["scan"] = map_specs(lambda names: (None, *names), scan)
    return spec


def stack_spec(cfg, plan: list[LayerSpec] | None = None) -> dict:
    """The stack's parameter spec tree: the prefix blocks', then the
    scanned blocks' with a leading (stacked, unsharded) layer axis."""
    return _stacked_spec(cfg, plan, lambda spec: block_spec(spec, cfg))


def stack_compute_dtype_leaves(cfg, plan: list[LayerSpec] | None = None
                               ) -> list[tuple]:
    """Paths in the stack's parameter tree of the leaves that every read
    casts whole to the compute dtype, each block's in the order of its
    parts (a scanned leaf holds every period's layer)."""
    prefix, scan, _ = _per_stage(cfg, plan, lambda spec: [
        (key,) + path for key, k in _kinds(spec, cfg)
        for path in k.compute_dtype])
    return ([("prefix", i) + p for i, ps in enumerate(prefix) for p in ps]
            + [("scan", name) + p for name, ps in scan.items() for p in ps])


def init_stack_cache(cfg, batch: int, max_seq: int, dtype, device,
                     enc_len: int = 0, plan: list[LayerSpec] | None = None
                     ) -> dict:
    step = torch.zeros((batch,), dtype=torch.int32, device=device)
    prefix, scan, count = _per_stage(cfg, plan, lambda spec: init_block_cache(
        spec, cfg, batch, max_seq, dtype, device, enc_len))
    cache: dict = {"step": step, "prefix": prefix}
    if count:
        cache["scan"] = tree_map(
            lambda t: t[None].repeat((count,) + (1,) * t.dim()), scan)
    return cache


def stack_cache_spec(cfg, plan: list[LayerSpec] | None = None) -> dict:
    return {"step": ("batch",), **_stacked_spec(
        cfg, plan, lambda spec: block_cache_spec(spec, cfg))}


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
    plan, prefix, period, count = _stages(cfg, plan)
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


__all__ = ["LayerSpec", "layer_plan", "stage_plan", "block_parts",
           "init_block", "block_spec", "apply_block",
           "init_block_cache", "block_cache_spec", "init_stack", "stack_spec",
           "stack_compute_dtype_leaves", "apply_stack", "init_stack_cache",
           "stack_cache_spec"]
