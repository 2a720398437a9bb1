"""Shape-only stand-ins and step builders for every dry-run cell.

A :class:`ShapeDtypeStruct` is a tensor on the ``meta`` device (shape and
dtype, no storage) paired with its :class:`~repro_torch.sharding.NamedSharding`.
``input_specs(cfg, shape, rules)`` gives them for every model input, and
``build_cell`` assembles the (step_fn, argument stand-ins) pair that
``dryrun.py`` runs on ``meta``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.sharding import NamedSharding, ShardingRules, spec_to_sharding
from repro_torch.train.optimizer import (OptimizerConfig, init_opt_state,
                                         opt_state_specs)
from repro_torch.train.trainstep import make_train_step
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """A ``meta`` tensor and its sharding over the cell's mesh."""
    meta: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype

    @property
    def shard_shape(self) -> tuple[int, ...]:
        return self.sharding.shard_shape(self.shape)

    @property
    def shard_bytes(self) -> int:
        """Bytes of one device's shard."""
        return math.prod(self.shard_shape) * self.meta.element_size()


SDS = ShapeDtypeStruct


def meta_tensors(tree):
    """The ``meta`` tensors of a tree of stand-ins (what a step is run on)."""
    return tree_map(lambda x: x.meta if isinstance(x, SDS) else x, tree)


def sds_leaves(tree) -> list[ShapeDtypeStruct]:
    return [x for x in leaves(tree) if isinstance(x, SDS)]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules) -> dict:
    """Stand-ins for the data batch of this cell (int32 tokens, as the JAX
    package's)."""
    B, S = shape.global_batch, shape.seq_len
    bsh = rules.sharding(("batch", None))
    meta = torch.device("meta")

    def sds(shp, dtype, sh):
        return SDS(torch.empty(shp, dtype=dtype, device=meta), sh)

    specs: dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = sds((B, S), torch.int32, bsh)
        specs["labels"] = sds((B, S), torch.int32, bsh)
    elif shape.kind == "prefill":
        specs["tokens"] = sds((B, S), torch.int32, bsh)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = sds((B, 1), torch.int32, bsh)
    if cfg.enc_layers and shape.kind != "decode":
        specs["frames"] = sds((B, S, cfg.d_model), cfg.activation_dtype,
                              rules.sharding(("batch", None, None)))
    if cfg.vlm_prefix and shape.kind != "decode":
        specs["patches"] = sds((B, cfg.vlm_prefix, cfg.d_model),
                               cfg.activation_dtype,
                               rules.sharding(("batch", None, None)))
    return specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules) -> dict:
    """The model-input stand-ins (the JAX package's public name)."""
    return batch_specs(cfg, shape, rules)


def param_specs_sds(model, rules: ShardingRules):
    shardings = spec_to_sharding(model.param_specs(), rules)
    return tree_map(SDS, model.init(0, device="meta"), shardings), shardings


def opt_specs_sds(model, params_sds, rules: ShardingRules):
    shardings = spec_to_sharding(opt_state_specs(model.param_specs()), rules)
    return tree_map(SDS, init_opt_state(meta_tensors(params_sds)),
                    shardings), shardings


def cache_specs_sds(model, shape: ShapeConfig, rules: ShardingRules,
                    enc_len: int = 0):
    cfg = model.cfg
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             cfg.activation_dtype, enc_len=enc_len,
                             device="meta")
    shardings = spec_to_sharding(model.cache_specs(), rules)
    return tree_map(SDS, cache, shardings), shardings


def build_cell(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules,
               *, grad_sync: str = "gspmd", accum_steps: int = 1):
    """Return (step_fn, argument stand-ins tuple, None) for this cell.

    train:   step(params, opt_state, batch)
    prefill: step(params, batch, cache)
    decode:  step(params, cache, tokens)
    """
    # production numerics: bf16 params+compute, fp32 optimizer moments
    cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg)
    enc_len = shape.seq_len if cfg.enc_layers else 0

    params_sds, _ = param_specs_sds(model, rules)
    if shape.kind == "train":
        opt_sds, _ = opt_specs_sds(model, params_sds, rules)
        batch = batch_specs(cfg, shape, rules)
        step = make_train_step(model, OptimizerConfig(), grad_sync=grad_sync,
                               accum_steps=accum_steps)
        return step, (params_sds, opt_sds, batch), None
    cache_sds, _ = cache_specs_sds(model, shape, rules, enc_len)
    batch = batch_specs(cfg, shape, rules)
    if shape.kind == "prefill":
        def prefill_step(params, batch, cache):
            return model.prefill(params, batch, cache)

        return prefill_step, (params_sds, batch, cache_sds), None

    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return serve_step, (params_sds, cache_sds, batch["tokens"]), None


__all__ = [
    "ShapeDtypeStruct", "SDS", "meta_tensors", "sds_leaves",
    "input_specs", "batch_specs", "build_cell",
    "param_specs_sds", "opt_specs_sds", "cache_specs_sds",
]
