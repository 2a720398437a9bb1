"""Reduced same-family configs for tests and examples: ``tiny_config(arch)``
keeps the structure of the architecture (family, qk-norm, GQA ratio, norm
and activation kinds, MLA, MoE interleave, SSM state, hybrid period,
enc-dec, VLM prefix) and shrinks widths, depth and experts, exactly as the
JAX package's ``tiny_config`` does: a hybrid stack keeps one whole period of
layers, an enc-dec one 2 encoder layers, a VLM a 4-position prefix."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, get_config


def tiny_config(arch: str, *, dtype: str = "float32") -> ModelConfig:
    cfg = get_config(arch)
    kw: dict = dict(
        d_model=64, d_ff=128, vocab=256, max_seq=256,
        dtype=dtype, param_dtype="float32",
        n_layers=cfg.hybrid_period if cfg.hybrid_period else 2,
    )
    if cfg.n_heads > 1:
        kw.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
                  head_dim=16)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora=32, kv_lora=32, qk_nope=16, qk_rope=8,
                              v_head=16)
        kw.update(n_heads=4, n_kv_heads=4, head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(2, cfg.moe.top_k),
            d_ff_expert=64, d_ff_shared=64, d_ff_first_dense=128,
            first_dense=min(1, cfg.moe.first_dense),
            capacity_factor=8.0,  # ample: no drops, so oracles match exactly
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, headdim=16, chunk=8)
    if cfg.enc_layers:
        kw["enc_layers"] = 2
    if cfg.vlm_prefix:
        kw["vlm_prefix"] = 4
    return cfg.replace(**kw)


__all__ = ["tiny_config"]
