"""Reduced same-family configs for tests and examples: ``tiny_config(arch)``
keeps the structure of the architecture (family, qk-norm, GQA ratio, norm
and activation kinds) and shrinks widths and depth, exactly as the JAX
package's ``tiny_config`` does for the dense family."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, get_config


def tiny_config(arch: str, *, dtype: str = "float32") -> ModelConfig:
    cfg = get_config(arch)
    kw: dict = dict(
        d_model=64, d_ff=128, vocab=256, max_seq=256,
        dtype=dtype, param_dtype="float32",
        n_layers=2,
    )
    if cfg.n_heads > 1:
        kw.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
                  head_dim=16)
    return cfg.replace(**kw)


__all__ = ["tiny_config"]
