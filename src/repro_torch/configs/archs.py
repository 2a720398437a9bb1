"""The ten architectures, exactly as the JAX package registers them
(``repro/configs/archs.py``; sources and tiers noted inline)."""
from __future__ import annotations

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig, register)


@register("whisper-base")
def whisper_base() -> ModelConfig:
    """[audio] enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

    6L per stack (encoder + decoder), d=512, 8H (kv=8), ff=2048, vocab=51865.
    LayerNorm + GeLU + biases, learned positions (no RoPE).
    """
    return ModelConfig(
        name="whisper-base", family="encdec",
        n_layers=6, enc_layers=6,
        d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
        rope_theta=0.0, norm="layernorm", act="gelu", attn_bias=True,
        norm_eps=1e-5, max_seq=32768,  # learned-pos tables
    )


@register("internvl2-1b")
def internvl2_1b() -> ModelConfig:
    """[vlm] InternViT frontend STUB + InternLM2-style LM [arXiv:2404.16821; hf].

    24L, d=896, 14H (GQA kv=2), ff=4864, vocab=151655.
    """
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151655,
        rope_theta=1e6, vlm_prefix=256, max_seq=524288,
    )


@register("qwen3-4b")
def qwen3_4b() -> ModelConfig:
    """[dense] qk_norm + GQA [hf:Qwen/Qwen3-8B; hf].

    36L, d=2560, 32H (GQA kv=8), ff=9728, vocab=151936, head_dim=128.
    """
    return ModelConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab=151936,
        rope_theta=1e6, qk_norm=True, max_seq=524288,
    )


@register("phi3-mini-3.8b")
def phi3_mini() -> ModelConfig:
    """[dense] RoPE + SwiGLU + GQA (kv=32 → MHA) [arXiv:2404.14219; unverified].

    32L, d=3072, 32H (kv=32), ff=8192, vocab=32064.
    """
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064,
        rope_theta=1e4, max_seq=524288,
    )


@register("starcoder2-3b")
def starcoder2_3b() -> ModelConfig:
    """[dense] GQA + RoPE [arXiv:2402.19173; hf].

    30L, d=3072, 24H (GQA kv=2), ff=12288, vocab=49152.
    """
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152,
        rope_theta=1e5, norm="layernorm", act="gelu", attn_bias=True,
        norm_eps=1e-5, max_seq=524288,
    )


@register("llama3-405b")
def llama3_405b() -> ModelConfig:
    """[dense] GQA, 128k vocab [arXiv:2407.21783; unverified].

    126L, d=16384, 128H (GQA kv=8), ff=53248, vocab=128256.
    """
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab=128256,
        rope_theta=5e5, max_seq=524288,
    )


@register("mamba2-370m")
def mamba2_370m() -> ModelConfig:
    """[ssm] SSD, attention-free [arXiv:2405.21060; unverified].

    48L, d=1024, vocab=50280, d_state=128; d_ff=0 (Mamba2 blocks carry their
    own projections).  Sub-quadratic: runs long_500k.
    """
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=50280,
        rope_theta=0.0, tie_embeddings=True,
        ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=64, d_conv=4),
        subquadratic=True, max_seq=524288,
    )


@register("llama4-maverick-400b-a17b")
def llama4_maverick() -> ModelConfig:
    """[moe] 128 routed experts top-1 + 1 shared, alternating dense/MoE
    [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

    48L, d=5120, 40H (GQA kv=8), ff=8192 per expert, vocab=202048.
    """
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=16384, vocab=202048,
        rope_theta=5e5, max_seq=524288,
        moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                      n_shared=1, d_ff_shared=8192,
                      interleave_step=2, interleave_offset=1),
    )


@register("deepseek-v2-236b")
def deepseek_v2() -> ModelConfig:
    """[moe] MLA (kv_lora=512) + 2 shared + 160 routed top-6
    [arXiv:2405.04434; hf].

    60L, d=5120, 128H, expert ff=1536, vocab=102400; layer 0 dense (ff=12288,
    per the HF config).
    """
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=1536, vocab=102400,
        rope_theta=1e4, max_seq=524288,
        mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                      v_head=128),
        moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                      n_shared=2, d_ff_shared=2 * 1536,
                      interleave_step=1, interleave_offset=0,
                      first_dense=1, d_ff_first_dense=12288),
    )


@register("jamba-v0.1-52b")
def jamba_v01() -> ModelConfig:
    """[hybrid] Mamba+attention 1:7 interleave + MoE 16e top-2
    [arXiv:2403.19887; hf].

    32L, d=4096, 32H (GQA kv=8), ff=14336, vocab=65536.  Period-8 blocks:
    layer i%8==4 is attention (the published attn_layer_offset=4,
    attn_layer_period=8); every other layer's FFN is MoE
    (expert_layer_period=2, offset=1).  Sub-quadratic: runs long_500k.
    """
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=65536,
        rope_theta=0.0,  # Jamba uses no positional encoding (Mamba carries it)
        hybrid_period=8, hybrid_attn_offset=4,
        ssm=SSMConfig(d_state=16, headdim=64, expand=2, chunk=64, d_conv=4),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                      interleave_step=2, interleave_offset=1),
        subquadratic=True, max_seq=524288,
    )


__all__ = []  # populated via @register side effects
