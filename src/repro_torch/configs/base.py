"""Model configuration and the architecture registry: the JAX package's
``ModelConfig`` fields that its ten architectures read — dense, MoE (with
multi-head latent attention for DeepSeek), pure-SSM, hybrid (Mamba2 +
attention), enc-dec and VLM — with torch dtypes."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.kernels.common import as_dtype


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    renorm_gates: bool = True
    #: every `interleave_step`-th layer is MoE (1 = all layers);
    #: offset chooses which residue is MoE.
    interleave_step: int = 1
    interleave_offset: int = 0
    #: first `first_dense` layers use a dense FFN instead (DeepSeek).
    first_dense: int = 0
    d_ff_first_dense: int = 0
    #: expert-parallel dispatch: "gspmd" is the single-program sort
    #: dispatch; "rma" runs it over stacked expert-parallel ranks through
    #: the one-sided declared all-to-all (repro_torch.core.rma.alltoall).
    ep_mode: str = "gspmd"
    #: lowering backend of the "rma" dispatch/combine plans: "rma" (the
    #: substrate, K4/K6), "gspmd" (the exchange as one block transpose) or
    #: "auto" (the faster of the two in the table measured on the card)
    ep_backend: str = "rma"

    def capacity(self, tokens: int) -> int:
        c = math.ceil(tokens * self.top_k * self.capacity_factor / self.num_experts)
        return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 64
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_bias: bool = False
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "swiglu"        # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    max_seq: int = 8192
    #: S_q*S_k above which online-softmax blockwise attention replaces
    #: materialized scores
    blockwise_threshold: int = 2048 * 2048
    attn_impl: str = "auto"    # auto | full | blockwise
    attn_block_kv: int = 1024
    # hybrid (jamba): layer i is attention iff i % hybrid_period == hybrid_attn_offset
    hybrid_period: int = 0
    hybrid_attn_offset: int = 0
    # enc-dec (whisper)
    enc_layers: int = 0
    # vlm stub: number of prefix positions fed as precomputed patch embeddings
    vlm_prefix: int = 0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    #: "block" rematerializes each scanned period in the backward (the
    #: reference's default); "none" keeps every activation
    remat: str = "block"       # none | block
    #: sub-quadratic decode memory (SSM/hybrid) — eligible for long_500k
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding/LM-head rows: vocab padded to a multiple of 256; logit
        pad lanes are masked, never sliced."""
        return -(-self.vocab // 256) * 256

    @property
    def activation_dtype(self) -> torch.dtype:
        return as_dtype(self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return as_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One dry-run shape: sequence length, global batch and step kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.archs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs.archs  # noqa: F401
    return sorted(_REGISTRY)


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell, and why not if not."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention architecture: 512k-token decode "
                       "requires sub-quadratic attention (documented skip)")
    return True, ""


__all__ = ["MoEConfig", "MLAConfig", "SSMConfig", "ModelConfig",
           "ShapeConfig", "SHAPES", "register", "get_config", "list_archs",
           "cell_is_runnable"]
