"""Top-level model API: ``build_model(cfg)`` → ``init`` / ``forward`` /
``loss`` / ``init_cache`` / ``prefill`` / ``decode_step``, one class for
all ten architectures; the enc-dec encoder and the VLM patch prefix are
dispatched from the config.

Batch conventions: train ``{"tokens": (B, S) int64, "labels": (B, S)
int64, ["frames" | "patches"]}``; prefill ``{"tokens": (B, S), ["frames" |
"patches"]}``; decode tokens (B, 1) + cache.  The modality frontends of the
[audio] and [vlm] archs are stubs, as in the JAX package: ``frames`` (B, L,
d_model) and ``patches`` (B, vlm_prefix, d_model) are precomputed
embeddings.  The cache is written in place and returned, where the JAX
package returns a new one.
Parameters are a plain dict tree with the JAX package's names and layouts
(``repro_torch.convert.params_from_jax`` carries reference weights over).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, transformer
from repro_torch.models.transformer import LayerSpec
from repro_torch.sharding import logical_constraint


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    #: expert-parallel ranks of the MoE layers under ``ep_mode="rma"`` (the
    #: size of the JAX package's expert mesh axis)
    ep_ranks: int = 1

    @cached_property
    def plan(self) -> list[LayerSpec]:
        return transformer.layer_plan(self.cfg)

    @cached_property
    def enc_plan(self) -> list[LayerSpec]:
        return [LayerSpec(mixer="gqa", ffn="dense", cross=False)] * \
            self.cfg.enc_layers

    def init(self, seed: int = 0, *, device="cuda") -> dict:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        target device), on the card unless ``device="cpu"``."""
        dev = resolve_device(device)
        cfg = self.cfg
        gen = None
        if dev.type != "meta":   # shape-only builds draw no numbers
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        pd = cfg.parameter_dtype
        params = {
            "embed": layers.init_embed(gen, cfg.vocab_padded, cfg.d_model,
                                       pd, dev),
            "stack": transformer.init_stack(gen, cfg, dev, self.plan),
            "final_norm": transformer._norm_init(cfg, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.init_lm_head(gen, cfg.d_model,
                                                    cfg.vocab_padded, pd, dev)
        if cfg.enc_layers:
            params["encoder"] = {
                "stack": transformer.init_stack(gen, cfg, dev, self.enc_plan),
                "final_norm": transformer._norm_init(cfg, dev),
                "pos": layers.init_learned_pos(gen, cfg.max_seq, cfg.d_model,
                                               pd, dev),
            }
            params["dec_pos"] = layers.init_learned_pos(
                gen, cfg.max_seq, cfg.d_model, pd, dev)
        return params

    def param_specs(self) -> dict:
        """The parameter tree's logical-axis specs (one tuple of names a
        leaf), the JAX package's."""
        cfg = self.cfg
        spec = {
            "embed": layers.embed_spec(),
            "stack": transformer.stack_spec(cfg, self.plan),
            "final_norm": transformer._norm_spec(cfg),
        }
        if not cfg.tie_embeddings:
            spec["lm_head"] = layers.lm_head_spec()
        if cfg.enc_layers:
            spec["encoder"] = {
                "stack": transformer.stack_spec(cfg, self.enc_plan),
                "final_norm": transformer._norm_spec(cfg),
                "pos": layers.learned_pos_spec(),
            }
            spec["dec_pos"] = layers.learned_pos_spec()
        return spec

    def compute_dtype_leaves(self) -> list[tuple]:
        """Paths of the decoder stack's leaves that every read casts whole
        to ``cfg.activation_dtype``: the leaves a server may hold in that
        dtype.  The embedding table is gathered before its cast; the
        head, the norms' scales and the router are read in float32."""
        return [("stack",) + p for p in
                transformer.stack_compute_dtype_leaves(self.cfg, self.plan)]

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        """Token embeddings; a VLM's precomputed ``patches`` replace the
        first ``vlm_prefix`` positions, an enc-dec decoder adds its learned
        positions."""
        cfg = self.cfg
        dt = cfg.activation_dtype
        x = layers.embed(batch["tokens"], params["embed"], dt)
        if cfg.vlm_prefix and "patches" in batch:
            patches = batch["patches"].to(dt)
            x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
        if cfg.enc_layers:
            x = layers.add_learned_pos(x, params["dec_pos"])
        return logical_constraint(x, "batch", "seq", "embed")

    def _encode(self, params, frames: torch.Tensor, *,
                prefill: bool = False) -> torch.Tensor:
        """The whisper-style encoder over precomputed frame embeddings (the
        conv frontend is a stub); ``prefill`` runs its self-attention
        through K7."""
        cfg = self.cfg
        enc = params["encoder"]
        x = layers.add_learned_pos(frames.to(cfg.activation_dtype),
                                   enc["pos"])
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        x, _ = transformer.apply_stack(enc["stack"], x, cfg,
                                       positions=positions, causal=False,
                                       plan=self.enc_plan, prefill=prefill)
        return transformer._norm(x, enc["final_norm"], cfg)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with obs.span("model.head"):
            x = transformer._norm(x, params["final_norm"], cfg)
            if cfg.tie_embeddings:
                logits = layers.unembed(x, params["embed"])
            else:
                logits = layers.lm_head(x, params["lm_head"])
            if cfg.vocab_padded != cfg.vocab:
                lane = torch.arange(cfg.vocab_padded,
                                    device=x.device) < cfg.vocab
                logits = torch.where(lane, logits,
                                     logits.new_full((), -1e30))
        return logical_constraint(logits, "batch", "seq", "vocab")

    def forward(self, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward; returns float32 logits and the summed MoE
        aux loss."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        enc_out = (self._encode(params, batch["frames"]) if cfg.enc_layers
                   else None)
        x, aux = transformer.apply_stack(params["stack"], x, cfg,
                                         positions=positions, causal=True,
                                         plan=self.plan,
                                         ep_ranks=self.ep_ranks,
                                         enc_out=enc_out)
        return self._logits(params, x), aux

    # -- serving ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   enc_len: int = 0, *, device="cuda") -> dict:
        """A zeroed stack cache for ``batch`` rows of ``max_seq`` tokens in
        ``dtype`` (default the activation dtype), with ``enc_len`` encoder
        rows of cross-attention k/v in an enc-dec decoder, on the card
        unless ``device="cpu"``."""
        dev = resolve_device(device)
        dtype = dtype if dtype is not None else self.cfg.activation_dtype
        return transformer.init_stack_cache(self.cfg, batch, max_seq, dtype,
                                            dev, enc_len=enc_len,
                                            plan=self.plan)

    def cache_specs(self) -> dict:
        return transformer.stack_cache_spec(self.cfg, self.plan)

    def prefill(self, params, batch, cache) -> tuple[torch.Tensor, dict]:
        """Process the prompt into a fresh cache (rows at position 0, as the
        JAX package's prefill assumes: its positions start at 0); attention
        runs through K7 (an enc-dec's encoder and cross-attention too, and
        the cross k/v are memoized into the cache), a Mamba2 block's scan
        through K8 and the SSD pass; MLA through its torch products.
        Returns (last-position float32 logits, cache)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        enc_out = (self._encode(params, batch["frames"], prefill=True)
                   if cfg.enc_layers else None)
        x, _ = transformer.apply_stack(params["stack"], x, cfg,
                                       positions=positions, causal=True,
                                       plan=self.plan, ep_ranks=self.ep_ranks,
                                       cache=cache, prefill=True,
                                       enc_out=enc_out)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params, cache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens (B, 1) against the cache."""
        cfg = self.cfg
        pos = self._cache_pos(cache)
        positions = pos.long()[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device)[None, :]
        x = layers.embed(tokens, params["embed"], cfg.activation_dtype)
        if cfg.enc_layers:
            # per-row learned positions: a gather, not a slice
            x = x + params["dec_pos"]["pos"][positions].to(x.dtype)
        x, _ = transformer.apply_stack(params["stack"], x, cfg,
                                       positions=positions, causal=True,
                                       plan=self.plan, ep_ranks=self.ep_ranks,
                                       cache=cache,
                                       cross_cached=bool(cfg.enc_layers))
        return self._logits(params, x), cache

    def _cache_pos(self, cache) -> torch.Tensor:
        """Per-row sequence positions (the top-level step counter, (B,))."""
        return cache["step"]

    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """Mean next-token cross-entropy over labels >= 0, plus 0.01 × the
        MoE aux loss."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1,
                          labels.long().clamp(min=0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        xent = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return xent + 0.01 * aux, {"xent": xent, "aux": aux}


def build_model(cfg: ModelConfig, *, ep_ranks: int = 1) -> Model:
    """The model of ``cfg``; ``ep_ranks`` stacked expert-parallel ranks
    carry its MoE layers under ``ep_mode="rma"`` (it must divide
    ``num_experts``)."""
    if ep_ranks < 1 or (cfg.moe is not None
                        and cfg.moe.num_experts % ep_ranks):
        raise ValueError(f"ep_ranks={ep_ranks} must be >= 1 and divide the "
                         "number of experts")
    return Model(cfg, ep_ranks)


__all__ = ["Model", "build_model"]
