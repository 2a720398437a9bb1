"""Gradient compression with error feedback (the JAX package's
``train/compress.py``) — for the cross-pod hop, where the network, not the
card, is the bottleneck.  Two schemes, both with error-feedback residuals
(the compression error is added back into the next step's gradient, which
keeps SGD convergent — Karimireddy et al., 2019):

* ``topk`` — keep the k largest-|g| coordinates (indices int32, as
  ``lax.top_k`` returns them, so the wire size is the reference's);
* ``int8`` — per-tensor max-abs scale, round half to even, clip ±127.

``compressed_all_reduce`` runs on the stacked layout: row r of ``g`` and
``err`` is rank r's gradient and residual, each row is compressed with its
own residual, and the restored rows are summed by the P2-ordered one-sided
ring (:func:`repro_torch.core.rma.collectives.plan_all_reduce`, kernel K5
on the card).  As in the reference, the ring carries the restored float32
values, not the compressed payload.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "int8"      # "int8" | "topk" | "none"
    topk_frac: float = 0.01   # fraction of coordinates kept by topk


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# -- int8 -------------------------------------------------------------------

def int8_compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# -- top-k ------------------------------------------------------------------

def topk_compress(g: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1)
    idx = torch.topk(flat.abs(), k).indices
    return flat[idx], idx.to(torch.int32)


def topk_decompress(kept: torch.Tensor, idx: torch.Tensor, n: int
                    ) -> torch.Tensor:
    out = torch.zeros((n,), dtype=kept.dtype, device=kept.device)
    out[idx.long()] = kept
    return out


# -- error-feedback wrapper ---------------------------------------------------

def compress_with_feedback(g: torch.Tensor, err: torch.Tensor,
                           cfg: CompressionConfig):
    """Returns ``(payload, new_err, restored)``: ``payload`` is what would
    cross the wire, ``new_err`` the residual to fold into the next step,
    ``restored`` the decompressed payload."""
    g32 = g.to(torch.float32) + err
    if cfg.scheme == "int8":
        q, scale = int8_compress(g32)
        restored = int8_decompress(q, scale)
        return (q, scale), g32 - restored, restored
    if cfg.scheme == "topk":
        n = g32.numel()
        k = max(1, int(n * cfg.topk_frac))
        kept, idx = topk_compress(g32, k)
        restored = topk_decompress(kept, idx, n).reshape(g32.shape)
        return (kept, idx), g32 - restored, restored
    return g32, torch.zeros_like(g32), g32


def compression_ratio(g: torch.Tensor, payload) -> float:
    """Wire bytes / raw fp32 bytes."""
    raw = g.numel() * 4
    parts = payload if isinstance(payload, tuple) else (payload,)
    return sum(p.numel() * p.element_size() for p in parts) / raw


def compressed_all_reduce(g: torch.Tensor, err: torch.Tensor,
                          cfg: CompressionConfig, axis: str, axis_size: int):
    """Error-feedback compressed all-reduce of the stacked ``g`` (``(n,
    ...)``, row r rank r's gradient; ``err`` its residuals, same shape).
    Each row is compressed with its own residual; only the restored rows
    enter the ring's sum, so every rank applies the same update and the
    residuals stay local.  Returns ``(reduced / n, new_err)``, both
    stacked."""
    from repro_torch.core.rma.collectives import plan_all_reduce

    n = axis_size
    if g.shape[0] != n or err.shape != g.shape:
        raise ValueError(f"compressed_all_reduce expects stacked g and err "
                         f"of leading dim {n}, got {tuple(g.shape)} and "
                         f"{tuple(err.shape)}")
    restored = torch.empty((n, g[0].numel()), dtype=torch.float32,
                           device=g.device)
    new_err = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    for r in range(n):
        _, e, rest = compress_with_feedback(g[r], err[r], cfg)
        new_err[r] = e
        restored[r] = rest.reshape(-1)
        del e, rest
    reduced = plan_all_reduce(restored, axis, n, order=True, donate=True)
    return reduced.reshape(g.shape) / n, new_err


__all__ = [
    "CompressionConfig", "init_error_state",
    "int8_compress", "int8_decompress",
    "topk_compress", "topk_decompress",
    "compress_with_feedback", "compressed_all_reduce", "compression_ratio",
]
