"""AdamW + LR schedule + global-norm clipping in plain PyTorch (the JAX
package's optimizer).  Optimizer state (m, v) is float32 whatever the
parameter dtype.  Updates are applied in place — parameters, m and v —
so a full-width step holds one copy of each."""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr (float32, as the reference)."""
    step = step.float()
    warm = cfg.peak_lr * step / max(1, cfg.warmup_steps)
    decay_steps = max(1, cfg.total_steps - cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    sq = [x.float().square().sum() for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads: Any, opt_state: dict, params: Any,
                 cfg: OptimizerConfig) -> tuple[Any, dict, dict]:
    """One AdamW step, in place on ``params`` and ``opt_state``.  Returns
    ``(params, opt_state, metrics)``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state["m"]),
                          leaves(opt_state["v"])):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


__all__ = ["OptimizerConfig", "lr_at", "init_opt_state", "global_norm",
           "clip_by_global_norm", "adamw_update"]
