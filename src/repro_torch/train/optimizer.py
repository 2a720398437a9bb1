"""AdamW + LR schedule + global-norm clipping in plain PyTorch (the JAX
package's optimizer).  Optimizer state (m, v) is float32 whatever the
parameter dtype.  Updates are applied in place — parameters, m and v —
slice by slice, with the clip scale applied inside the update: a
full-width step holds one copy of each and no clipped copy of the
gradients, and its temporaries are one slice's."""
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


def opt_state_specs(param_specs: Any) -> dict:
    """Optimizer-state sharding mirrors the parameter sharding."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(tree: Any) -> torch.Tensor:
    sq = [x.float().square().sum() for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """The gradients scaled to at most ``max_norm`` global norm, in their
    own dtype, and that norm (before clipping).  A new tree: the train step
    does not call this, :func:`adamw_update` folds the same scale into its
    sliced pass instead of materializing a clipped copy of every leaf."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


#: elements updated at once (bounds the update's temporaries)
SLICE = 1 << 24


def _slices(*tensors: torch.Tensor):
    """Matching flat slices of same-shape contiguous tensors."""
    flat = [t.view(-1) for t in tensors]
    for lo in range(0, flat[0].numel(), SLICE):
        yield [f[lo:lo + SLICE] for f in flat]


@torch.no_grad()
def adamw_update(grads: Any, opt_state: dict, params: Any,
                 cfg: OptimizerConfig) -> tuple[Any, dict, dict]:
    """One AdamW step, in place on ``params`` and ``opt_state``, on the
    gradients clipped to ``cfg.grad_clip`` global norm.  Returns
    ``(params, opt_state, metrics)``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt_state["m"]),
                          leaves(opt_state["v"])):
        for ps, gs, ms, vs in _slices(p, g.contiguous(), m, v):
            gs = (gs * scale.to(gs.dtype)).float()
            ms.mul_(b1).add_((1 - b1) * gs)
            vs.mul_(b2).add_((1 - b2) * gs.square())
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps) \
                + cfg.weight_decay * ps.float()
            ps.copy_((ps.float() - lr * delta).to(ps.dtype))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


__all__ = ["OptimizerConfig", "lr_at", "init_opt_state", "opt_state_specs",
           "global_norm", "clip_by_global_norm", "adamw_update"]
