"""The stacked leaves' gradients in the port's train step.

``apply_stack`` takes each scanned period's parameter slices with one
``torch.unbind`` per stacked leaf, so a backward builds each stacked
leaf's gradient with one ``stack``.  Slicing ``p[c]`` once per period, as
the oracle below does, gives every period a ``select_backward`` (a
zero-filled whole-stack tensor) and the backward a whole-stack add per
period after the first to sum them; the values are the same, bit for bit,
since the sum adds exact zeros.  The counts are taken by a dispatch mode
around the step's ``torch.autograd.grad`` calls, on the gradient path of
``make_train_step``'s ring step (``grads_into`` writing into the ring's
matrix, as the benchmark's step does)."""
import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import tiny_config
from repro_torch.models import build_model
from repro_torch.models.transformer import layer_plan, stage_plan
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainstep import make_train_step
from repro_torch.tree import leaves, unflatten

B, S = 3, 7          # no activation takes a stacked leaf's shape
RANKS = 2
#: (arch, n_layers): a dense stack of three one-layer periods, and a hybrid
#: one of two 8-layer periods (Mamba2, attention, MoE and dense FFNs)
STACKS = [("starcoder2-3b", 3), ("jamba-v0.1-52b", 16)]


def _model(arch, n_layers, remat):
    cfg = tiny_config(arch).replace(n_layers=n_layers, remat=remat)
    prefix, period = stage_plan(layer_plan(cfg))
    assert (n_layers - prefix) // period >= 2
    return cfg, build_model(cfg)


def _batch(cfg, rows, seed=3):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (rows, S)))
            for k in ("tokens", "labels")}


def _per_period_slicing(t, dim=0):
    """The oracle: one ``t[c]`` per period, in place of the unbind."""
    return tuple(t.select(dim, c) for c in range(t.shape[dim]))


class _WholeStackOps(TorchDispatchMode):
    """Counts the ops whose output has the whole shape of a stacked leaf,
    by op name."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes = shapes
        self.ops = collections.Counter()
        self.stacks = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if isinstance(out, torch.Tensor) and tuple(out.shape) in self.shapes:
            self.ops[name] += 1
            if name == "stack":
                self.stacks[tuple(out.shape)] += 1
        return out


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch,n_layers", STACKS)
def test_backward_builds_one_stack_per_stacked_leaf(arch, n_layers, remat,
                                                    monkeypatch):
    cfg, model = _model(arch, n_layers, remat)
    params = model.init(0, device="cpu")
    scan = leaves(params["stack"]["scan"])
    want = collections.Counter(tuple(p.shape) for p in scan)
    modes = []
    grad = torch.autograd.grad

    def counted(*args, **kwargs):
        with _WholeStackOps(set(want)) as mode:
            out = grad(*args, **kwargs)
        modes.append(mode)
        return out

    monkeypatch.setattr(torch.autograd, "grad", counted)
    step = make_train_step(model, OptimizerConfig(warmup_steps=0,
                                                  total_steps=2),
                           grad_sync="rma_ring", data_axis_size=RANKS)
    _, _, metrics = step(params, init_opt_state(params),
                         _batch(cfg, RANKS * B))
    assert np.isfinite(float(metrics["loss"]))
    assert len(modes) == RANKS                    # one backward a rank
    for mode in modes:
        # one whole-stack op per stacked leaf, its gradient's stack; no
        # zero-filled per-period gradient, no whole-stack sum
        assert mode.stacks == want
        assert mode.ops == {"stack": len(scan)}, dict(mode.ops)


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch,n_layers", STACKS)
def test_gradients_equal_per_period_slicing_bit_for_bit(arch, n_layers,
                                                        remat, monkeypatch):
    cfg, model = _model(arch, n_layers, remat)
    params = model.init(0, device="cpu")
    batch = _batch(cfg, B)

    def loss_and_grads():
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, _ = model.loss(unflatten(params, ps), batch)
        return loss.detach(), torch.autograd.grad(loss, ps)

    loss, grads = loss_and_grads()
    monkeypatch.setattr(torch, "unbind", _per_period_slicing)
    loss_o, grads_o = loss_and_grads()
    assert torch.equal(loss, loss_o)
    assert len(grads) == len(grads_o) == len(leaves(params))
    for g, go in zip(grads, grads_o):
        assert torch.equal(g, go)
