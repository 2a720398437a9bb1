"""Train-step factory: loss → grads → (optional RMA grad sync) → AdamW.

``moe_ep`` rebuilds an MoE model with its expert-parallel dispatch mode
replaced (``"rma"``: the one-sided all-to-all over ``ep_ranks`` stacked
ranks, whose exchanges run forward and backward on kernels K4/K6).

Two gradient-synchronization modes, over a stacked data-parallel axis:

* ``"gspmd"``: one program over the whole global batch, no sync — the
  single-program reference the ring is held against.
* ``"rma_ring"``: ``data_axis_size = n`` ranks.  Rank r takes the r-th
  contiguous block of the global batch, computes its gradients (averaged
  over ``accum_steps`` micro-batches in float32), and lays them out as row r
  of an ``(n, P)`` float32 matrix in the reference's leaf order.  One
  one-sided ring all-reduce on a **sum-specialized dup** of that gradient
  window (``same_op="sum"``, paper §2.3 hints × P4) sums the rows — a
  declarative-plan replay that the planner lowers to one launch of kernel
  K5 (``backend="rma"``) or to one library sum over the rank axis
  (``backend="gspmd"``; ``"auto"`` picks from the table measured on the
  card) — and the gradients are that sum over n.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.rma.alltoall import timed_exchanges
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)
from repro_torch.tree import leaves, unflatten


def make_train_step(model, opt_cfg: OptimizerConfig, *, accum_steps: int = 1,
                    grad_sync: str = "gspmd", data_axis: str | None = None,
                    data_axis_size: int = 1, compressor=None,
                    topology=None, backend: str = "rma",
                    moe_ep: str | None = None,
                    ep_ranks: int | None = None):
    """Build ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` is the global batch.  Parameters and optimizer
    state are updated in place.  On the card, CUDA events bracket the
    step's parts — gradients, the gradient ring, AdamW, and inside the
    gradients each rank's and micro-batch's forward and backward
    (``fwd.<rank>.<micro-batch>``, ``bwd.<rank>.<micro-batch>``)
    (``metrics["events"]``, name → (start, end)) — and every all-to-all
    exchange (``metrics["exchange_events"]``).

    ``topology``: the data axis's host×device factorization (``None``
    consults ``RMA_TOPOLOGY``); a non-degenerate one makes the ring
    hierarchical.  ``backend``: the lowering target of the ``"rma_ring"``
    gradient-sync plan (``"auto" | "rma" | "gspmd"``); ``"interpret"``
    walks a plan off the substrate and is invalid in a train step.
    ``moe_ep``:
    override the MoE dispatch mode (``"gspmd"`` | ``"rma"``) of the step's
    model; requires an MoE config.  ``ep_ranks``: its expert-parallel
    ranks (default: the model's).

    ``compressor``: accepted and ignored where the reference ignores it
    (no ring: ``"gspmd"`` or one rank).  With the ring over n > 1 ranks it
    raises: the reference's step then skips the gradient sync altogether
    ("handled at caller level", and no caller does), so each rank would
    apply its own unsynced gradients, which one stacked parameter tree
    cannot hold.  ``train.compress.compressed_all_reduce`` is the ported
    compressed sync."""
    if grad_sync not in ("gspmd", "rma_ring"):
        raise ValueError(f"grad_sync={grad_sync!r}; expected 'gspmd' or "
                         "'rma_ring'")
    if compressor is not None and grad_sync == "rma_ring" and \
            data_axis_size > 1:
        raise NotImplementedError(
            "compressor= with grad_sync='rma_ring' over "
            f"{data_axis_size} ranks: the JAX package's step then skips the "
            "gradient sync (left to a caller that does not exist), so every "
            "rank would apply its own unsynced gradients, which the stacked "
            "layout's one parameter tree cannot hold; use "
            "repro_torch.train.compress.compressed_all_reduce on stacked "
            "gradients instead")
    if backend not in ("auto", "rma", "gspmd"):
        raise ValueError(
            f"backend={backend!r} invalid for a train step; expected "
            "'auto', 'rma', or 'gspmd' (the interpret target runs host-side "
            "with no mesh)")
    if moe_ep is not None or ep_ranks is not None:
        from repro_torch.models import build_model

        cfg = model.cfg
        if cfg.moe is None:
            raise ValueError(
                f"moe_ep={moe_ep!r} requested but arch {cfg.name!r} has no "
                "MoE config")
        if moe_ep is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, ep_mode=moe_ep))
        if cfg.moe.ep_mode == "rma" and grad_sync == "rma_ring":
            raise NotImplementedError(
                "moe_ep='rma' with grad_sync='rma_ring' is not in the JAX "
                "launcher and not ported (ROADMAP queue 1, item 10)")
        model = build_model(cfg, ep_ranks=ep_ranks or model.ep_ranks)
    n = data_axis_size if grad_sync == "rma_ring" else 1
    axis = data_axis or "data"

    def grads_into(params, batch, out: torch.Tensor | None, mark, rank=0):
        """Loss and gradients of one batch, averaged over ``accum_steps``
        micro-batches.  With ``out`` (a float32 vector), the gradients are
        written there in leaf order instead of returned.  Each micro-batch
        ``a`` marks its forward ``fwd.<rank>.<a>`` and its backward (the
        recompute and the copy of the gradients included)
        ``bwd.<rank>.<a>``."""
        # differentiable aliases of the parameters (no copy)
        ps = [p.detach().requires_grad_(True) for p in leaves(params)]
        params = unflatten(params, ps)
        rows = batch["tokens"].shape[0]
        if rows % accum_steps:
            raise ValueError(f"batch of {rows} rows not divisible by "
                             f"accum_steps={accum_steps}")
        per = rows // accum_steps
        acc = None if out is None else out
        loss_sum = None
        for a in range(accum_steps):
            mb = {k: v[a * per:(a + 1) * per] for k, v in batch.items()}
            fwd, bwd = f"fwd.{rank}.{a}", f"bwd.{rank}.{a}"
            mark(None, fwd)
            with torch.enable_grad():
                loss, parts = model.loss(params, mb)
                mark(fwd, bwd)
                gs = torch.autograd.grad(loss, ps)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if out is None:
                gs = [g.float() for g in gs]
                acc = gs if acc is None else [x + g for x, g in zip(acc, gs)]
            else:
                off = 0
                for g in gs:
                    seg = out[off:off + g.numel()]
                    if a == 0:
                        seg.copy_(g.reshape(-1))
                    else:
                        seg.add_(g.reshape(-1).float())
                    off += g.numel()
            mark(bwd, None)
        if accum_steps > 1:
            if out is None:
                acc = [g / accum_steps for g in acc]
            else:
                out.div_(accum_steps)
            loss_sum = loss_sum / accum_steps
            parts = {"xent": loss_sum, "aux": loss_sum.new_zeros(())}
        return loss_sum, acc, {k: v.detach() for k, v in parts.items()}

    def sync_grads(params, batch, metrics, mark):
        from repro_torch.core.rma.collectives import plan_all_reduce
        from repro_torch.core.rma.topology import default_topology
        from repro_torch.core.rma.window import Window, WindowConfig

        ps = leaves(params)
        size = sum(p.numel() for p in ps)
        width = -(-size // (4 * n)) * (4 * n)   # whole, vector-aligned chunks
        device = ps[0].device
        mat = torch.empty((n, width), dtype=torch.float32, device=device)
        mat[:, size:] = 0
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"global batch of {rows} rows not divisible by "
                             f"data_axis_size={n}")
        per = rows // n
        losses, parts = [], []
        for r in range(n):
            shard = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
            loss, _, part = grads_into(params, shard, mat[r, :size], mark, r)
            losses.append(loss)
            parts.append(part)
        topo = topology if topology is not None else default_topology(n)
        # one window, one ring, all leaves: the gradient matrix is exposed
        # as a window and the ring runs on its sum-specialized dup
        win = Window.allocate(
            mat, axis, n, WindowConfig(scope="thread", order=True,
                                       accumulate_ops=("sum",), topology=topo))
        sumwin = win.dup_with_info(same_op="sum")
        mark("grads", "sync")
        red = plan_all_reduce(mat, axis, n, order=True, win=sumwin,
                              topology=topo, backend=backend, donate=True)
        metrics["phases"] = win.ledger.total
        vec = red[0, :size] / n   # every row holds the sum
        out, off = [], 0
        for p in ps:
            out.append(vec[off:off + p.numel()].view(p.shape))
            off += p.numel()
        mean = {k: torch.stack([p[k] for p in parts]).mean()
                for k in parts[0]}
        return torch.stack(losses).mean(), unflatten(params, out), mean

    def train_step(params, opt_state, batch):
        metrics: dict = {}
        events: dict = {}
        on_card = leaves(params)[0].is_cuda

        def mark(done, start):
            """Close the part ``done`` and open ``start`` (CUDA events)."""
            if not on_card:
                return
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if done:
                events[done] = (events[done], ev)
            if start:
                events[start] = ev

        mark(None, "grads")
        with timed_exchanges(on_card) as exchanges:
            if n > 1:
                loss, grads, parts = sync_grads(params, batch, metrics, mark)
                mark("sync", "adamw")
            else:
                loss, gs, parts = grads_into(params, batch, None, mark)
                grads = unflatten(params, gs)
                mark("grads", "adamw")
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                                      opt_cfg)
        mark("adamw", None)
        if on_card:
            metrics["events"] = events
            metrics["exchange_events"] = exchanges
        metrics.update({"loss": loss, **parts, **opt_metrics})
        return params, opt_state, metrics

    return train_step


def init_train_state(model, seed: int = 0, opt_cfg=None, *, device="cuda"):
    """Parameters from ``seed`` and their AdamW state; ``opt_cfg`` is
    accepted and unused, as the JAX package's is."""
    params = model.init(seed, device=device)
    return params, init_opt_state(params)


__all__ = ["make_train_step", "init_train_state"]
