"""Training launcher: data → step → checkpoint/restart → straggler watch.

Runs on the card unless ``device="cpu"``.  Every family the port builds
trains: dense, MoE, pure SSM (``mamba2-370m``) and hybrid (``jamba``) —
a Mamba2 block differentiates the chunked scan ``models.ssm.ssd_chunked``,
as the reference's does.  ``dp_ranks > 1`` with
``grad_sync="rma_ring"`` trains data-parallel over stacked ranks with the
one-sided ring gradient sync.  ``moe_ep="rma"`` runs an MoE arch's expert
layers over ``ep_ranks`` stacked expert-parallel ranks through the
one-sided all-to-all.  ``n_layers`` cuts depth and ``num_experts`` the
experts held (never a width) to fit a configuration on one card;
``remat`` overrides the config's rematerialization (``"block"`` by
default, as in the reference).  ``backend`` lowers the ring gradient sync
and ``ep_backend`` the MoE exchanges (``"rma"``, ``"gspmd"`` or
``"auto"``).

Fault tolerance, as in the JAX launcher:

* periodic asynchronous checkpoints of parameters and optimizer state
  (``ckpt_dir``, every ``ckpt_every`` steps, the newest ``ckpt_keep``
  kept) and a blocking one at the end;
* ``resume`` restores the latest complete checkpoint, and the data
  position follows from the step (counter-based batches);
* a straggler monitor times every step up to its device synchronization;
* ``fail_at_step`` simulates a preemption: the in-flight save lands, then
  ``RuntimeError``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --tiny \
      --steps 20 --dp-ranks 4 --grad-sync rma_ring --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch llama4-maverick-400b-a17b --moe-ep rma --ep-ranks 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --tiny \
      --steps 30 --ckpt-dir /tmp/ckpt --ckpt-every 10 --fail-at-step 20 \
      --device cpu          # then the same with --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config, tiny_config
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.device import resolve_device
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainstep import init_train_state, make_train_step
from repro_torch.tree import leaves


@dataclasses.dataclass
class TrainRun:
    """What a run did: the steps it ran and the step it ended at,
    per-step losses, wall times (ms, each step ending in a device
    synchronization) and, on the card, each step's parts (ms by part:
    gradients, gradient ring, AdamW, and the all-to-all exchanges inside
    the gradients — CUDA events); straggler events; and the trained
    parameters."""

    steps_run: int
    final_step: int
    losses: list
    step_ms: list
    part_ms: list
    phases: int | None
    n_params: int
    params: dict
    straggler_events: int


def train(arch: str, *, tiny: bool = True, steps: int = 100,
          global_batch: int = 8, seq_len: int = 64,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          ckpt_keep: int = 3, resume: bool = False,
          fail_at_step: int | None = None, peak_lr: float = 3e-3,
          warmup_steps: int | None = None, log_every: int = 10,
          data_seed: int = 0, seed: int = 0, grad_sync: str = "gspmd",
          dp_ranks: int = 1, n_layers: int | None = None,
          moe_ep: str | None = None, ep_ranks: int = 1,
          num_experts: int | None = None, remat: str | None = None,
          backend: str = "rma", ep_backend: str | None = None,
          mesh=None, device="cuda") -> TrainRun:
    """``mesh`` is accepted and unused, as the JAX package's is: the ranks
    of one card are stacked rows (``dp_ranks``, ``ep_ranks``)."""
    del mesh
    dev = resolve_device(device)
    cfg = tiny_config(arch) if tiny else get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if num_experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=num_experts))
    if ep_backend is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  ep_backend=ep_backend))
    model = build_model(cfg)
    warm = min(20, steps // 5) if warmup_steps is None else warmup_steps
    opt_cfg = OptimizerConfig(peak_lr=peak_lr, warmup_steps=warm,
                              total_steps=steps)
    data = make_source(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                  global_batch=global_batch, seed=data_seed))
    params, opt_state = init_train_state(model, seed, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    start_step = 0

    mgr = CheckpointManager(ckpt_dir, keep=ckpt_keep) if ckpt_dir else None
    if resume and mgr is not None:
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            print(f"[train] resumed from step {latest}", flush=True)

    step_fn = make_train_step(
        model, opt_cfg, grad_sync=grad_sync, data_axis="data",
        data_axis_size=dp_ranks, backend=backend, moe_ep=moe_ep,
        ep_ranks=ep_ranks if cfg.moe is not None else None)
    monitor = StragglerMonitor(threshold=3.0)
    losses, step_ms, part_ms, phases = [], [], [], None
    for step in range(start_step, steps):
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(dev)
                 for k, v in data.batch_at(step).items()}
        if fail_at_step is not None and step == fail_at_step:
            if mgr is not None:
                # the preemption notice's grace period: the in-flight
                # asynchronous save lands before the process dies
                mgr.wait()
            raise RuntimeError(f"simulated preemption at step {step}")
        monitor.start()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])   # waits for the step's device work
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        monitor.stop(step)
        losses.append(loss)
        if "events" in metrics:
            parts = {k: a.elapsed_time(b)
                     for k, (a, b) in metrics["events"].items()}
            if metrics["exchange_events"]:
                parts["exchanges"] = sum(a.elapsed_time(b) for a, b
                                         in metrics["exchange_events"])
            part_ms.append(parts)
        phases = metrics.get("phases", phases)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"ms={step_ms[-1]:.1f}", flush=True)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state}, blocking=True)
    return TrainRun(steps_run=steps - start_step, final_step=steps,
                    losses=losses, step_ms=step_ms, part_ms=part_ms,
                    phases=phases, n_params=n_params, params=params,
                    straggler_events=len(monitor.events))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--grad-sync", choices=("gspmd", "rma_ring"),
                    default="gspmd")
    ap.add_argument("--dp-ranks", type=int, default=1)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--moe-ep", choices=("gspmd", "rma"), default=None)
    ap.add_argument("--ep-ranks", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run = train(args.arch, tiny=args.tiny, steps=args.steps,
                global_batch=args.global_batch, seq_len=args.seq_len,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume, fail_at_step=args.fail_at_step,
                peak_lr=args.peak_lr, grad_sync=args.grad_sync,
                dp_ranks=args.dp_ranks, n_layers=args.n_layers,
                moe_ep=args.moe_ep, ep_ranks=args.ep_ranks,
                device=args.device)
    print(f"[train] done: loss {run.losses[0]:.4f} -> {run.losses[-1]:.4f}, "
          f"stragglers={run.straggler_events}")


if __name__ == "__main__":
    main()
