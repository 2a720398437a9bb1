"""End-to-end driver on the PyTorch port: train a ~100M-parameter
qwen3-family model for a few hundred steps on synthetic data with
checkpointing and straggler watch.

  PYTHONPATH=src python examples_torch/train_lm.py [--steps 300] [--device cpu]

The model is the qwen3-4b architecture scaled to ~100M params (same family:
GQA kv=8 ratio, qk-norm, SwiGLU, RoPE 1e6).  Loss must drop well below the
uniform baseline ln(vocab) on the structured synthetic stream.  Runs on the
card unless ``--device cpu``.
"""
import argparse
import math
import os
import tempfile

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.device import resolve_device
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainstep import make_train_step
from repro_torch.tree import leaves


def model_100m():
    return get_config("qwen3-4b").replace(
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
        d_ff=2048, vocab=8192, max_seq=512,
        dtype="float32", param_dtype="float32")


def optimizer_config(steps: int) -> OptimizerConfig:
    return OptimizerConfig(peak_lr=1e-3, warmup_steps=30, total_steps=steps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_100m()
    model = build_model(cfg)
    params = model.init(0, device=dev)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"[train_lm] {cfg.name}-100m: {n_params/1e6:.1f}M params")

    opt_cfg = optimizer_config(args.steps)
    opt_state = init_opt_state(params)
    data = make_source(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    step_fn = make_train_step(model, opt_cfg)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    monitor = StragglerMonitor()

    first = last = None
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, dtype=torch.int64).to(dev)
                 for k, v in data.batch_at(step).items()}
        monitor.start()
        params, opt_state, m = step_fn(params, opt_state, batch)
        loss = float(m["loss"])          # waits for the step's device work
        monitor.stop(step)
        first = loss if first is None else first
        last = loss
        if step % 25 == 0 or step == args.steps - 1:
            print(f"[train_lm] step={step:4d} loss={loss:.4f} "
                  f"lr={float(m['lr']):.2e}", flush=True)
        if (step + 1) % 100 == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state})
    mgr.wait()
    uniform = math.log(cfg.vocab)
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} "
          f"(uniform baseline {uniform:.3f}); stragglers={len(monitor.events)}")
    assert last < first and last < uniform - 1.0, "model failed to learn"
    print("TRAIN_LM OK")
    return {"first": first, "last": last, "uniform": uniform,
            "n_params": n_params, "stragglers": len(monitor.events)}


if __name__ == "__main__":
    main()
