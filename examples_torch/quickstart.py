"""Quickstart on the PyTorch port: the window API in five minutes + a tiny
training run.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The 8 ranks of the RMA part are the rows of stacked ``(8, ...)`` tensors on
one device (the card unless ``--device cpu``).  The five-minute tour, in the
order the demo runs it:

  win  = Window.allocate(buf, "x", N, WindowConfig(order=True, scope="thread"))
  bulk = win.dup_with_info(order=False)    # P4: zero-copy duplicate — same
                                           # memory & flush queues, its own
                                           # config (here: unordered bulk)
  win  = put_signal(win, data, perm, ...)  # P2: put + flag, no mid-flush
  win  = win.flush(stream=0)               # P1: thread-scoped flush epoch
  out  = plan_all_reduce(x, "x", N)        # one-sided ring (a compiled-plan replay)

Window duplication is the cheapest tool in the box: configure *views* of one
window per use case instead of allocating one window per configuration.  See
docs/rma_architecture.md for the full P1–P5 map.
"""
import argparse

import torch

from repro_torch.core.rma import Window, WindowConfig, plan_all_reduce, put_signal
from repro_torch.device import resolve_device

N = 8


def demo_rma(dev):
    """The paper's Listing 2: ordered put + signal, no intermediate flush —
    issued through a dup_with_info view of an unordered base window (P4).
    Returns the window's rows and the all-reduced rows."""
    perm = [(i, (i + 1) % N) for i in range(N)]
    buf = torch.zeros((N, 5), dtype=torch.float32, device=dev)
    base = Window.allocate(buf, "x", N, WindowConfig(scope="thread"))
    # zero-copy duplicate carrying the per-use config: ordered channel
    # for the latency-critical put+signal; `base` stays available for
    # differently-configured traffic over the same memory.
    win = base.dup_with_info(order=True)
    assert win.buffer is base.buffer and win.group is base.group
    rank = torch.arange(N, dtype=torch.float32, device=dev)
    win = put_signal(win, rank[:, None].expand(N, 4), perm,
                     data_offset=0, flag_offset=4)
    win = win.flush(stream=0)
    out = win.buffer.cpu().numpy()
    print("window contents after ring put+signal (col 4 = completion flags):")
    print(out)
    assert (out[:, 4] == 1).all(), "signal flags must be raised everywhere"

    # a compiled-plan replay: the ring schedule is planned once and cached;
    # each call only replays it
    x = torch.arange(float(N * 4), device=dev).reshape(N, 4)
    red = plan_all_reduce(x, "x", N, order=True).cpu().numpy()
    print("one-sided ring all-reduce:", red[0], "(identical on all devices)")
    assert (red == red[0]).all()
    return out, red


def demo_train(dev):
    from repro_torch.launch.train import train
    run = train("qwen3-4b", tiny=True, steps=40, global_batch=4, seq_len=32,
                peak_lr=5e-3, log_every=10, device=dev)
    print(f"tiny qwen3 loss: {run.losses[0]:.3f} -> {run.losses[-1]:.3f}")
    assert run.losses[-1] < run.losses[0]
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    window, reduced = demo_rma(dev)
    run = demo_train(dev)
    print("QUICKSTART OK")
    return {"window": window, "reduced": reduced, "losses": run.losses}


if __name__ == "__main__":
    main()
