#!/usr/bin/env python3
"""K3's and K2's rows of ``chip_smoke.py``'s kernels record, alone, for one
source tree — so two trees can be compared on one card in turns.

    python3 benchmarks_torch/k3_rows.py [--src DIR] [--tag NAME]

Times by CUDA-graph replay, at the smoke's shapes and through the public
wrappers only (so an older tree runs it too): K3 static (4, 2^20) float32
on a ring; device (per-rank displacements) and guarded (memory handles)
into the (4, 2^24) pool; a guarded ``qwen3-4b`` page on 8 ranks, (8,
1,179,648) bf16; its flush wait at n = 4; K2 (4, 8) float32 static, device
and guarded; and K3's host put and read of one page into pinned memory.
``--src`` is the ``src`` directory of the tree to time (default: this
repository's); its kernels build into that tree's ``build/kernels``.
Prints one JSON object: ``{"tag", "card", "ms": {row: ms}}``.  Needs one
CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
N, M, POOL, COUNT = 4, 1 << 20, 1 << 24, 8
PAGE_E = 16 * 8 * 128 * 2 * 36


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * replays)


def rows(torch) -> dict:
    from repro_torch.kernels import intrinsic as k2
    from repro_torch.kernels import rma_put as k3

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    i32 = dict(dtype=torch.int32, device=dev)
    tgt = torch.tensor([(r + 1) % N for r in range(N)], **i32)
    upd, small = rand((N, M)), rand((N, COUNT))
    dst, win = torch.empty_like(upd), rand((N, M))
    pool = rand((N, POOL))
    disp = torch.tensor([0, POOL // 4 + 4, POOL // 2 + 8, POOL - M], **i32)
    regs = torch.zeros((N, 2, 3), **i32)
    regs[:, 0, 0] = 1
    hnd = torch.zeros((N, 4), **i32)
    hnd[:, 0] = 1
    hnd[:, 1] = disp
    err = torch.zeros(N, **i32)
    guard = dict(handles=hnd, regs=regs, err=err)
    counters = torch.zeros((N, 2), **i32)
    ticks = k3.put_rows(upd, dst, tgt, counters=counters, stream=0)
    stalls = torch.zeros(1, **i32)
    # a pushed page on 8 ranks, through fresh handles
    nr = 8
    tgt8 = torch.tensor([(r + 1) % nr for r in range(nr)], **i32)
    page_src = rand((nr, PAGE_E), torch.bfloat16)
    page_dst = torch.zeros((nr, 2 * PAGE_E), dtype=torch.bfloat16, device=dev)
    regs8 = torch.zeros((nr, 2, 3), **i32)
    regs8[:, 1, 0] = 3
    hnd8 = torch.tensor([[3, PAGE_E, PAGE_E, 1]] * nr, **i32)
    err8 = torch.zeros(nr, **i32)
    # one page into pinned host memory and back
    host = torch.zeros((1, 4 * PAGE_E), dtype=torch.bfloat16, pin_memory=True)
    regs_h = torch.zeros((1, 4, 3), **i32)
    regs_h[0, :, 0] = torch.tensor([1, 2, 4, 0], dtype=torch.int32)
    hnd_h = torch.tensor([[2, PAGE_E, PAGE_E, 1]], **i32)
    err_h = torch.zeros(1, **i32)
    tgt1 = torch.zeros(1, **i32)
    page = rand((1, PAGE_E), torch.bfloat16)
    back = torch.empty_like(page)
    calls = {
        "ring_put": lambda: k3.put_rows(upd, dst, tgt),
        "ring_put_device": lambda: k3.put_rows(upd, pool, tgt, disp=disp),
        "ring_put_guarded": lambda: k3.put_rows(upd, pool, tgt, **guard),
        "ring_put_page": lambda: k3.put_rows(page_src, page_dst, tgt8,
                                             handles=hnd8, regs=regs8,
                                             err=err8),
        "put_wait": lambda: k3.wait_counters(counters, [ticks] * N, stream=0,
                                             stalls=stalls),
        "ring_accumulate": lambda: k2.accumulate_rows_atomic(
            small, win, tgt, op="sum", offset=M - COUNT),
        "ring_accumulate_device": lambda: k2.accumulate_rows_atomic(
            small, pool, tgt, op="sum", disp=disp),
        "ring_accumulate_guarded": lambda: k2.accumulate_rows_atomic(
            small, pool, tgt, op="sum", **guard),
        "ring_put_host": lambda: k3.put_rows(page, host, tgt1, handles=hnd_h,
                                             regs=regs_h, err=err_h),
        "ring_put_host_read": lambda: k3.put_rows(
            host, back, tgt1, handles=hnd_h, regs=regs_h, err=err_h,
            read=True),
    }
    out = {name: graph_ms(torch, fn) for name, fn in calls.items()}
    torch.cuda.synchronize()
    if stalls.item() or err.any() or err8.any() or err_h.any():
        raise AssertionError("a timed call went stale or stalled")
    if not torch.equal(back, page):
        raise AssertionError("the host page did not round-trip")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("k3_rows: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build

    _build.build(["rma_put", "intrinsic"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "card": card, "ms": rows(torch)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
