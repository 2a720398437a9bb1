#!/usr/bin/env python3
"""The tiered KV pool's numbers of ``chip_smoke.py`` ``[serve-tier]``,
alone, for one source tree — so two trees can be compared on one card in
turns.

    python3 benchmarks_torch/tier_turns.py [--src DIR] [--tag NAME]

``qwen3-4b`` at all 36 layers and published widths, random weights from
seed 0, the smoke's 8 requests (1016 prompt tokens, 32 new) over 4 slots,
``kv_pages=(256, 512)`` of 16 tokens with prefix sharing: the tiered engine
runs them once, with CUDA events around every ``HostKVTier.step``.  Then,
on the drained tier, one 128-page sequence is demoted and promoted by CUDA
events (3 each after a warm-up), beside ``copy_`` of the same pages, and
its 128 K3 launches alone by CUDA-graph replay.  Only public entry points
are used, so an older tree runs it too.  ``--src`` is the ``src`` directory
of the tree to time (default: this repository's); its kernels build into
that tree's ``build/kernels``.  Prints one JSON object: ``{"tag", "card",
"ms": {...}}``.  Needs one CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SLOTS, MAX_SEQ, PAGE = 4, 2048, 16
REQUESTS, PROMPT, PREFIX, NEW = 8, 1016, 512, 32
TIER_SEQS = (2, 4)


def time_ms(torch, fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(torch, fn, reps: int = 2, replays: int = 5) -> float:
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


def run(torch) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import rma_put as k3
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config("qwen3-4b")
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    prng = np.random.RandomState(0)
    prefix = prng.randint(0, cfg.vocab, size=PREFIX)
    prompts = [np.concatenate([prefix, prng.randint(
        0, cfg.vocab, size=PROMPT - PREFIX)]) for _ in range(3)]
    prompts.append(prompts[2].copy())
    prompts += [prng.randint(0, cfg.vocab, size=PROMPT)
                for _ in range(REQUESTS - len(prompts))]
    pps = MAX_SEQ // PAGE
    eng = ServeEngine(model, params, n_slots=SLOTS, max_seq=MAX_SEQ,
                      kv_pages=tuple(k * pps for k in TIER_SEQS),
                      paged_kv=True, page_tokens=PAGE, prefix_share=True)
    tier = eng.tier
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid, prompt, NEW))
    steps, plain_step = [], tier.step

    def timed_step(promote, demote, payloads=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = plain_step(promote, demote, payloads)
        b.record()
        steps.append((a, b))
        return out

    tier.step = timed_step
    eng.run(strict=True)
    tier.step = plain_step
    torch.cuda.synchronize()
    st = eng.stats()
    if st["tier_stale_drops"] or not st["promotions"]:
        raise AssertionError(f"the tier went stale or never moved: {st}")
    step_ms = [a.elapsed_time(b) for a, b in steps]
    # one sequence each way on the drained tier
    e_page = tier.spec.page_elems
    slots = list(range(pps))
    tier.alloc(slots)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pay = torch.randn((pps, e_page), generator=gen, device=dev).to(
        torch.bfloat16)
    tier.step((), slots, pay)
    if not torch.equal(tier.step(slots, ()), pay):
        raise AssertionError("one sequence did not round-trip")
    host_seq = tier.pool.window.buffer[0, :pps * e_page].view(pps, e_page)
    landed = torch.empty_like(pay)
    win = tier.pool.window
    tgt0 = torch.zeros(1, dtype=torch.int32, device=dev)
    hnds = [tier.pool.handles[:, s].contiguous() for s in slots]

    def k3_seq(read: bool):
        for i, h in enumerate(hnds):
            if read:
                k3.put_rows(win.buffer, landed[i:i + 1], tgt0, handles=h,
                            regs=win.regs, err=tier.err_count, read=True)
            else:
                k3.put_rows(pay[i:i + 1], win.buffer, tgt0, handles=h,
                            regs=win.regs, err=tier.err_count)
    out = dict(
        tier_step_median=statistics.median(step_ms), tier_steps=len(step_ms),
        demote=time_ms(torch, lambda: tier.step((), slots, pay)),
        promote=time_ms(torch, lambda: tier.step(slots, ())),
        demote_copy=time_ms(torch, lambda: host_seq.copy_(
            pay, non_blocking=True)),
        promote_copy=time_ms(torch, lambda: landed.copy_(
            host_seq, non_blocking=True)),
        demote_k3=graph_ms(torch, lambda: k3_seq(False)),
        promote_k3=graph_ms(torch, lambda: k3_seq(True)))
    torch.cuda.synchronize()
    if int(tier.err_count.sum()) or not torch.equal(landed, pay):
        raise AssertionError("the timed sequence went stale or differs")
    tier.free(slots)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"))
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("tier_turns: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build

    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "card": card, "ms": run(torch)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
