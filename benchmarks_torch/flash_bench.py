#!/usr/bin/env python3
"""K7 (flash attention, forward) alone on a card: build, check, time.

    python3 benchmarks_torch/flash_bench.py [--reps N]

1. Builds ``csrc/flash_attention.cu`` and prints what ``ptxas -v`` said of
   the bfloat16 kernel (registers, spills, barriers) and its dynamic shared
   memory per CTA.
2. Holds both variants against K7's plain version at the tolerances of the
   JAX kernel test (float32 atol 2e-5, bfloat16 atol 2e-2, rtol 1e-2): the
   JAX test's four shapes in float32 and bfloat16; the prefill shape (1, 32,
   1024, 128) bfloat16 causal GQA 32/8; the prefill's head-transposed views
   of (1, S, heads, 128) tensors at S in {1, 37, 1016, 1024} (the output
   must come back as a view of a (1, S, 32, 128) tensor); head dims 16, 32,
   64 and 96 at a ragged S; a non-causal ragged key count.  Each call must
   launch the variant its dtype names.
3. Times, by replaying a CUDA graph of ``--reps`` captured calls: K7 in
   bfloat16 at the prefill shape (contiguous and through the views), K7 in
   float32 there, the plain version and ``scaled_dot_product_attention``
   (causal, GQA), and prints achieved TFLOP/s over the causal pairs and the
   ratio to SDPA; then K7 against SDPA at the same widths with more work
   per launch (batch 4, 4096 tokens, causal and not).

Needs one CUDA card; exits non-zero without one.
"""
import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12
TOL = {"float32": dict(atol=2e-5, rtol=1e-2), "bfloat16": dict(atol=2e-2, rtol=1e-2)}
JAX_TEST_SHAPES = ((2, 4, 256, 64, True, 64, 64), (1, 2, 128, 32, False, 64, 32),
                   (1, 1, 512, 128, True, 128, 128), (3, 2, 192, 64, True, 64, 64))
H, KV, HD, S = 32, 8, 128, 1024     # qwen3-4b's prefill at 1016 tokens, padded
#: (batch, seq, causal) at the prefill's widths: more CTAs, longer rows
SWEEP = ((1, 1024, True), (4, 1024, True), (1, 4096, True), (1, 4096, False),
         (4, 4096, False))


def graph_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Card time of one ``fn()``: ``reps`` calls captured in one CUDA graph
    and the graph replayed, so no host work falls between the launches."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import torch

    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build

    k7 = sys.modules.get("repro_torch.kernels.flash_attention")
    if k7 is None:
        import repro_torch.kernels  # noqa: F401  (registers the module)
        k7 = sys.modules["repro_torch.kernels.flash_attention"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} card "
          f"{smi}", flush=True)
    _build.build(["flash_attention"])
    for line in _build.ptxas_report("flash_attention", "flash_fwd_wgmma"):
        print(f"[ptxas] {line}", flush=True)
    smem = _build.lib("flash_attention", "rt_flash_attention_bf16_smem")
    print(f"[ptxas] bf16 kernel dynamic shared memory per CTA: D 64 "
          f"{smem(64)} bytes, D 128 {smem(128)} bytes", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def held(what, q, k, v, causal=True, bq=128, bkv=128):
        dtype = str(q.dtype).split(".")[1]
        before = dict(k7.COUNTER.by_variant)
        got = k7.flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
        ran = [n for n, c in k7.COUNTER.by_variant.items() if c != before.get(n, 0)]
        want = k7.flash_attention_plain(q, k, v, causal=causal, block_q=bq,
                                        block_kv=bkv)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), **TOL[dtype])
        print(f"[check] {what} {dtype} causal={causal}: {ran} max abs err "
              f"{err:.3g} {'ok' if ok else 'FAILED'}", flush=True)
        if not ok or ran != [k7.VARIANTS[q.dtype]]:
            raise AssertionError(f"K7 {what} {dtype}: err {err}, ran {ran}")
        return got

    for dtype in (torch.float32, torch.bfloat16):
        for b_, h_, s_, hd_, causal, bq, bkv in JAX_TEST_SHAPES:
            q, k, v = (rand((b_, h_, s_, hd_), dtype) for _ in range(3))
            held((b_, h_, s_, hd_), q, k, v, causal, bq, bkv)
    q = rand((1, H, S, HD), torch.bfloat16)
    k, v = (rand((1, KV, S, HD), torch.bfloat16) for _ in range(2))
    held(f"(1, {H}, {S}, {HD}) GQA {H}/{KV}", q, k, v)
    for s_ in (1, 37, 1016, 1024):      # the prefill's views, no pad
        qs = rand((1, s_, H, HD), torch.bfloat16)
        ks, vs = (rand((1, s_, KV, HD), torch.bfloat16) for _ in range(2))
        out = held(f"views of (1, {s_}, {H}/{KV}, {HD})", qs.transpose(1, 2),
                   ks.transpose(1, 2), vs.transpose(1, 2), True, s_, s_)
        if not out.transpose(1, 2).is_contiguous():
            raise AssertionError("K7's output is not a view of (B, S, H, D)")
    for hd_ in (16, 32, 64, 96):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (rand((2, 4, 200, hd_), dtype) for _ in range(3))
            held(f"(2, 4, 200, {hd_})", q, k, v, True, 200, 200)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (rand((1, 4, 192, 128), dtype) for _ in range(3))
        held("(1, 4, 192, 128)", q, k, v, False, 64, 64)

    q = rand((1, H, S, HD), torch.bfloat16)
    k, v = (rand((1, KV, S, HD), torch.bfloat16) for _ in range(2))
    qs = rand((1, S, H, HD), torch.bfloat16)
    ks, vs = (rand((1, S, KV, HD), torch.bfloat16) for _ in range(2))
    views = (qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2))
    qf, kf, vf = q.float(), k.float(), v.float()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flop = 4 * HD * H * S * (S + 1) // 2
    times = {
        "K7 bf16": graph_ms(torch, lambda: k7.flash_attention(q, k, v), args.reps),
        "K7 bf16 views": graph_ms(torch, lambda: k7.flash_attention(
            *views, block_q=S, block_kv=S), args.reps),
        "K7 f32": graph_ms(torch, lambda: k7.flash_attention(qf, kf, vf), args.reps),
        "plain bf16": graph_ms(torch, lambda: k7.flash_attention_plain(q, k, v),
                               args.reps),
        "SDPA bf16": graph_ms(torch, lambda: sdpa(q, k, v, is_causal=True,
                                                  enable_gqa=True), args.reps),
    }
    for name, ms in times.items():
        print(f"[time] {name} (1, {H}, {S}, {HD}) causal GQA {H}/{KV}: "
              f"{ms:.4f} ms, {flop / ms / 1e9:.1f} TFLOP/s "
              f"({100 * flop / ms / 1e-3 / PEAK_BF16:.1f} % of the bf16 peak), "
              f"{ms / times['SDPA bf16']:.2f} x SDPA", flush=True)
    # where the prefill shape's shortfall comes from: more work per launch
    # (batch, length) at the same widths, K7 and SDPA in turn
    for b_, s_, causal in SWEEP:
        q = rand((b_, H, s_, HD), torch.bfloat16)
        k, v = (rand((b_, KV, s_, HD), torch.bfloat16) for _ in range(2))
        n_ctas = b_ * H * -(-s_ // 128)
        work = 4 * HD * H * b_ * (s_ * (s_ + 1) // 2 if causal else s_ * s_)
        ms_k = graph_ms(torch, lambda: k7.flash_attention(
            q, k, v, causal=causal), 5)
        ms_s = graph_ms(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                            enable_gqa=True), 5)
        print(f"[sweep] ({b_}, {H}, {s_}, {HD}) causal={causal}, {n_ctas} "
              f"CTAs: K7 {ms_k:.4f} ms {work / ms_k / 1e9:.1f} TFLOP/s, SDPA "
              f"{ms_s:.4f} ms {work / ms_s / 1e9:.1f} TFLOP/s, "
              f"{ms_k / ms_s:.2f} x SDPA", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
