#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and holds each against its plain PyTorch version on
   the card: K1 tiled accumulate, K2 atomic accumulate, K3 put and its
   flush wait, K4 put+signal, K5 ring all-reduce, K6 accumulate+signal —
   every op and dtype the kernel takes, a ragged tail, ordered and
   unordered, and the paths' own shapes (K1 also on misaligned column
   slices of a wider window; K5 also at 40 random ragged shapes and at the
   gradient shape, against the sum oracle); K7 flash attention at the JAX
   kernel test's four shapes and at (1, 32, 1024, 128) bfloat16 with GQA
   32/8, and the prefill's own call on head-transposed views at 1016
   tokens; K8 at the JAX kernel test's three shapes (float32 and
   bfloat16) and the prefill's (1, 2048, 32 x 64), N 128, chunk 64 in
   bfloat16, and the SSD pass on K8's outputs at the same shapes, with and
   without an initial state; the whole card scan (K8 + pass) against the
   sequential oracle in float32 (an initial state, ragged lengths) and
   against the plain scan at the 2040-token prefill in bfloat16, one scan
   traced to show it is two kernels; K4's check mode counts the copy
   units a consumer read behind a raised flag that differ from what was
   sent (must be 0), in the launch the paths run.  K7 names the variant
   each call ran (float32: the SIMT kernel; bfloat16: wgmma on TMA-fed
   tiles, whose ``ptxas -v`` registers, spills and shared memory are
   printed after the build).  Times kernel, plain version and the nearest
   single PyTorch call by CUDA-graph replay, so the times are the card's
   alone (K8, its pass and the flush wait have no such call; the wait's plain
   version copies from the host and is timed by calls), and K1-K3's and
   the wait's wrapper calls back to back (``call_ms``, host included);
   K1 a second time past L2 at (4, 2^23) beside ``add_``; K5 by CUDA
   events at the gradient shape beside ``torch.sum(x, 0)``, both on their
   first call after a large free and warmed, with K5's achieved rate and
   design; K1's, K5's, K8's and the pass's ``ptxas -v`` registers and
   spills;
   K7's achieved TFLOP/s and its ratio to ``scaled_dot_product_attention``.
2. Drives each path with every launch counter at 0 just before it and
   reads the counters just after: the window layer (allocate →
   dup_with_info → ring put with a thread-scope flush → declared
   accumulates below and above the crossover → an undeclared one →
   put_signal on an ordered and an unordered window), each phase-ledger
   count held to the reference cost model; a data-parallel ``qwen3-4b``
   train step at full width (depth cut to 2 layers) over 4 stacked ranks
   with the one-sided ring gradient sync; the planned all-to-all at the MoE
   exchange's shape, held bit for bit to the same plan run op by op; and an
   expert-parallel ``llama4-maverick-400b-a17b`` train step at full width
   (2 layers, 8 of 128 experts, 4 stacked expert ranks) whose dispatch and
   combine exchanges run on K4 and K6, forward and backward; and the
   serving path: ``qwen3-4b`` at all 36 layers and published widths behind
   a dense engine and a paged engine with copy-on-write prefix sharing,
   one request set each, every prefill's attention on K7 — greedy tokens
   equal bit for bit, the page pool conserved, K7 launched 36 times per
   prefill, and one prefill's logits held to the same prefill on K7's
   plain version; and ``mamba2-370m`` at all 48 layers and published
   widths behind a dense engine, 8 requests of 2040-token prompts, every
   prefill's SSD scan on K8 and the pass — each launched 48 times per
   prefill, every request's 32 tokens in the vocabulary, one prefill's
   logits held to the same prefill on their plain composition and the next
   decode step finite.
3. Prints the kernels' record as one JSON line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result;
so it does without a CUDA device, or without the repository around it.
"""
import dataclasses
import gc
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 op/s
#: outside the tensor cores, dense bfloat16 op/s on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12

N_RANKS = 4
WINDOW_ELEMS = 1 << 20        # one rank's window shard: 4 MiB of float32
K1_PAST_L2 = 1 << 23          # K1's second timed shape: 403 MB, past L2
ATOMIC_COUNT = 8              # at the default crossover: the intrinsic path
STEPS = 4
GLOBAL_BATCH, SEQ_LEN = 8, 512
N_LAYERS = 2                  # depth cut for one card; every width is full
# llama4-maverick at full width: 2 of 48 layers (one dense + one MoE layer,
# a whole interleave period) and 8 of 128 experts, 2 on each of 4 stacked
# expert-parallel ranks — the share of 4 chips of a 64-chip expert layer
MOE_ARCH = "llama4-maverick-400b-a17b"
MOE_EXPERTS, EP_RANKS, MOE_STEPS = 8, 4, 4
A2A_PHASES = 16               # the JAX planner's count at n = 4 (CPU tests)
# serving: qwen3-4b at all 36 layers and published widths, 8 requests over
# 4 slots.  Prompts are 1016 tokens (1024 - 8): one ending mid-page is what
# lets a copy-on-write fork happen at 16-token pages; K7 runs them at the
# 1024 its 128 blocks pad to.  Four share a 512-token prefix, two of those
# are the same prompt (their boundary page is shared copy-on-write).
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_PAGE = 4, 2048, 16
SERVE_REQUESTS, SERVE_PROMPT, SERVE_PREFIX, SERVE_NEW = 8, 1016, 512, 32
#: K7 against its plain version: the JAX kernel test's tolerances
K7_TOL = {"float32": dict(atol=2e-5, rtol=1e-2),
          "bfloat16": dict(atol=2e-2, rtol=1e-2)}
#: a 36-layer bfloat16 prefill on K7 against the same prefill on K7's plain
#: version: max |d logit| over max |logit| (each layer's attention output
#: rounds to bfloat16, ~2^-8 relative, and the differences pass 36 layers)
PREFILL_LOGIT_RTOL = 5e-2
# serving a Mamba2 stack: mamba2-370m at all 48 layers and published widths,
# 8 requests of 2040-token prompts over 4 slots, 32 new tokens each.  2040
# is no multiple of the 64-token chunk: K8 and the pass take the ragged last
# chunk (56 rows) unpadded in every prefill
SSM_ARCH = "mamba2-370m"
SSM_SLOTS, SSM_MAX_SEQ, SSM_REQUESTS, SSM_PROMPT, SSM_NEW = 4, 4096, 8, 2040, 32
#: K8 against its plain version.  float32: the JAX kernel test's tolerance
#: (tests/test_kernels.py:148-181).  bfloat16 inputs: both sum in float32
#: (the kernel's hi/lo products keep ~2^-16) and round y_intra to bf16
#: once, so y may differ by one bf16 step (at most 2^-7 of |y|); states and
#: cum stay float32 and keep the float32 tolerance
K8_TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
          "bfloat16": dict(atol=1e-3, rtol=2.0**-7)}
#: the SSD pass (and the whole card scan) against its plain version at
#: bfloat16, y only: y = bf16(y_intra + bf16(y_inter)) rounds twice from
#: y_inter values ~2^-16 apart, and y_intra may itself be one step apart
#: (K8_TOL), so each rounding may land one bf16 step (2^-7 of the value
#: rounded) apart: |d| <= atol + 2^-6 (|y_intra| + |y_inter|)
PASS_BF16_RTOL = 2.0 ** -6
#: a 48-layer bfloat16 Mamba2 prefill on K8 and the pass against the same
#: prefill on their plain versions: max |d logit| over max |logit| (each
#: layer's y rounds to bfloat16 in both, so entries may differ by one bf16
#: step, ~2^-8 relative, and the differences pass 48 layers — K7's bound
#: and reasoning)
SSM_LOGIT_RTOL = 5e-2


def bound_ms(nbytes: float, ops: float = 0.0,
             peak: float = PEAK_F32) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
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


def graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """Card time of one ``fn()``: ``reps`` calls captured in one CUDA graph
    and the graph replayed, so no host work falls between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up, off the capture
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch import _build
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref as R
    from repro_torch.models import moe as moe_lib

    k1 = sys.modules["repro_torch.kernels.accumulate"]
    k2 = sys.modules["repro_torch.kernels.intrinsic"]
    k3 = sys.modules["repro_torch.kernels.rma_put"]
    k5 = sys.modules["repro_torch.kernels.ring_allreduce"]
    k46 = sys.modules["repro_torch.kernels.ordered_put_signal"]
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for tag, name, kernel in (("K1", "accumulate", "acc_kernel"),
                              ("K5", "ring_allreduce", "ring_ar_kernel")):
        report = _build.ptxas_report(name, kernel)
        check(bool(report), f"no ptxas report of {tag}")
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in report if "Used " in line}, key=int)
        spills = {line.split(": ", 1)[1] for line in report
                  if "spill" in line}
        print(f"[ptxas] {tag}: {len(report) // 2} instance(s), registers "
              f"{', '.join(regs)}; {' | '.join(sorted(spills))}", flush=True)
    for tag, name, kernel in (("K8", "ssd_scan", "ssd_intra"),
                              ("K8 pass", "ssd_pass", "ssd_pass_kernel")):
        report = _build.ptxas_report(name, kernel)
        check(bool(report), f"no ptxas report of {tag}")
        for line in report:
            if "Used" in line or "spill" in line:
                entry, what = line.split(": ", 1)
                variant = ("bf16" if "bfloat16" in entry else "float32")
                print(f"[ptxas] {tag} {variant}: {what}", flush=True)
    k7_ptxas = _build.ptxas_report("flash_attention", "flash_fwd_wgmma")
    check(bool(k7_ptxas), "no ptxas report of K7's bfloat16 kernel")
    for line in k7_ptxas:
        print(f"[ptxas] K7 bf16 {line}", flush=True)
    smem_of = _build.lib("flash_attention", "rt_flash_attention_bf16_smem")
    print(f"[ptxas] K7 bf16 dynamic shared memory per CTA: {smem_of(128)} "
          f"bytes at head_dim 128, {smem_of(64)} at 64", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    record: dict[str, dict] = {}

    # ---- 1. every kernel against its plain version -------------------------
    def rand(shape, dtype):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        return torch.randint(-1000, 1000, shape, generator=gen,
                             device=dev).to(dtype)

    for dtype in (torch.float32, torch.int32):
        for op in k1.ACC_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            for m in (1, 4097, 1_000_003):
                b, u = rand((m,), dtype), rand((m,), dtype)
                want = k1.accumulate_plain(b.clone(), u, op=op)
                check(torch.equal(k1.accumulate(b, u, op=op), want),
                      f"K1 {op} {dtype} m={m}")
        for op in k2.ATOMIC_KERNEL_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            b, u = rand((N_RANKS, 64), dtype), rand((N_RANKS, 5), dtype)
            want = R.ring_accumulate_ref(b, u, axis_size=N_RANKS, op=op,
                                         offset=7)
            got = k2.ring_accumulate(u, b.clone(), axis_size=N_RANKS, op=op,
                                     offset=7)
            check(torch.equal(got, want), f"K2 {op} {dtype}")
        for shape in ((N_RANKS, 13), (8, 1001, 3)):
            x = rand(shape, dtype)
            check(torch.equal(k3.ring_put(x, axis_size=shape[0]),
                              R.ring_put_ref(x, axis_size=shape[0])),
                  f"K3 {shape} {dtype}")
    for dtype in (torch.float64, torch.float16, torch.bfloat16, torch.int64):
        for op in k1.ACC_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            for m in (1, 4097, 1_000_003):
                b, u = rand((m,), dtype), rand((m,), dtype)
                want = k1.accumulate_plain(b.clone(), u, op=op)
                check(torch.equal(k1.accumulate(b, u, op=op), want),
                      f"K1 {op} {dtype} m={m}")
    # odd-offset (misaligned) column slices of a wider window: the scalar
    # path where the two rows' offsets differ, the scalar head where the
    # buffer's row stride moves each row's offset
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.int32):
        for op in k1.ACC_OPS:
            if op in k1.BITWISE_OPS and dtype.is_floating_point:
                continue
            for off, width in ((1, 4099), (3, 65536), (8, 70001)):
                win = rand((N_RANKS, width + off + 5), dtype)
                u = rand((N_RANKS, width), dtype)
                want = win.clone()
                k1.accumulate_plain(want[:, off:off + width], u, op=op)
                k1.accumulate_rows(win[:, off:off + width], u, op=op)
                check(torch.equal(win, want),
                      f"K1 {op} {dtype} column slice at {off}")
    # K5 at fixed ragged shapes, then 40 random ones (rank counts 2-8,
    # lengths up to 2^24: scalar and vector paths, from a few agents to
    # every resident block with several tiles an agent), so the kernel's
    # own schedules meet the ring's waits
    pick = random.Random(0)
    shapes = [(2, 6), (N_RANKS, 13), (8, 1000), (3, 3001)] + [
        (pick.choice((2, 3, 4, 5, 8)), int(2 ** pick.uniform(0, 24)))
        for _ in range(40)]
    for n, length in shapes:
        x = rand((n, length), torch.float32)
        want = k5.ring_all_reduce_plain(
            torch.cat([x, x.new_zeros((n, (-length) % n))], 1))[:, :length]
        check(torch.equal(k5.ring_all_reduce(x, axis_size=n), want),
              f"K5 {n}x{length}")
    print("[kernels] K1/K2/K3/K5 equal their plain versions: every op, "
          "float32/int32 (K1 also float64/float16/bfloat16/int64, and "
          f"misaligned column slices), ragged tails; K5 at {len(shapes)} "
          "shapes", flush=True)

    # K4 / K6: ordered and Listing-1, every dtype of the paths and every K6
    # op, ragged tails and the all-to-all's own blocks (Cp x (d+1) bf16)
    cfg_moe = get_config(MOE_ARCH)
    d_model = cfg_moe.d_model
    tokens_rank = GLOBAL_BATCH * SEQ_LEN // EP_RANKS
    cp = moe_lib._pair_capacity(cfg_moe.moe, tokens_rank, EP_RANKS)
    a2a_block = (N_RANKS, cp, d_model + 1)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for shape in ((N_RANKS, 13), (8, 1001, 3), (3, 1), a2a_block):
            n_ = shape[0]
            x = rand(shape, dtype)
            for ordered in (True, False):
                f = rand((n_, 2), dtype)
                got = k46.put_signal(x, f, axis_size=n_, ordered=ordered)
                want = k46.put_signal(x.cpu(), f.cpu(), axis_size=n_,
                                      ordered=ordered)
                check(torch.equal(got[0].cpu(), want[0])
                      and torch.equal(got[1].cpu(), want[1]),
                      f"K4 {dtype} {shape} ordered={ordered}")
            if shape == a2a_block and dtype != torch.bfloat16:
                continue
            for op in k46.ATOMIC_KERNEL_OPS:
                if op in k1.BITWISE_OPS and dtype.is_floating_point:
                    continue
                b = rand((n_, shape[1] + 5) + shape[2:], dtype)
                f = rand((n_, 1), dtype)
                for ordered in (True, False):
                    got = k46.accumulate_signal(x, b, f, axis_size=n_, op=op,
                                                offset=3, ordered=ordered)
                    want = k46.accumulate_signal(
                        x.cpu(), b.cpu(), f.cpu(), axis_size=n_, op=op,
                        offset=3, ordered=ordered)
                    check(torch.equal(got[0].cpu(), want[0])
                          and torch.equal(got[1].cpu(), want[1]),
                          f"K6 {op} {dtype} {shape} ordered={ordered}")
    # the ordering check, in the copy unit and launch mode of the launch it
    # checks: at the a2a block the dispatch's own 16-byte copy, ordered
    # (plain launch) and Listing 1 (cooperative)
    ring_t = [(r + 1) % N_RANKS for r in range(N_RANKS)]
    mismatched, units = {}, {}
    for shape, dtype in ((a2a_block, torch.bfloat16), ((N_RANKS, 4097),
                                                       torch.int32)):
        x = rand(shape, dtype)
        for ordered in (True, False):
            dst = torch.zeros_like(x)
            fl = torch.zeros((N_RANKS, 4), dtype=torch.int32, device=dev)
            bad = torch.zeros(1, dtype=torch.int32, device=dev)
            k46.put_signal_rows(x, dst, ring_t,
                                flag=torch.ones((N_RANKS, 1),
                                                dtype=torch.int32),
                                flag_dst=fl, flag_offset=2, ordered=ordered,
                                check=bad)
            mismatched[(shape, ordered)] = bad.item()
            units[shape] = k46.copy_unit(x, dst)
            check(torch.equal(dst, torch.roll(x, 1, 0)),
                  f"K4 check mode {shape} landed wrong")
    check(units[a2a_block] == 16, f"K4 copies the a2a block in "
          f"{units[a2a_block]}-byte units, not 16")
    check(not any(mismatched.values()),
          f"K4 ordering check: units read behind a raised flag differ "
          f"{mismatched}")
    print(f"[kernels] K4/K6 equal their plain versions: ordered and "
          f"unordered, float32/bfloat16/int32, every K6 op, ragged tails, "
          f"the a2a block {list(a2a_block)}; ordering check mismatched units "
          f"{sum(mismatched.values())} (copy units in bytes: "
          f"{ {str(list(k)): v for k, v in units.items()} })", flush=True)

    # main-path shapes: the window tour's (K1, K2, K3) and the gradient
    # ring's (K5)
    n, M = N_RANKS, WINDOW_ELEMS
    win_buf, upd = rand((n, M), torch.float32), rand((n, M), torch.float32)
    want = win_buf + torch.roll(upd, 1, 0)
    got = win_buf.clone()
    k1.accumulate_rows(got, torch.roll(upd, 1, 0), op="sum")
    check(torch.equal(got, want), "K1 at the window shape")
    err = (got - want).abs().max().item()
    landed = torch.roll(upd, 1, 0)
    record["accumulate"] = dict(
        ms=graph_ms(torch, lambda: k1.accumulate_rows(got, landed, op="sum")),
        call_ms=time_ms(torch, lambda: k1.accumulate_rows(got, landed,
                                                          op="sum")),
        plain_ms=graph_ms(torch, lambda: k1.accumulate_plain(got, landed,
                                                             op="sum")),
        library_ms=graph_ms(torch, lambda: got.add_(landed)),
        max_abs_err=err, shape=[n, M], dtype="float32")
    record["accumulate"]["bound_ms"], record["accumulate"]["bound_by"] = \
        bound_ms(3 * n * M * 4, n * M)
    # the same accumulate past the 50 MB L2: (4, 2^23) float32, 403 MB moved
    big_buf, big_upd = rand((n, K1_PAST_L2), torch.float32), \
        rand((n, K1_PAST_L2), torch.float32)
    want = big_buf + big_upd
    k1.accumulate_rows(big_buf, big_upd, op="sum")
    check(torch.equal(big_buf, want), "K1 past L2")
    record["accumulate"]["past_l2"] = dict(
        shape=[n, K1_PAST_L2],
        ms=graph_ms(torch, lambda: k1.accumulate_rows(big_buf, big_upd,
                                                      op="sum")),
        plain_ms=graph_ms(torch, lambda: k1.accumulate_plain(
            big_buf, big_upd, op="sum")),
        library_ms=graph_ms(torch, lambda: big_buf.add_(big_upd)),
        bound_ms=bound_ms(3 * n * K1_PAST_L2 * 4, n * K1_PAST_L2)[0])
    big = record["accumulate"]["past_l2"]
    print(f"[kernel] accumulate past L2 [{n}, {K1_PAST_L2}] float32: "
          f"{big['ms']:.4f} ms ({100 * big['bound_ms'] / big['ms']:.1f} % of "
          f"the {big['bound_ms']:.4f} ms bound), add_ {big['library_ms']:.4f},"
          f" plain {big['plain_ms']:.4f}", flush=True)
    del big_buf, big_upd, want

    small = rand((n, ATOMIC_COUNT), torch.float32)
    tgt = torch.tensor([(r + 1) % n for r in range(n)], dtype=torch.int32,
                       device=dev)      # the origin → target map, on the card
    want = R.ring_accumulate_ref(win_buf, small, axis_size=n, op="sum",
                                 offset=M - ATOMIC_COUNT)
    got = k2.ring_accumulate(small, win_buf.clone(), axis_size=n, op="sum",
                             offset=M - ATOMIC_COUNT)
    check(torch.equal(got, want), "K2 at the window shape")
    err = (got - want).abs().max().item()
    region = got[:, M - ATOMIC_COUNT:]
    tgt_t = tgt.long()
    record["ring_accumulate"] = dict(
        ms=graph_ms(torch, lambda: k2.accumulate_rows_atomic(
            small, got, tgt, op="sum", offset=M - ATOMIC_COUNT)),
        call_ms=time_ms(torch, lambda: k2.accumulate_rows_atomic(
            small, got, tgt, op="sum", offset=M - ATOMIC_COUNT), reps=50),
        plain_ms=graph_ms(torch, lambda: k2.accumulate_rows_atomic_plain(
            small, got, ring_t, op="sum", offset=M - ATOMIC_COUNT)),
        library_ms=graph_ms(torch, lambda: region.index_add_(0, tgt_t,
                                                             small)),
        max_abs_err=err, shape=[n, ATOMIC_COUNT], dtype="float32")
    record["ring_accumulate"]["bound_ms"], \
        record["ring_accumulate"]["bound_by"] = bound_ms(
            3 * n * ATOMIC_COUNT * 4, n * ATOMIC_COUNT)

    got, want = k3.ring_put(upd, axis_size=n), R.ring_put_ref(upd, axis_size=n)
    check(torch.equal(got, want), "K3 at the window shape")
    err = (got - want).abs().max().item()
    dst = torch.empty_like(upd)
    record["ring_put"] = dict(
        ms=graph_ms(torch, lambda: k3.put_rows(upd, dst, tgt)),
        call_ms=time_ms(torch, lambda: k3.put_rows(upd, dst, tgt)),
        plain_ms=graph_ms(torch, lambda: k3.put_rows_plain(upd, dst,
                                                           ring_t)),
        library_ms=graph_ms(torch, lambda: torch.roll(upd, 1, 0)),
        max_abs_err=err, shape=[n, M], dtype="float32")
    record["ring_put"]["bound_ms"], record["ring_put"]["bound_by"] = \
        bound_ms(2 * n * M * 4)

    # K3's flush half: the wait on one stream's counters, after the puts of
    # the window tour's shape (one tick per block each), met and short
    counters = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    ticks = k3.put_rows(upd, dst, tgt, counters=counters, stream=0)
    stalls = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)]
    for owed in ([ticks] * n, [ticks, ticks + 1, ticks, ticks + 1]):
        k3.wait_counters(counters, owed, stream=0, stalls=stalls[0])
        k3.wait_counters_plain(counters, owed, stream=0, stalls=stalls[1])
    check(stalls[0].item() == stalls[1].item() == 2,
          f"K3 wait found {stalls[0].item()} ranks short, plain "
          f"{stalls[1].item()}, of 2")
    err = float(abs(stalls[0].item() - stalls[1].item()))
    owed = [ticks] * n
    # the plain wait copies the owed counts to the card from the host, which
    # a graph cannot capture: it is timed by calls
    record["put_wait"] = dict(
        ms=graph_ms(torch, lambda: k3.wait_counters(
            counters, owed, stream=0, stalls=stalls[0])),
        call_ms=time_ms(torch, lambda: k3.wait_counters(
            counters, owed, stream=0, stalls=stalls[0]), reps=50),
        plain_ms=time_ms(torch, lambda: k3.wait_counters_plain(
            counters, owed, stream=0, stalls=stalls[1]), reps=50),
        library_ms=None, max_abs_err=err, shape=[n, 2], dtype="int32")
    record["put_wait"]["bound_ms"], record["put_wait"]["bound_by"] = \
        bound_ms(4 * n + 4, n)
    check(stalls[0].item() == 2, "K3 wait stalled on met counts")
    del win_buf, upd, got, dst, landed, region

    # K4 at the dispatch's per-peer block, K6 at the combine's: (n, Cp,
    # d+1) and (n, Cp, d) bfloat16, the doorbell an int32 header word
    tgt_ring = torch.tensor(ring_t, dtype=torch.int32, device=dev)
    tgt_long = tgt_ring.long()
    hdr = torch.zeros((n, 2 * n), dtype=torch.int32, device=dev)
    bell = torch.ones((n, 1), dtype=torch.int32, device=dev)
    sig = dict(flag=bell, flag_dst=hdr, flag_offset=n + 1)
    # the arrival counters a window keeps (every launch leaves them at 0)
    scr = torch.zeros(n + 2, dtype=torch.int32, device=dev)
    blk = rand(a2a_block, torch.bfloat16)
    landed_k, landed_p = torch.zeros_like(blk), torch.zeros_like(blk)
    k46.put_signal_rows(blk, landed_k, tgt_ring, **sig)
    k46.put_signal_rows_plain(blk, landed_p, tgt_ring, **sig)
    check(torch.equal(landed_k, landed_p), "K4 at the dispatch block")
    err = (landed_k.float() - landed_p.float()).abs().max().item()
    rolled_flag = torch.zeros_like(hdr)
    record["put_signal"] = dict(
        ms=graph_ms(torch, lambda: k46.put_signal_rows(
            blk, landed_k, tgt_ring, scratch=scr, **sig)),
        plain_ms=graph_ms(torch, lambda: k46.put_signal_rows_plain(
            blk, landed_p, ring_t, **sig)),
        library_ms=graph_ms(torch, lambda: (
            torch.roll(blk, 1, 0),
            rolled_flag[:, n + 1:n + 2].copy_(torch.roll(bell, 1, 0)))),
        max_abs_err=err, shape=list(a2a_block), dtype="bfloat16")
    nbytes = blk.numel() * 2
    record["put_signal"]["bound_ms"], record["put_signal"]["bound_by"] = \
        bound_ms(2 * nbytes + 8 * n)
    # the same put+signal in the Listing-1 shape: every flag waits for
    # every payload of the launch (the cost P2 removes)
    unordered_ms = graph_ms(torch, lambda: k46.put_signal_rows(
        blk, landed_k, tgt_ring, ordered=False, scratch=scr, **sig))
    print(f"[kernel] put_signal {list(a2a_block)} unordered (Listing 1): "
          f"{unordered_ms:.4f} ms against {record['put_signal']['ms']:.4f} "
          f"ordered", flush=True)
    comb = (n, cp, d_model)
    yb = rand(comb, torch.bfloat16)
    cur = rand(comb, torch.bfloat16)
    out_k, out_p = cur.clone(), cur.clone()
    k46.accumulate_signal_rows(yb, out_k, tgt_ring, op="sum", **sig)
    k46.accumulate_signal_rows_plain(yb, out_p, tgt_ring, op="sum", **sig)
    check(torch.equal(out_k, out_p), "K6 at the combine block")
    err = (out_k.float() - out_p.float()).abs().max().item()
    record["accumulate_signal"] = dict(
        ms=graph_ms(torch, lambda: k46.accumulate_signal_rows(
            yb, out_k, tgt_ring, op="sum", scratch=scr, **sig)),
        plain_ms=graph_ms(torch, lambda: k46.accumulate_signal_rows_plain(
            yb, out_p, ring_t, op="sum", **sig)),
        library_ms=graph_ms(torch, lambda: out_p.index_add_(0, tgt_long,
                                                            yb)),
        max_abs_err=err, shape=list(comb), dtype="bfloat16")
    record["accumulate_signal"]["bound_ms"], \
        record["accumulate_signal"]["bound_by"] = bound_ms(
            3 * yb.numel() * 2 + 8 * n, yb.numel())
    check(not scr.any(), "K4/K6 left their arrival counters set")
    del blk, landed_k, landed_p, yb, cur, out_k, out_p

    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    cfg = get_config("qwen3-4b").replace(n_layers=N_LAYERS)
    n_params = sum(p.numel() for p in leaves(
        build_model(cfg).init(0, device="meta")))
    width = -(-n_params // (4 * n)) * (4 * n)      # the train step's layout
    print(f"[plan] qwen3-4b x{N_LAYERS} layers: {n_params} parameters; "
          f"params {n_params * 4 / 2**30:.1f} GiB, ({n}, P) gradient matrix "
          f"{n * width * 4 / 2**30:.1f} GiB, Adam state "
          f"{2 * n_params * 4 / 2**30:.1f} GiB; K5 reduces it in place",
          flush=True)
    x = rand((n, width), torch.float32)
    total = x.sum(0)
    y = x.clone()
    k5.ring_all_reduce(y, axis_size=n, inplace=True)
    k5.ring_all_reduce_plain(x)
    check(torch.equal(x, y), "K5 != its plain ring at the gradient shape")
    err = (y[0] - total).abs().max().item()
    check(torch.allclose(y[0], total, rtol=1e-5, atol=1e-5),
          f"K5 vs the sum oracle: max abs err {err}")
    del x, total
    summed = torch.empty(width, device=dev)

    def ar():
        k5.ring_all_reduce(y, axis_size=n, inplace=True)

    def library_sum():
        torch.sum(y, 0, out=summed)

    def first_after_free(fn) -> float:
        """One call right after the 19.6 GB the check above held is freed
        and the cache emptied: the first K5 calls there read slower than
        the train step's, which frees nothing between steps."""
        torch.cuda.empty_cache()
        junk = torch.empty((n + 1, width), device=dev)
        del junk
        torch.cuda.empty_cache()
        return time_ms(torch, fn, reps=1, warmup=0)

    r5 = record["ring_all_reduce"] = dict(
        first_ms=first_after_free(ar),
        ms=time_ms(torch, ar, reps=5, warmup=3),
        library_first_ms=first_after_free(library_sum),
        library_ms=time_ms(torch, library_sum, reps=5, warmup=3),
        plain_ms=time_ms(torch, lambda: k5.ring_all_reduce_plain(y), reps=1),
        max_abs_err=err, shape=[n, width], dtype="float32",
        design="in place behind the neighbour's ready word, 16-byte vector "
               "loads into registers, tile counters (2048 floats a tile), "
               "last reduce-scatter hop fused with all-gather hop 0, L2 "
               "evict-first hints, every resident block")
    r5["bound_ms"], r5["bound_by"] = bound_ms(2 * n * width * 4,
                                              (n - 1) * width)
    r5["tbps_of_2x"] = 2 * n * width * 4 / r5["ms"] / 1e9
    print(f"[kernel] ring_all_reduce [{n}, {width}]: {r5['ms']:.3f} ms "
          f"warmed ({r5['first_ms']:.3f} the first call after a free), "
          f"{r5['tbps_of_2x']:.2f} TB/s of the 2X bound's bytes; "
          f"torch.sum {r5['library_ms']:.3f} ms warmed "
          f"({r5['library_first_ms']:.3f} first); design: {r5['design']}",
          flush=True)
    del summed
    del y
    torch.cuda.empty_cache()

    # K7 at the JAX kernel test's shapes (f32 and bf16) and the prefill's,
    # each call's variant read from the counter's split
    k7 = sys.modules["repro_torch.kernels.flash_attention"]

    def k7_check(what, q, k, v, **kw):
        before = dict(k7.COUNTER.by_variant)
        got = k7.flash_attention(q, k, v, **kw)
        ran = [n_ for n_, c in k7.COUNTER.by_variant.items()
               if c != before.get(n_, 0)]
        want = k7.flash_attention_plain(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        dt = str(q.dtype).split(".")[1]
        check(ran == [k7.VARIANTS[q.dtype]], f"K7 {what} {dt} ran {ran}")
        check(torch.allclose(got.float(), want.float(), **K7_TOL[dt]),
              f"K7 {what} {dt}: max err {err}")
        print(f"[kernel] flash_attention {what} {dt}: variant {ran[0]}, "
              f"max abs err {err:.3g} (atol {K7_TOL[dt]['atol']})",
              flush=True)
        return err

    for dtype in (torch.float32, torch.bfloat16):
        for b_, h_, s_, hd_, causal, bq, bkv in (
                (2, 4, 256, 64, True, 64, 64), (1, 2, 128, 32, False, 64, 32),
                (1, 1, 512, 128, True, 128, 128),
                (3, 2, 192, 64, True, 64, 64)):
            q, k, v = (rand((b_, h_, s_, hd_), dtype) for _ in range(3))
            k7_check(f"{(b_, h_, s_, hd_)} causal={causal}", q, k, v,
                     causal=causal, block_q=bq, block_kv=bkv)
    cfg_serve = get_config("qwen3-4b")
    H_, KV_, HD_ = cfg_serve.n_heads, cfg_serve.n_kv_heads, cfg_serve.head_dim
    S_ = 1024                        # SERVE_PROMPT rounded up to K7's tile
    q = rand((1, H_, S_, HD_), torch.bfloat16)
    k, v = (rand((1, KV_, S_, HD_), torch.bfloat16) for _ in range(2))
    err = k7_check(f"(1, {H_}, {S_}, {HD_}) causal GQA {H_}/{KV_}", q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    record["flash_attention"] = dict(
        ms=graph_ms(torch, lambda: k7.flash_attention(q, k, v)),
        plain_ms=graph_ms(torch, lambda: k7.flash_attention_plain(q, k, v)),
        library_ms=graph_ms(torch, lambda: sdpa(q, k, v, is_causal=True,
                                                enable_gqa=True)),
        max_abs_err=err, shape=[1, H_, S_, HD_], dtype="bfloat16",
        variant=k7.VARIANTS[torch.bfloat16])
    pairs = S_ * (S_ + 1) // 2       # causal (query, key) pairs this run needs
    k7_ops = 4 * HD_ * H_ * pairs
    r7 = record["flash_attention"]
    r7["bound_ms"], r7["bound_by"] = bound_ms(
        2 * (q.numel() + k.numel() + v.numel() + q.numel()), k7_ops,
        peak=PEAK_BF16)
    r7["tflops"] = k7_ops / r7["ms"] / 1e9
    r7["vs_library"] = r7["ms"] / r7["library_ms"]
    print(f"[kernel] flash_attention (1, {H_}, {S_}, {HD_}) bfloat16 causal "
          f"GQA {H_}/{KV_}: {r7['variant']} {r7['ms']:.4f} ms, "
          f"{r7['tflops']:.1f} TFLOP/s of causal pairs "
          f"({100 * r7['tflops'] * 1e12 / PEAK_BF16:.1f} % of the bf16 "
          f"peak), {r7['vs_library']:.2f} x scaled_dot_product_attention's "
          f"{r7['library_ms']:.4f} ms in this call", flush=True)
    # the prefill's own call: head-transposed views of (1, 1016, heads, 128)
    # tensors, no pad, the output a view of a (1, 1016, 32, 128) tensor
    qs = rand((1, SERVE_PROMPT, H_, HD_), torch.bfloat16)
    ks, vs = (rand((1, SERVE_PROMPT, KV_, HD_), torch.bfloat16)
              for _ in range(2))
    views = (qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2))
    blk = dict(block_q=SERVE_PROMPT, block_kv=SERVE_PROMPT)
    k7_check(f"views of (1, {SERVE_PROMPT}, {H_}/{KV_}, {HD_})", *views,
             **blk)
    check(k7.flash_attention(*views, **blk).transpose(1, 2).is_contiguous(),
          "K7's prefill output is not a view of (B, S, H, D)")
    r7["prefill_views_ms"] = graph_ms(
        torch, lambda: k7.flash_attention(*views, **blk))
    print(f"[kernel] flash_attention prefill views (1, {SERVE_PROMPT}, "
          f"{H_}/{KV_}, {HD_}): {r7['prefill_views_ms']:.4f} ms", flush=True)
    del q, k, v, qs, ks, vs, views

    # K8 and the SSD pass: K8 at the JAX kernel test's shapes in float32 and
    # bfloat16 and at the prefill's (1, 2048, 32 x 64), N 128, chunk 64,
    # bf16; the pass on K8's card outputs against its plain version (the
    # JAX glue) at the same shapes, with and without an initial state; the
    # whole card scan against the sequential oracle in float32
    # (initial state, ragged length) and against the plain scan at the
    # 2040-token prefill in bf16, with its B and C as the model's slices;
    # and one scan traced: exactly two kernels, K8 then the pass
    k8 = sys.modules["repro_torch.kernels.ssd_scan"]
    kp = sys.modules["repro_torch.kernels.ssd_pass"]
    from repro_torch.kernels import ops as ops_mod
    from torch.profiler import ProfilerActivity, profile

    def ssd_inputs(b_, l_, h_, p_, n_, dtype):
        xdt = rand((b_, l_, h_ * p_), torch.float32) * 0.5
        a = -torch.nn.functional.softplus(rand((b_, l_, h_), torch.float32))
        bm, cm = (rand((b_, l_, n_), torch.float32) * 0.5 for _ in range(2))
        return xdt.to(dtype), a, bm.to(dtype), cm.to(dtype)

    def max_err(got, want):
        return max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))

    def k8_check(args, kw, dtype, what):
        got = k8.ssd_intra_chunk(*args, **kw)
        want = k8.ssd_intra_chunk_plain(*args, **kw)
        for name, g, w, tol in zip(
                ("y_intra", "states", "cum"), got, want,
                (K8_TOL[str(dtype).split(".")[1]], K8_TOL["float32"],
                 K8_TOL["float32"])):
            check(g.dtype == w.dtype and g.shape == w.shape
                  and torch.allclose(g.float(), w.float(), **tol),
                  f"K8 {what} {name}: max err "
                  f"{(g.float() - w.float()).abs().max().item()}")
        return max_err(got, want)

    def y_check(got, want, y_intra, what):
        """bf16 y against the plain version's: PASS_BF16_RTOL of |y_intra|
        + |y_inter| (the plain version's values) plus K8's atol."""
        scale = y_intra.float().abs() + (want.float() - y_intra.float()).abs()
        d = (got.float() - want.float()).abs()
        check(bool((d <= K8_TOL["bfloat16"]["atol"]
                    + PASS_BF16_RTOL * scale).all()),
              f"{what}: max err {d.max().item()}")

    def pass_check(args, kw, dtype, what, s0=None):
        """The pass on K8's card outputs against its plain version."""
        y_intra, states, cum = k8.launch_intra_chunk(*args, **kw)
        ins = (y_intra, states, cum, args[3])
        got = kp.ssd_pass(*ins, **kw, initial_state=s0)
        want = kp.ssd_pass_plain(*ins, **kw, initial_state=s0)
        check(all(g.dtype == w.dtype == dtype and g.shape == w.shape
                  for g, w in zip(got, want)), f"the pass {what}: shapes")
        if dtype == torch.float32:
            for g, w in zip(got, want):
                check(torch.allclose(g, w, **K8_TOL["float32"]),
                      f"the pass {what}: max err {(g - w).abs().max().item()}")
        else:
            y_check(got[0], want[0], y_intra.reshape(want[0].shape),
                    f"the pass {what} y")
            check(torch.allclose(got[1].float(), want[1].float(),
                                 **K8_TOL["bfloat16"]),
                  f"the pass {what} final state: max err "
                  f"{max_err(got[1:], want[1:])}")
        return max_err(got, want)

    # the JAX kernel test's shapes, and one whose headdim and d_state are no
    # multiples of 8 (bf16 rows then load one element at a time)
    k8_shapes = ((2, 64, 4, 16, 32, 16), (1, 128, 2, 32, 16, 32),
                 (1, 48, 8, 8, 64, 8), (1, 48, 3, 12, 20, 16))
    pass_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b_, l_, h_, p_, n_, ch in k8_shapes:
            args = ssd_inputs(b_, l_, h_, p_, n_, dtype)
            kw = dict(chunk=ch, nheads=h_, headdim=p_)
            k8_check(args, kw, dtype, (b_, l_, h_, p_, n_, ch, str(dtype)))
            s0 = (rand((b_, h_, p_, n_), torch.float32) * 0.3).to(dtype)
            for init in (None, s0):
                pass_err = max(pass_err, pass_check(
                    args, kw, dtype, (b_, l_, h_, p_, n_, ch, str(dtype)),
                    s0=init))
    # the whole card scan against the sequential oracle, float32: the JAX
    # initial-state case (tests/test_kernels.py:163) and ragged lengths
    for b_, l_, h_, p_, n_, ch, init in ((1, 32, 2, 8, 16, 8, True),
                                         (2, 45, 3, 8, 16, 8, False),
                                         (1, 70, 2, 16, 32, 16, True)):
        xdt, a, bm, cm = ssd_inputs(b_, l_, h_, p_, n_, torch.float32)
        s0 = rand((b_, h_, p_, n_), torch.float32) * 0.3 if init else None
        xdt = xdt.reshape(b_, l_, h_, p_)
        got = ops_mod.ssd_scan(xdt, a, bm, cm, chunk=ch, nheads=h_,
                               headdim=p_, initial_state=s0)
        want = R.ssd_scan_ref(xdt, a, bm, cm, initial_state=s0)
        for g, w in zip(got, want):
            check(torch.allclose(g, w, **K8_TOL["float32"]),
                  f"the card scan {(b_, l_, h_, p_, n_, ch, init)} vs the "
                  f"sequential oracle: max err {(g - w).abs().max().item()}")
    cfg_ssm = get_config(SSM_ARCH)
    ssm_h = cfg_ssm.ssm.expand * cfg_ssm.d_model // cfg_ssm.ssm.headdim
    ssm_p, ssm_n, ssm_q = (cfg_ssm.ssm.headdim, cfg_ssm.ssm.d_state,
                           cfg_ssm.ssm.chunk)
    ssm_l = -(-SSM_PROMPT // ssm_q) * ssm_q     # whole chunks over the prompt
    k8_args = ssd_inputs(1, ssm_l, ssm_h, ssm_p, ssm_n, torch.bfloat16)
    k8_kw = dict(chunk=ssm_q, nheads=ssm_h, headdim=ssm_p)
    err = k8_check(k8_args, k8_kw, torch.bfloat16, "at the prefill shape")
    pass_err = max(pass_err, pass_check(k8_args, k8_kw, torch.bfloat16,
                                        "at the prefill shape"))
    record["ssd_intra_chunk"] = dict(
        ms=graph_ms(torch, lambda: k8.ssd_intra_chunk(*k8_args, **k8_kw)),
        plain_ms=graph_ms(torch, lambda: k8.ssd_intra_chunk_plain(
            *k8_args, **k8_kw)),
        library_ms=None, max_abs_err=err,
        shape=[1, ssm_l, ssm_h * ssm_p, ssm_n], dtype="bfloat16")
    k8_outs = k8.ssd_intra_chunk(*k8_args, **k8_kw)
    pass_ins = k8_outs + (k8_args[3],)
    record["ssd_pass"] = dict(
        ms=graph_ms(torch, lambda: kp.ssd_pass(*pass_ins, **k8_kw)),
        plain_ms=graph_ms(torch, lambda: kp.ssd_pass_plain(
            *pass_ins, **k8_kw)),
        library_ms=None, max_abs_err=pass_err,
        shape=[1, ssm_l, ssm_h * ssm_p, ssm_n], dtype="bfloat16")
    # bytes: x, a, B, C read once; y, the float32 states and cum written
    # once.  Operations: the causal (i >= j) pairs of C B^T and of the y
    # product, and every term of the states product
    nc_ = ssm_l // ssm_q
    pairs = nc_ * ssm_q * (ssm_q + 1) // 2
    hp_ = ssm_h * ssm_p
    states_bytes = 4 * nc_ * hp_ * ssm_n
    k8_bytes = (2 * 2 * ssm_l * hp_ + 4 * ssm_l * ssm_h
                + 2 * 2 * ssm_l * ssm_n + states_bytes + 4 * ssm_l * ssm_h)
    k8_ops = 2 * (pairs * ssm_n + pairs * hp_ + ssm_l * hp_ * ssm_n)
    record["ssd_intra_chunk"]["bound_ms"], \
        record["ssd_intra_chunk"]["bound_by"] = bound_ms(
            k8_bytes, k8_ops, peak=PEAK_BF16)
    # the pass: the states, y_intra, C and cum read once, y and the final
    # state written once (no initial state here).  Operations: the read-out
    # C_t . carry for every row and the carry update, once a chunk
    pass_bytes = (states_bytes + 2 * ssm_l * hp_ + 2 * ssm_l * ssm_n
                  + 4 * ssm_l * ssm_h + 2 * ssm_l * hp_ + 2 * hp_ * ssm_n)
    pass_ops = 2 * ssm_l * hp_ * ssm_n + 2 * nc_ * hp_ * ssm_n
    record["ssd_pass"]["bound_ms"], record["ssd_pass"]["bound_by"] = \
        bound_ms(pass_bytes, pass_ops, peak=PEAK_BF16)
    # the whole scan at the 2040-token prefill, B and C sliced from one
    # projection as the model hands them over, against the plain scan
    xdt, a, bm, cm = (t[:, :SSM_PROMPT] for t in k8_args)
    xbc = torch.cat([bm, cm], -1)
    xdt = xdt.reshape(1, SSM_PROMPT, ssm_h, ssm_p)
    s0 = (rand((1, ssm_h, ssm_p, ssm_n), torch.float32) * 0.3).to(
        torch.bfloat16)
    scan_args = (xdt, a, xbc[..., :ssm_n], xbc[..., ssm_n:])
    got = ops_mod.ssd_scan(*scan_args, **k8_kw, initial_state=s0)
    want = ops_mod.ssd_scan_plain(*scan_args, **k8_kw, initial_state=s0)
    yi_plain = k8.ssd_intra_chunk_plain(
        *(torch.nn.functional.pad(t, (0, 0, 0, ssm_l - SSM_PROMPT))
          for t in (xdt.reshape(1, SSM_PROMPT, hp_), a, bm, cm)),
        **k8_kw)[0][:, :SSM_PROMPT].reshape(want[0].shape)
    y_check(got[0], want[0], yi_plain, "the card scan at the prefill")
    check(torch.allclose(got[1].float(), want[1].float(),
                         **K8_TOL["bfloat16"]),
          f"the card scan's final state at the prefill: max err "
          f"{max_err(got[1:], want[1:])}")
    scan_ms = graph_ms(torch, lambda: ops_mod.ssd_scan(*scan_args, **k8_kw))
    scan_plain_ms = graph_ms(
        torch, lambda: ops_mod.ssd_scan_plain(*scan_args, **k8_kw))
    # one card scan traced, bf16 at the prefill and float32 ragged: two
    # kernels, K8's then the pass's, and nothing else on the card
    f32_args = ssd_inputs(2, 45, 3, 8, 16, torch.float32)
    for what, scan_in, kw in (
            ("bf16 prefill", scan_args, k8_kw),
            ("float32 ragged", (f32_args[0].reshape(2, 45, 3, 8),)
             + f32_args[1:], dict(chunk=8, nheads=3, headdim=8))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ops_mod.ssd_scan(*scan_in, **kw)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
        check(len(names) == 2 and "ssd_intra" in names[0]
              and "ssd_pass" in names[1],
              f"one {what} card scan ran {names}, want K8 then the pass")
    print(f"[kernels] K8 equals its plain version: the JAX kernel test's "
          f"three shapes and (1, 48, 3x12) N 20 chunk 16 in float32 and "
          f"bfloat16, and (1, {ssm_l}, "
          f"{ssm_h}x{ssm_p}) N {ssm_n} chunk {ssm_q} bfloat16 (max abs err "
          f"{err:.3g}); {k8_bytes / 1e6:.2f} MB, {k8_ops / 1e9:.3f} GFLOP",
          flush=True)
    print(f"[kernels] the SSD pass equals its plain version on K8's outputs "
          f"at the same shapes, with and without an initial state (max abs "
          f"err {pass_err:.3g}); {pass_bytes / 1e6:.2f} MB", flush=True)
    print(f"[kernels] the card scan (K8 + pass) equals the sequential oracle "
          f"in float32 (initial state; L 45 and 70, ragged) and the plain "
          f"scan at (1, {SSM_PROMPT}, {ssm_h}x{ssm_p}) bf16 with B and C "
          f"sliced from one projection: {scan_ms:.4f} ms against "
          f"{scan_plain_ms:.4f} plain; one scan traced is two kernels, K8 "
          f"then the pass (bf16 prefill, float32 ragged)", flush=True)
    del k8_args, k8_outs, pass_ins, scan_args, xdt, a, bm, cm, xbc, s0, \
        got, want, yi_plain
    for name, r in record.items():
        lib_ms = r["library_ms"]
        calls = (f", wrapper calls {r['call_ms']:.4f}" if "call_ms" in r
                 else "")
        print(f"[kernel] {name} {r['shape']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']}{calls})", flush=True)

    # ---- 2. the paths, every launch counter from 0 just before each -------
    from repro_torch.core.rma import (Window, WindowConfig, all_to_all_plan,
                                      put_signal)
    from repro_torch.launch.train import train

    launches = {name: 0 for name in K.COUNTERS}

    def path_counts(what: str, must) -> dict:
        """Read the counters after a path: each of its kernels launched,
        and every launch added to the record."""
        got = K.launch_counts()
        for name in must:
            check(got[name] > 0, f"{what}: kernel {name} never launched")
        for name, c in got.items():
            launches[name] += c
        print(f"[launches] {what}: {got}", flush=True)
        return got

    K.reset_launch_counts()
    buf = torch.zeros((n, M), device=dev)
    win = Window.allocate(buf, "x", n, WindowConfig(
        scope="thread", order=True, max_streams=2))
    sumwin = win.dup_with_info(same_op="sum", max_atomic_elems=ATOMIC_COUNT)
    check(sumwin.substrate is win.substrate, "dup is not zero-copy")
    ring = [(r, (r + 1) % n) for r in range(n)]
    data = rand((n, M), torch.float32)
    win.put(data, ring, stream=0)
    check(win.ledger.by_kind["put"] == 1, "put != 1 phase")
    waits = K.COUNTERS["put_wait"]
    win.flush(stream=1)                  # nothing in flight on stream 1
    check(win.ledger.by_kind["flush"] == 0 and waits.count == 0,
          "idle thread flush paid phases or waited")
    win.flush(stream=0)
    check(win.ledger.by_kind["flush"] == 2, "thread-scope flush != 2 phases")
    check(waits.count == 1, "thread-scope flush != one wait on its counters")
    check(torch.equal(buf, torch.roll(data, 1, 0)), "put landed wrong")
    check(win.substrate.completion_ok(), "put completion counters")
    expect = buf.clone()
    small = rand((n, ATOMIC_COUNT), torch.float32)
    sumwin.accumulate(small, ring, op="sum", offset=0)          # K2
    expect[:, :ATOMIC_COUNT] += torch.roll(small, 1, 0)
    check(win.ledger.by_kind["accumulate"] == 1, "intrinsic != 1 phase")
    sumwin.accumulate(data, ring, op="sum")                      # K3 + K1
    expect += torch.roll(data, 1, 0)
    check(win.ledger.by_kind["accumulate"] == 2, "tiled != 1 phase")
    win.accumulate(small, ring, op="sum", offset=ATOMIC_COUNT)   # software
    expect[:, ATOMIC_COUNT:2 * ATOMIC_COUNT] += torch.roll(small, 1, 0)
    check(win.ledger.by_kind["accumulate"] == 4, "software != 2 phases")
    win.flush(stream=0)
    check(torch.equal(buf, expect), "accumulates landed wrong")
    check(not win.group.pending, "flush left ops in flight")
    check(win.substrate.completion_ok(), "accumulate completion counters")
    print(f"[window] ledger {dict(win.ledger.by_kind)}: put 1, thread flush "
          "2, intrinsic 1, tiled 1, software 2 — the reference cost model",
          flush=True)
    # the quickstart's put_signal (paper Listings 2 and 1): payload then
    # doorbell, one K4 launch, on an ordered and on an unordered window
    signal_phases = {}
    for order, want_phases in ((True, 2), (False, 4)):
        sw = Window.allocate(torch.zeros((n, M), device=dev), "x", n,
                             WindowConfig(scope="thread", order=order,
                                          same_op="sum",
                                          accumulate_ops=("sum",)))
        payload = rand((n, M - 8), torch.float32)
        put_signal(sw, payload, ring, data_offset=0, flag_offset=M - 1)
        signal_phases[order] = sw.ledger.total
        check(sw.ledger.total == want_phases,
              f"put_signal order={order}: {sw.ledger.total} phases, the "
              f"reference cost model bills {want_phases}")
        sw.flush(stream=0)
        check(torch.equal(sw.buffer[:, :M - 8], torch.roll(payload, 1, 0))
              and bool((sw.buffer[:, M - 1] == 1).all()),
              f"put_signal order={order} landed wrong")
        check(sw.substrate.completion_ok(),
              f"put_signal order={order} completion counters")
    print(f"[window] put_signal phases ordered {signal_phases[True]}, "
          f"unordered {signal_phases[False]} (reference: 2 and 4)",
          flush=True)
    path_counts("window tour", ("accumulate", "ring_accumulate", "ring_put",
                                "put_wait", "put_signal"))
    del buf, win, sumwin, data, expect, sw, payload
    torch.cuda.empty_cache()

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = train("qwen3-4b", tiny=False, n_layers=N_LAYERS, steps=STEPS,
                global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN, peak_lr=1e-3,
                warmup_steps=0, grad_sync="rma_ring", dp_ranks=n,
                device="cuda", log_every=1)
    counts = path_counts("qwen3-4b step", ("ring_all_reduce", "put_wait"))
    check(run.n_params == n_params, "parameter count")
    check(all(v == v and abs(v) < 1e6 for v in run.losses), "loss not finite")
    check(run.losses[-1] < run.losses[0], f"loss did not fall: {run.losses}")
    check(counts["ring_all_reduce"] == STEPS, "K5 did not run once per step")
    check(run.phases == 2 * n, "ring + exit epoch != 2n phases")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(len(run.part_ms) == STEPS, "the step's parts were not timed")
    parts = {k: [round(p[k], 2) for p in run.part_ms]
             for k in run.part_ms[0]}
    print(f"[train] qwen3-4b d2560 x{N_LAYERS} layers, {n} ranks, batch "
          f"{GLOBAL_BATCH}x{SEQ_LEN} bf16: losses "
          f"{[round(v, 4) for v in run.losses]}; step ms "
          f"{[round(v, 1) for v in run.step_ms]}; parts ms (CUDA events) "
          f"{parts}; peak memory {peak_gib:.1f} GiB", flush=True)
    del run
    torch.cuda.empty_cache()

    # the planned all-to-all at the MoE exchange's shape: the kernels' run
    # is held bit for bit to the same plan run op by op (K3 transfers, K2
    # doorbells), and its ledger to the JAX planner's count
    a2a_shape = (n * cp, d_model + 1)
    send_counts = torch.randint(0, cp + 1, (n, n), generator=gen, device=dev,
                                dtype=torch.int32)

    def a2a_windows(x, op):
        hdr_w = Window.allocate(
            torch.zeros((n, 2 * n), dtype=torch.int32, device=dev), "x", n,
            WindowConfig(scope="thread", order=True, max_streams=2,
                         same_op="sum", accumulate_ops=("sum",)))
        acc = {} if op is None else {"same_op": op, "accumulate_ops": (op,)}
        data_w = Window.allocate(x.clone(), "x", n, WindowConfig(
            scope="thread", order=True, max_streams=2, **acc))
        return {"data": data_w, "hdr": hdr_w}

    a2a_cases = []
    for dtype in (torch.int32, torch.bfloat16):
        x = rand((n,) + a2a_shape, dtype)
        for op in (None, "sum"):
            compiled = all_to_all_plan("x", n, a2a_shape, dtype, op=op)
            kinds = {low[1] for low in compiled.lowering}
            check(kinds == {"k4" if op is None else "k6"},
                  f"a2a op={op}: lowering {compiled.lowering}")
            opbyop = dataclasses.replace(compiled, signal_pairs=())
            want = opbyop.execute(a2a_windows(x, op),
                                  {"x": x, "counts": send_counts}).outputs
            a2a_cases.append((x, op, compiled, want))
    K.reset_launch_counts()
    for x, op, compiled, want in a2a_cases:
        wins = a2a_windows(x, op)
        got = compiled.execute(wins, {"x": x, "counts": send_counts}).outputs
        for name in ("out", "counts", "bells"):
            check(torch.equal(got[name], want[name]),
                  f"a2a {x.dtype} op={op}: {name} differs from op by op")
        ledger = sum(w.ledger.total for w in wins.values())
        check(ledger == compiled.phases == A2A_PHASES,
              f"a2a {x.dtype} op={op}: ledger {ledger}, planned "
              f"{compiled.phases}, JAX planner {A2A_PHASES}")
    counts = path_counts("all-to-all", ("put_signal", "accumulate_signal"))
    check(counts["put_signal"] == counts["accumulate_signal"] == 2 * (n - 1),
          f"a2a launches {counts}: want one K4 (plain) or K6 (sum) per peer "
          f"and exchange")
    print(f"[a2a] n={n} blocks ({cp}, {d_model + 1}) int32 and bfloat16, "
          f"op None/sum: bit-identical to op by op; ledger {A2A_PHASES} "
          f"phases = the JAX planner's; K4 {counts['put_signal']}, K6 "
          f"{counts['accumulate_signal']} launches", flush=True)
    del a2a_cases, x, want, got, wins
    torch.cuda.empty_cache()

    # the expert-parallel train step at full width
    moe_cfg = cfg_moe.replace(n_layers=N_LAYERS, moe=dataclasses.replace(
        cfg_moe.moe, num_experts=MOE_EXPERTS))
    moe_params = sum(p.numel() for p in leaves(
        build_model(moe_cfg).init(0, device="meta")))
    print(f"[plan] {MOE_ARCH} x{N_LAYERS} layers, {MOE_EXPERTS} experts over "
          f"{EP_RANKS} ranks: {moe_params} parameters, "
          f"{moe_params * 16 / 2**30:.1f} GiB of weights, gradients and Adam "
          f"state", flush=True)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run = train(MOE_ARCH, tiny=False, n_layers=N_LAYERS,
                num_experts=MOE_EXPERTS, steps=MOE_STEPS,
                global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN, peak_lr=1e-3,
                warmup_steps=0, grad_sync="gspmd", moe_ep="rma",
                ep_ranks=EP_RANKS, device="cuda", log_every=1)
    counts = path_counts(f"{MOE_ARCH} step", ("put_signal",
                                              "accumulate_signal"))
    check(run.n_params == moe_params, "MoE parameter count")
    check(all(v == v and abs(v) < 1e6 for v in run.losses), "loss not finite")
    check(run.losses[-1] < run.losses[0], f"loss did not fall: {run.losses}")
    # per MoE layer and step: dispatch (K4) and combine (K6) forward, and
    # each one's transpose in the backward, n-1 peers each
    per_step = 2 * (EP_RANKS - 1)
    check(counts["put_signal"] == counts["accumulate_signal"]
          == per_step * MOE_STEPS,
          f"K4/K6 launches {counts['put_signal']}/"
          f"{counts['accumulate_signal']}, want {per_step} each per step")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(len(run.part_ms) == MOE_STEPS, "the step's parts were not timed")
    parts = {k: [round(p[k], 2) for p in run.part_ms]
             for k in run.part_ms[0]}
    print(f"[train] {MOE_ARCH} d{d_model} x{N_LAYERS} layers (dense, MoE), "
          f"{MOE_EXPERTS} experts top-{cfg_moe.moe.top_k} over {EP_RANKS} "
          f"ranks, batch {GLOBAL_BATCH}x{SEQ_LEN} bf16: losses "
          f"{[round(v, 4) for v in run.losses]}; step ms "
          f"{[round(v, 1) for v in run.step_ms]}; parts ms (CUDA events; "
          f"exchanges lie inside grads) {parts}; peak memory "
          f"{peak_gib:.1f} GiB", flush=True)

    del run
    torch.cuda.empty_cache()

    # the serving path: qwen3-4b at all 36 layers, one request set through a
    # dense engine and a paged engine with copy-on-write prefix sharing
    import numpy as np

    from repro_torch.serve.engine import Request, ServeEngine

    attn_mod = sys.modules["repro_torch.models.attention"]
    serve_model = build_model(cfg_serve)
    t0 = time.perf_counter()
    serve_params = serve_model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_serve = sum(p.numel() for p in leaves(serve_params))
    print(f"[plan] {cfg_serve.name} x{cfg_serve.n_layers} layers d"
          f"{cfg_serve.d_model}: {n_serve} float32 parameters "
          f"({n_serve * 4 / 2**30:.1f} GiB) initialized on the card from seed "
          f"0 in {time.perf_counter() - t0:.1f} s", flush=True)
    prng = np.random.RandomState(0)
    prefix = prng.randint(0, cfg_serve.vocab, size=SERVE_PREFIX)
    prompts = [np.concatenate([prefix, prng.randint(
        0, cfg_serve.vocab, size=SERVE_PROMPT - SERVE_PREFIX)])
        for _ in range(3)]
    prompts.append(prompts[2].copy())
    prompts += [prng.randint(0, cfg_serve.vocab, size=SERVE_PROMPT)
                for _ in range(SERVE_REQUESTS - len(prompts))]
    serve_out = {}
    for mode, kw in (("dense", {}),
                     ("paged+cow", dict(paged_kv=True, page_tokens=SERVE_PAGE,
                                        prefix_share=True))):
        eng = ServeEngine(serve_model, serve_params, n_slots=SERVE_SLOTS,
                          max_seq=SERVE_MAX_SEQ, **kw)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid, prompt, SERVE_NEW))
        spent = {"prefill": [], "decode": []}
        for part in spent:            # both calls end in a host read
            def timed(*a, _fn=getattr(eng.executor, part), _t=spent[part]):
                t = time.perf_counter()
                out = _fn(*a)
                _t.append((time.perf_counter() - t) * 1e3)
                return out
            setattr(eng.executor, part, timed)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run(strict=True)
        wall = time.perf_counter() - t0
        counts = path_counts(f"serve {mode}", ("flash_attention",))
        n_prefill = len(spent["prefill"])
        check(n_prefill == SERVE_REQUESTS, f"{mode}: {n_prefill} prefills")
        check(counts["flash_attention"] == cfg_serve.n_layers * n_prefill,
              f"{mode}: K7 launched {counts['flash_attention']} times, want "
              f"{cfg_serve.n_layers} x {n_prefill} prefills")
        check(k7.COUNTER.by_variant == {
            k7.VARIANTS[torch.bfloat16]: counts["flash_attention"]},
              f"{mode}: K7 variants {k7.COUNTER.by_variant}, want only the "
              f"bfloat16 one")
        tokens = {c.rid: c.tokens for c in done}
        check(sorted(tokens) == list(range(SERVE_REQUESTS)) and all(
            len(t) == SERVE_NEW and all(0 <= x < cfg_serve.vocab for x in t)
            for t in tokens.values()), f"{mode}: tokens {tokens}")
        st = eng.stats()
        if eng.paged_kv:
            eng.pool.check_conservation()
            check(st["cow_copies"] > 0 and st["pages_shared"] > 0,
                  f"{mode}: no page was shared or forked: {st}")
            check(eng.pool.n_free == eng.pool.n_pages,
                  f"{mode}: pages still held after the run: {st}")
        n_tok = sum(len(t) for t in tokens.values())
        serve_out[mode] = tokens
        pre, dec = spent["prefill"], spent["decode"]
        print(f"[serve] {mode}: {SERVE_REQUESTS} requests x {SERVE_PROMPT} "
              f"prompt tokens, {SERVE_NEW} new each, {SERVE_SLOTS} slots, "
              f"max_seq {SERVE_MAX_SEQ}, bf16: {n_tok} tokens in {wall:.2f} s "
              f"({n_tok / wall:.1f} tok/s); prefill ms per request "
              f"{[round(x, 1) for x in pre]}; decode ms per tick median "
              f"{sorted(dec)[len(dec) // 2]:.2f} (min {min(dec):.2f}, max "
              f"{max(dec):.2f}, {len(dec)} ticks); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; stats "
              f"{st}", flush=True)
        del eng
    check(serve_out["dense"] == serve_out["paged+cow"],
          "dense and paged+COW greedy tokens differ")
    print("[serve] dense and paged+COW greedy tokens equal bit for bit",
          flush=True)
    # one prefill on K7 against the same prefill on K7's plain version
    tok = torch.as_tensor(prompts[0], dtype=torch.int64, device=dev)[None]
    logits = {}
    for name, fn in (("K7", attn_mod.flash_attention),
                     ("plain", k7.flash_attention_plain)):
        attn_mod.flash_attention = fn
        try:
            logits[name], _ = serve_model.prefill(
                serve_params, {"tokens": tok},
                serve_model.init_cache(1, SERVE_MAX_SEQ))
        finally:
            attn_mod.flash_attention = k7.flash_attention
    lanes = slice(0, cfg_serve.vocab)     # the padded lanes hold -1e30
    diff = (logits["K7"][..., lanes] - logits["plain"][..., lanes]
            ).abs().max().item()
    scale = logits["plain"][..., lanes].abs().max().item()
    check(bool(torch.isfinite(logits["K7"]).all()), "prefill logits finite")
    check(diff <= PREFILL_LOGIT_RTOL * scale,
          f"prefill logits on K7 vs its plain version: max |d| {diff} of max "
          f"|logit| {scale}")
    print(f"[serve] one prefill's last logits, K7 vs its plain version: max "
          f"|d| {diff:.4g} of max |logit| {scale:.4g} (bound "
          f"{PREFILL_LOGIT_RTOL} x)", flush=True)
    del serve_params, logits
    torch.cuda.empty_cache()

    # serving a Mamba2 stack: mamba2-370m at all 48 layers, a dense engine
    # (its caches are the conv tail and the SSM state: nothing to page)
    ssm_model = build_model(cfg_ssm)
    t0 = time.perf_counter()
    ssm_params = ssm_model.init(0, device="cuda")
    torch.cuda.synchronize()
    n_ssm = sum(p.numel() for p in leaves(ssm_params))
    print(f"[plan] {cfg_ssm.name} x{cfg_ssm.n_layers} layers d"
          f"{cfg_ssm.d_model}, {ssm_h} heads x {ssm_p}, d_state {ssm_n}, "
          f"chunk {ssm_q}: {n_ssm} float32 parameters "
          f"({n_ssm * 4 / 2**30:.2f} GiB) initialized on the card from seed "
          f"0 in {time.perf_counter() - t0:.1f} s", flush=True)
    prng = np.random.RandomState(1)
    ssm_prompts = [prng.randint(0, cfg_ssm.vocab, size=SSM_PROMPT)
                   for _ in range(SSM_REQUESTS)]
    eng = ServeEngine(ssm_model, ssm_params, n_slots=SSM_SLOTS,
                      max_seq=SSM_MAX_SEQ)
    for rid, prompt in enumerate(ssm_prompts):
        eng.submit(Request(rid, prompt, SSM_NEW))
    spent = {"prefill": [], "decode": []}
    for part in spent:                # both calls end in a host read
        def timed(*a, _fn=getattr(eng.executor, part), _t=spent[part]):
            t = time.perf_counter()
            out = _fn(*a)
            _t.append((time.perf_counter() - t) * 1e3)
            return out
        setattr(eng.executor, part, timed)
    # the engines above live on in reference cycles (each timed executor
    # method holds its executor): collect them so that the peak is this one's
    del timed
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = eng.run(strict=True)
    wall = time.perf_counter() - t0
    counts = path_counts("serve-ssm dense", ("ssd_intra_chunk", "ssd_pass"))
    n_prefill = len(spent["prefill"])
    check(n_prefill == SSM_REQUESTS, f"serve-ssm: {n_prefill} prefills")
    for name in ("ssd_intra_chunk", "ssd_pass"):
        check(counts[name] == cfg_ssm.n_layers * n_prefill,
              f"serve-ssm: {name} launched {counts[name]} times, want "
              f"{cfg_ssm.n_layers} x {n_prefill} prefills")
    tokens = {c.rid: c.tokens for c in done}
    check(sorted(tokens) == list(range(SSM_REQUESTS)) and all(
        len(t) == SSM_NEW and all(0 <= x < cfg_ssm.vocab for x in t)
        for t in tokens.values()), f"serve-ssm: tokens {tokens}")
    n_tok = sum(len(t) for t in tokens.values())
    pre, dec = spent["prefill"], spent["decode"]
    print(f"[serve-ssm] dense: {SSM_REQUESTS} requests x {SSM_PROMPT} prompt "
          f"tokens, {SSM_NEW} new each, {SSM_SLOTS} slots, max_seq "
          f"{SSM_MAX_SEQ}, bf16: {n_tok} tokens in {wall:.2f} s "
          f"({n_tok / wall:.1f} tok/s); prefill ms per request "
          f"{[round(x, 1) for x in pre]}; decode ms per tick median "
          f"{sorted(dec)[len(dec) // 2]:.2f} (min {min(dec):.2f}, max "
          f"{max(dec):.2f}, {len(dec)} ticks); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; stats "
          f"{eng.stats()}", flush=True)
    del eng
    # one prefill on the card scan (K8 + pass) against the same prefill on
    # their plain composition, and one decode step after it
    tok = torch.as_tensor(ssm_prompts[0], dtype=torch.int64, device=dev)[None]
    logits = {}
    card_scan = ops_mod.ssd_scan
    for name, fn in (("kernels", card_scan), ("plain", ops_mod.ssd_scan_plain)):
        ops_mod.ssd_scan = fn
        try:
            logits[name], cache = ssm_model.prefill(
                ssm_params, {"tokens": tok},
                ssm_model.init_cache(1, SSM_MAX_SEQ))
        finally:
            ops_mod.ssd_scan = card_scan
    step_logits, _ = ssm_model.decode_step(
        ssm_params, cache, logits["kernels"][:, -1].argmax(-1, keepdim=True))
    lanes = slice(0, cfg_ssm.vocab)       # the padded lanes hold -1e30
    diff = (logits["kernels"][..., lanes] - logits["plain"][..., lanes]
            ).abs().max().item()
    scale = logits["plain"][..., lanes].abs().max().item()
    check(bool(torch.isfinite(logits["kernels"][..., lanes]).all())
          and bool(torch.isfinite(step_logits[..., lanes]).all()),
          "Mamba2 prefill or decode logits not finite")
    check(diff <= SSM_LOGIT_RTOL * scale,
          f"Mamba2 prefill logits on K8 + pass vs their plain versions: max "
          f"|d| {diff} of max |logit| {scale}")
    print(f"[serve-ssm] one prefill's last logits, K8 + pass vs their plain "
          f"versions: "
          f"max |d| {diff:.4g} of max |logit| {scale:.4g} (bound "
          f"{SSM_LOGIT_RTOL} x); the next decode step's logits finite",
          flush=True)
    del ssm_params, logits, cache, step_logits
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3. the record ------------------------------------------------------
    replaces = {
        "accumulate": ("K1", "src/repro/kernels/accumulate.py:84"),
        "ring_accumulate": ("K2", "src/repro/kernels/intrinsic.py:90"),
        "ring_put": ("K3", "src/repro/kernels/rma_put.py:47"),
        "put_wait": ("K3", "src/repro/kernels/rma_put.py:47"),
        "put_signal": ("K4", "src/repro/kernels/ordered_put_signal.py:72"),
        "ring_all_reduce": ("K5", "src/repro/kernels/ring_allreduce.py:108"),
        "accumulate_signal": ("K6",
                              "src/repro/kernels/ordered_put_signal.py:144"),
        "flash_attention": ("K7", "src/repro/kernels/flash_attention.py:84"),
        "ssd_intra_chunk": ("K8", "src/repro/kernels/ssd_scan.py:62"),
        "ssd_pass": ("K8 glue", "src/repro/kernels/ops.py:24"),
    }
    sources = {"accumulate": "accumulate.cu", "ring_accumulate": "intrinsic.cu",
               "ring_put": "rma_put.cu", "put_wait": "rma_put.cu",
               "put_signal": "put_signal.cu",
               "ring_all_reduce": "ring_allreduce.cu",
               "accumulate_signal": "put_signal.cu",
               "flash_attention": "flash_attention.cu",
               "ssd_intra_chunk": "ssd_scan.cu", "ssd_pass": "ssd_pass.cu"}
    rows = []
    for name in replaces:
        r = record[name]
        tag, where = replaces[name]
        rows.append({
            "name": f"{tag} {name}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name]}",
            "replaces": where, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{key: r[key] for key in ("call_ms", "variant", "tflops",
                                       "vs_library", "prefill_views_ms",
                                       "past_l2", "design", "tbps_of_2x",
                                       "first_ms", "library_first_ms")
               if key in r}})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
