#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Builds the four CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once) and holds each against its plain PyTorch
   version on the card: K1 tiled accumulate, K2 atomic accumulate, K3 put
   and its flush wait, K5 ring all-reduce — every op and dtype the kernel
   takes, a ragged tail,
   and the main path's own shapes — timing kernel, plain version and the
   nearest single PyTorch call.
2. Drives the main path with every launch counter at 0: the window layer
   (allocate → dup_with_info → ring put with a thread-scope flush →
   declared accumulates below and above the crossover → an undeclared one),
   each phase-ledger count held to the reference cost model; then a
   data-parallel ``qwen3-4b`` train step at full width (depth cut to 2
   layers) over 4 stacked ranks with the one-sided ring gradient sync.
3. Prints the kernels' record as one JSON line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result;
so it does without a CUDA device, or without the repository around it.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 op/s
#: outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

N_RANKS = 4
WINDOW_ELEMS = 1 << 20        # one rank's window shard: 4 MiB of float32
ATOMIC_COUNT = 8              # at the default crossover: the intrinsic path
STEPS = 4
GLOBAL_BATCH, SEQ_LEN = 8, 512
N_LAYERS = 2                  # depth cut for one card; every width is full


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
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
    from repro_torch.kernels import ref as R

    k1 = sys.modules["repro_torch.kernels.accumulate"]
    k2 = sys.modules["repro_torch.kernels.intrinsic"]
    k3 = sys.modules["repro_torch.kernels.rma_put"]
    k5 = sys.modules["repro_torch.kernels.ring_allreduce"]
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] 4 kernel libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
    for n, length in ((2, 6), (N_RANKS, 13), (8, 1000), (3, 3001)):
        x = rand((n, length), torch.float32)
        want = k5.ring_all_reduce_plain(
            torch.cat([x, x.new_zeros((n, (-length) % n))], 1))[:, :length]
        check(torch.equal(k5.ring_all_reduce(x, axis_size=n), want),
              f"K5 {n}x{length}")
    print("[kernels] K1/K2/K3/K5 equal their plain versions: every op, "
          "float32/int32, ragged tails", flush=True)

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
        ms=time_ms(torch, lambda: k1.accumulate_rows(got, landed, op="sum")),
        plain_ms=time_ms(torch, lambda: k1.accumulate_plain(got, landed,
                                                            op="sum")),
        library_ms=time_ms(torch, lambda: got.add_(landed)),
        max_abs_err=err, shape=[n, M], dtype="float32")
    record["accumulate"]["bound_ms"], record["accumulate"]["bound_by"] = \
        bound_ms(3 * n * M * 4, n * M)

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
        ms=time_ms(torch, lambda: k2.accumulate_rows_atomic(
            small, got, tgt, op="sum", offset=M - ATOMIC_COUNT), reps=50),
        plain_ms=time_ms(torch, lambda: k2.accumulate_rows_atomic_plain(
            small, got, tgt, op="sum", offset=M - ATOMIC_COUNT), reps=50),
        library_ms=time_ms(torch, lambda: region.index_add_(0, tgt_t, small),
                           reps=50),
        max_abs_err=err, shape=[n, ATOMIC_COUNT], dtype="float32")
    record["ring_accumulate"]["bound_ms"], \
        record["ring_accumulate"]["bound_by"] = bound_ms(
            3 * n * ATOMIC_COUNT * 4, n * ATOMIC_COUNT)

    got, want = k3.ring_put(upd, axis_size=n), R.ring_put_ref(upd, axis_size=n)
    check(torch.equal(got, want), "K3 at the window shape")
    err = (got - want).abs().max().item()
    dst = torch.empty_like(upd)
    record["ring_put"] = dict(
        ms=time_ms(torch, lambda: k3.put_rows(upd, dst, tgt)),
        plain_ms=time_ms(torch, lambda: k3.put_rows_plain(upd, dst, tgt)),
        library_ms=time_ms(torch, lambda: torch.roll(upd, 1, 0)),
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
    record["put_wait"] = dict(
        ms=time_ms(torch, lambda: k3.wait_counters(
            counters, owed, stream=0, stalls=stalls[0]), reps=50),
        plain_ms=time_ms(torch, lambda: k3.wait_counters_plain(
            counters, owed, stream=0, stalls=stalls[1]), reps=50),
        library_ms=None, max_abs_err=err, shape=[n, 2], dtype="int32")
    record["put_wait"]["bound_ms"], record["put_wait"]["bound_by"] = \
        bound_ms(4 * n + 4, n)
    check(stalls[0].item() == 2, "K3 wait stalled on met counts")
    del win_buf, upd, got, dst, landed, region

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import leaves

    cfg = get_config("qwen3-4b").replace(n_layers=N_LAYERS)
    n_params = sum(p.numel() for p in leaves(
        build_model(cfg).init(0, device="meta")))
    width = -(-n_params // (4 * n)) * (4 * n)      # the train step's layout
    print(f"[plan] qwen3-4b x{N_LAYERS} layers: {n_params} parameters; "
          f"params {n_params * 4 / 2**30:.1f} GiB, ({n}, P) gradient matrix "
          f"{n * width * 4 / 2**30:.1f} GiB, Adam state "
          f"{2 * n_params * 4 / 2**30:.1f} GiB, K5 landing slots "
          f"{2 * width * 4 / 2**30:.1f} GiB", flush=True)
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
    torch.cuda.empty_cache()
    record["ring_all_reduce"] = dict(
        ms=time_ms(torch, lambda: k5.ring_all_reduce(y, axis_size=n,
                                                     inplace=True), reps=3),
        plain_ms=time_ms(torch, lambda: k5.ring_all_reduce_plain(y), reps=1),
        library_ms=time_ms(torch, lambda: torch.sum(y, 0), reps=3),
        max_abs_err=err, shape=[n, width], dtype="float32")
    record["ring_all_reduce"]["bound_ms"], \
        record["ring_all_reduce"]["bound_by"] = bound_ms(
            2 * n * width * 4, (n - 1) * width)
    del y
    torch.cuda.empty_cache()
    for name, r in record.items():
        lib_ms = r["library_ms"]
        print(f"[kernel] {name} {r['shape']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']})", flush=True)

    # ---- 2. the main path, every launch counter from 0 ----------------------
    from repro_torch.core.rma import Window, WindowConfig

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
    del buf, win, sumwin, data, expect
    torch.cuda.empty_cache()

    from repro_torch.launch.train import train

    torch.cuda.reset_peak_memory_stats()
    k5_before = K.COUNTERS["ring_all_reduce"].count
    run = train("qwen3-4b", tiny=False, n_layers=N_LAYERS, steps=STEPS,
                global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN, peak_lr=1e-3,
                warmup_steps=0, grad_sync="rma_ring", dp_ranks=n,
                device="cuda", log_every=1)
    counts = K.launch_counts()
    check(run.n_params == n_params, "parameter count")
    check(all(v == v and abs(v) < 1e6 for v in run.losses), "loss not finite")
    check(run.losses[-1] < run.losses[0], f"loss did not fall: {run.losses}")
    check(counts["ring_all_reduce"] - k5_before == STEPS,
          "K5 did not run once per step")
    check(run.phases == 2 * n, "ring + exit epoch != 2n phases")
    for name, c in counts.items():
        check(c > 0, f"kernel {name} never launched on the main path")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(len(run.part_ms) == STEPS, "the step's parts were not timed")
    parts = {k: [round(p[k], 2) for p in run.part_ms]
             for k in run.part_ms[0]}
    print(f"[train] qwen3-4b d2560 x{N_LAYERS} layers, {n} ranks, batch "
          f"{GLOBAL_BATCH}x{SEQ_LEN} bf16: losses "
          f"{[round(v, 4) for v in run.losses]}; step ms "
          f"{[round(v, 1) for v in run.step_ms]}; parts ms (CUDA events) "
          f"{parts}; peak memory {peak_gib:.1f} GiB", flush=True)

    # ---- 3. the record ------------------------------------------------------
    replaces = {
        "accumulate": ("K1", "src/repro/kernels/accumulate.py:84"),
        "ring_accumulate": ("K2", "src/repro/kernels/intrinsic.py:90"),
        "ring_put": ("K3", "src/repro/kernels/rma_put.py:47"),
        "put_wait": ("K3", "src/repro/kernels/rma_put.py:47"),
        "ring_all_reduce": ("K5", "src/repro/kernels/ring_allreduce.py:108"),
    }
    sources = {"accumulate": "accumulate.cu", "ring_accumulate": "intrinsic.cu",
               "ring_put": "rma_put.cu", "put_wait": "rma_put.cu",
               "ring_all_reduce": "ring_allreduce.cu"}
    rows = []
    for name, r in record.items():
        tag, where = replaces[name]
        rows.append({
            "name": f"{tag} {name}", "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name]}",
            "replaces": where, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
