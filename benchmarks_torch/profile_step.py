#!/usr/bin/env python3
"""Where the time of one train step, or of one prefill and one decode tick
of the serving path, of the port goes on a card.

    python3 benchmarks_torch/profile_step.py [--moe | --serve] [--arch A]

Builds a configuration ``chip_smoke.py`` trains — by default ``qwen3-4b``
at full width with depth cut to 2 layers, 4 stacked data-parallel ranks,
``grad_sync="rma_ring"``; with ``--arch mamba2-370m``, that arch at all 48
layers on the same ranks and ring (its Mamba2 blocks differentiate
``models.ssm.ssd_chunked``); with ``--moe``, ``llama4-maverick-400b-a17b``
at full width with 2 layers and 8 experts over 4 stacked expert-parallel
ranks, ``moe_ep="rma"`` — global batch 8 × 512, runs two warm-up steps, then
traces one step with ``torch.profiler`` (CPU and CUDA activities, input
shapes recorded) and prints:

* the step's wall time (the traced stretch, the final synchronization
  included), the card's busy time (the union of its device intervals,
  ``rmabench.trace.Trace``) and the idle share 1 − busy / wall;
* the device time by part: operators with a vocabulary-sized input (the LM
  head's products and their gradients, the cross-entropy), the K5 gradient
  ring, the K4/K6 doorbell launches of the all-to-all exchanges, and the
  rest;
* the port's own spans (``repro_torch.obs``, recorded while the profiler
  records): each name's count and host time, and the card's idle time by
  the innermost span open at each idle stretch;
* the operators with the most device time, with their input shapes, and the
  kernels with the most time.

With ``--serve``: one of ``chip_smoke.py``'s serving configurations at all
its layers and published widths behind a dense engine of 4 slots —
``qwen3-4b`` (the default: ``max_seq`` 2048, 1016-token prompts),
``--arch mamba2-370m`` (``max_seq`` 4096, 2040-token prompts) or ``--arch
jamba-v0.1-52b`` (one period of 8 layers, ``max_seq`` 2048, 1016-token
prompts) — admits four requests as warm-up, then traces one prefill (a
fifth prompt into slot 0) and one decode tick over the four slots (a
replay of the executor's CUDA graph: no layer spans), and
prints for each the same wall, busy and idle, the kernels' launches and
shares of the busy time (K7 where the stack has attention; K8 and the SSD
pass, the two kernels of the SSD scan, where it has Mamba2 layers), the
port's spans, and the operators and kernels with the most device time.

Needs one CUDA card; exits non-zero without one.
"""
import argparse
import contextlib
import dataclasses
import os
import sys
import time
import types
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

N_LAYERS, N_RANKS, GLOBAL_BATCH, SEQ_LEN, WARMUP = 2, 4, 8, 512, 2
MOE_EXPERTS = 8
#: serving configurations: arch → (slots, max_seq, prompt tokens, layers)
#: (None: all of them)
SERVE = {"qwen3-4b": (4, 2048, 1016, None),
         "mamba2-370m": (4, 4096, 2040, None),
         "jamba-v0.1-52b": (4, 2048, 1016, 8)}
#: train configurations besides the default: arch → layers (None: all)
TRAIN = {"qwen3-4b": N_LAYERS, "mamba2-370m": None}


@contextlib.contextmanager
def traced():
    """Profile the block (CPU and CUDA, input shapes) from a synchronized
    start to a synchronized end; afterwards ``out.prof`` is the profiler,
    ``out.trace`` the device's intervals on the host's clock
    (``rmabench.trace``) and ``out.spans`` the port's spans inside it
    (kept until the next traced block)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from rmabench.trace import MARK, _read
    from repro_torch import obs

    out = types.SimpleNamespace()
    obs.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with record_function(MARK):     # ties the profiler's clock
            t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    out.prof, out.trace = prof, _read(prof, t0, t1)
    out.spans = [s for s in obs.spans() if t0 <= s.t0 and s.t1 <= t1]


def report_busy(what: str, out) -> float:
    """Wall, busy (a union of device intervals) and idle of a traced
    stretch; returns busy ms."""
    tr = out.trace
    wall_ms, busy_ms = tr.window_s * 1e3, tr.busy_s() * 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    print(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle {100 * (1 - busy_ms / wall_ms):.1f} %")
    return busy_ms


def report_spans(out, k: int = 12) -> None:
    """The port's spans: count and host ms by name, and the card's idle ms
    by the innermost span open at each idle stretch."""
    from rmabench import program_spans

    by = defaultdict(lambda: [0, 0.0])
    for s in out.spans:
        by[s.name][0] += 1
        by[s.name][1] += (s.t1 - s.t0) * 1e3
    print("[profile] the port's spans (count, host ms):")
    for name, (n, ms) in sorted(by.items(), key=lambda kv: -kv[1][1])[:k]:
        print(f"  {ms:9.2f}  {n:4d}  {name}")
    idle = program_spans.idle_by_innermost(types.SimpleNamespace(
        tr=out.trace))
    print("[profile] idle ms by innermost span: " + ", ".join(
        f"{n} {t * 1e3:.2f}" for n, t in list(idle.items())[:k]))


def self_device_us(evt) -> float:
    """Device time of an averaged profiler event, its children excluded."""
    t = getattr(evt, "self_device_time_total", None)
    if t is None:
        t = getattr(evt, "self_cuda_time_total", 0.0)
    return float(t)


def is_kernel(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def report_tops(ops, kernels, n_ops: int = 16, n_kernels: int = 10) -> None:
    print("[profile] operators by device time (self, ms; calls; input shapes):")
    for e in sorted(ops, key=self_device_us, reverse=True)[:n_ops]:
        shapes = [s for s in (e.input_shapes or []) if s][:3]
        print(f"  {self_device_us(e) / 1e3:9.2f}  {e.count:4d}  "
              f"{e.key[:40]:40s} {shapes}")
    print("[profile] kernels by device time (ms; calls):")
    for e in sorted(kernels, key=self_device_us, reverse=True)[:n_kernels]:
        print(f"  {self_device_us(e) / 1e3:9.2f}  {e.count:4d}  {e.key[:90]}")


def profile_serve(torch, arch: str) -> int:
    """One traced prefill and one traced decode tick of the serving path."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    slots, max_seq, prompt_len, layers = SERVE[arch]
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    eng = ServeEngine(model, params, n_slots=slots, max_seq=max_seq)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=prompt_len)
               for _ in range(slots + 1)]
    for rid, prompt in enumerate(prompts[:slots]):
        eng.submit(Request(rid, prompt, 64))
    eng.step()                        # warm-up: four prefills, one tick
    eng.step()                        # the tick captured: later ones replay
    tok = torch.as_tensor(prompts[-1], dtype=torch.int64,
                          device="cuda")[None]
    parts = (("prefill", lambda: eng.executor.prefill(
                  tok, 0, [], np.zeros(0, bool))),
             ("decode tick", eng.step))
    for what, fn in parts:
        with traced() as out:
            fn()                      # both end in a host read
        tr = out.trace
        busy_ms = report_busy(
            f"{cfg.name} x{cfg.n_layers} layers d{cfg.d_model}, {slots} "
            f"slots, max_seq {max_seq}, {prompt_len}-token prompts, one "
            f"{what}", out)
        shares = []
        tags = ((("K7", "flash_fwd_"),)
                if any(sp.mixer == "gqa" for sp in model.plan) else ())
        if cfg.ssm is not None:
            tags += (("K8", "ssd_intra"), ("the SSD pass", "ssd_pass"))
        for tag, name in tags:
            kern_ms = tr.kernel_seconds([name]) * 1e3
            shares.append(f"{tag} {tr.kernel_count([name])} launches, "
                          f"{kern_ms:.2f} ms ({100 * kern_ms / busy_ms:.1f} "
                          "% of busy)")
        if shares:
            print(f"[profile] {'; '.join(shares)}")
        report_spans(out)
        events = out.prof.key_averages(group_by_input_shape=True)
        report_tops([e for e in events if not is_kernel(e)],
                    [e for e in events if is_kernel(e)])
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--moe", action="store_true",
                      help="profile the expert-parallel llama4-maverick step")
    mode.add_argument("--serve", action="store_true",
                      help="profile one prefill and one decode tick of the "
                           "serving path")
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(SERVE),
                    help="the served (--serve) or trained architecture")
    args = ap.parse_args(argv)
    if not args.serve and (args.arch not in TRAIN or args.moe and
                           args.arch != "qwen3-4b"):
        ap.error(f"--arch trains one of {sorted(TRAIN)}, without --moe")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    if args.serve:
        return profile_serve(torch, args.arch)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainstep import init_train_state, make_train_step

    opt = OptimizerConfig(peak_lr=1e-3, warmup_steps=0,
                          total_steps=WARMUP + 1)
    if args.moe:
        cfg = get_config("llama4-maverick-400b-a17b")
        cfg = cfg.replace(n_layers=N_LAYERS, moe=dataclasses.replace(
            cfg.moe, num_experts=MOE_EXPERTS))
        model = build_model(cfg)
        params, opt_state = init_train_state(model, 0, device="cuda")
        step = make_train_step(model, opt, moe_ep="rma", ep_ranks=N_RANKS)
        what = (f"{cfg.name} d{cfg.d_model} x{N_LAYERS} layers, "
                f"{MOE_EXPERTS} experts over {N_RANKS} expert ranks")
    else:
        cfg = get_config(args.arch)
        if TRAIN[args.arch] is not None:
            cfg = cfg.replace(n_layers=TRAIN[args.arch])
        model = build_model(cfg)
        params, opt_state = init_train_state(model, 0, device="cuda")
        step = make_train_step(model, opt, grad_sync="rma_ring",
                               data_axis="data", data_axis_size=N_RANKS)
        what = (f"{cfg.name} d{cfg.d_model} x{cfg.n_layers} layers, "
                f"{N_RANKS} data-parallel ranks")
    data = make_source(DataConfig(vocab=cfg.vocab, seq_len=SEQ_LEN,
                                  global_batch=GLOBAL_BATCH, seed=0))

    def batch(i):
        return {k: torch.as_tensor(v, dtype=torch.int64).cuda()
                for k, v in data.batch_at(i).items()}

    for i in range(WARMUP):
        params, opt_state, _ = step(params, opt_state, batch(i))
    b = batch(WARMUP)
    with traced() as out:
        params, opt_state, metrics = step(params, opt_state, b)
    loss = float(metrics["loss"])
    if loss != loss:
        raise AssertionError("loss is not finite")

    tr = out.trace
    busy_ms = report_busy(f"{what}, batch {GLOBAL_BATCH}x{SEQ_LEN}, one "
                          f"step after {WARMUP}", out)
    events = out.prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in events if is_kernel(e)]
    ops = [e for e in events if not is_kernel(e)]
    vocab = {cfg.vocab, cfg.vocab_padded}
    vocab_ms = sum(self_device_us(e) for e in ops
                   if any(vocab & set(s) for s in e.input_shapes or []
                          if all(isinstance(d, int) for d in s))) / 1e3
    ring_ms = tr.kernel_seconds(["ring_ar_kernel"]) * 1e3       # K5
    signal_ms = tr.kernel_seconds(["signal_kernel"]) * 1e3     # K4 and K6
    rest_ms = busy_ms - vocab_ms - ring_ms - signal_ms
    print(f"[profile] device time by part: vocabulary-sized operators "
          f"{vocab_ms:.1f} ms ({100 * vocab_ms / busy_ms:.1f} % of busy), "
          f"K5 ring {ring_ms:.1f} ms ({100 * ring_ms / busy_ms:.1f} %), "
          f"K4/K6 {signal_ms:.3f} ms ({100 * signal_ms / busy_ms:.2f} %), "
          f"the rest of busy {rest_ms:.1f} ms "
          f"({100 * rest_ms / busy_ms:.1f} %)")
    launches = defaultdict(list)
    for t0, t1, name in tr.device:
        if "signal_kernel" in name:
            launches[name[:60]].append(t1 - t0)
    for name, times in launches.items():
        print(f"[profile] {name}: {len(times)} launches, "
              f"{sum(times) / len(times) * 1e3:.4f} ms each (device time)")
    report_spans(out)
    report_tops(ops, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
