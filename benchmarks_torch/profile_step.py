#!/usr/bin/env python3
"""Where the time of one train step, or of one prefill and one decode tick
of the serving path, of the port goes on a card.

    python3 benchmarks_torch/profile_step.py [--moe | --serve [--arch A]]

Builds a configuration ``chip_smoke.py`` trains — by default ``qwen3-4b``
at full width with depth cut to 2 layers, 4 stacked data-parallel ranks,
``grad_sync="rma_ring"``; with ``--moe``, ``llama4-maverick-400b-a17b`` at
full width with 2 layers and 8 experts over 4 stacked expert-parallel ranks,
``moe_ep="rma"`` — global batch 8 × 512, runs two warm-up steps, then
traces one step with ``torch.profiler`` (CPU and CUDA activities, input
shapes recorded) and prints:

* the step's wall time, the card's busy time (the sum of its kernels'
  times) and the idle share 1 − busy / wall;
* the busy time by part: operators with a vocabulary-sized input (the LM
  head's products and their gradients, the cross-entropy), the K5 gradient
  ring, the K4/K6 doorbell launches of the all-to-all exchanges, and the
  rest;
* the operators with the most device time, with their input shapes, and the
  kernels with the most time.

With ``--serve``: one of ``chip_smoke.py``'s serving configurations at all
its layers and published widths behind a dense engine of 4 slots —
``qwen3-4b`` (the default: ``max_seq`` 2048, 1016-token prompts) or
``--arch mamba2-370m`` (``max_seq`` 4096, 2040-token prompts) — admits four
requests as warm-up, then traces one prefill (a fifth prompt into slot 0)
and one decode tick over the four slots, and prints for each the wall time,
the card's busy time and idle share, the kernels' launches and shares of
the busy time (K7; or K8 and the SSD pass, the two kernels of the SSD scan,
and whatever else runs inside ``kernels.ops.ssd_scan``, found through a
profiler range around it), and the operators and kernels with the most
device time.

Needs one CUDA card; exits non-zero without one.
"""
import argparse
import dataclasses
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_LAYERS, N_RANKS, GLOBAL_BATCH, SEQ_LEN, WARMUP = 2, 4, 8, 512, 2
MOE_EXPERTS = 8
#: the profiler range ``--serve`` puts around the SSD scan
SCAN_RANGE = "ssd_scan"
#: serving configurations: arch → (slots, max_seq, prompt tokens)
SERVE = {"qwen3-4b": (4, 2048, 1016), "mamba2-370m": (4, 4096, 2040)}


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


def annotate(module, name: str) -> None:
    """Run ``module.<name>`` inside a profiler range of the same name."""
    from torch.profiler import record_function

    fn = getattr(module, name)

    def ranged(*args, **kw):
        with record_function(name):
            return fn(*args, **kw)
    setattr(module, name, ranged)


def device_us(evt) -> float:
    """Device time of a profiler event, its children included."""
    t = getattr(evt, "device_time_total", None)
    if t is None:
        t = getattr(evt, "cuda_time_total", 0.0)
    return float(t)


def operators_inside(prof, name: str) -> dict[str, list]:
    """The operators and runtime calls the profiler recorded directly
    inside the ranges ``name``: name → [calls, device ms, their own
    children's names]."""
    found: dict[str, list] = {}
    for e in prof.events():
        if e.name != name or is_kernel(e):
            continue
        for child in e.cpu_children:
            entry = found.setdefault(child.name, [0, 0.0, set()])
            entry[0] += 1
            entry[1] += device_us(child) / 1e3
            entry[2].update(c.name for c in child.cpu_children)
    return found


def profile_serve(torch, arch: str) -> int:
    """One traced prefill and one traced decode tick of the serving path."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    slots, max_seq, prompt_len = SERVE[arch]
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    ssm = cfg.ssm is not None
    if ssm:     # a range around the SSD scan
        annotate(sys.modules["repro_torch.kernels.ops"], SCAN_RANGE)
    eng = ServeEngine(model, params, n_slots=slots, max_seq=max_seq)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=prompt_len)
               for _ in range(slots + 1)]
    for rid, prompt in enumerate(prompts[:slots]):
        eng.submit(Request(rid, prompt, 64))
    eng.step()                        # warm-up: four prefills, one tick
    eng.step()
    tok = torch.as_tensor(prompts[-1], dtype=torch.int64,
                          device="cuda")[None]
    parts = (("prefill", lambda: eng.executor.prefill(
                  tok, 0, [], np.zeros(0, bool))),
             ("decode tick", eng.step))
    for what, fn in parts:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            fn()                      # both end in a host read
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages(group_by_input_shape=True)
        # the ranges show on the device timeline too, as spans: no kernels
        kernels = [e for e in events if is_kernel(e) and e.key != SCAN_RANGE]
        ops = [e for e in events if not is_kernel(e)]
        busy_ms = sum(self_device_us(e) for e in kernels) / 1e3
        if busy_ms <= 0:
            raise AssertionError("the profiler recorded no device time")
        shares = []
        for tag, name in ((("K8", "ssd_intra"), ("the SSD pass", "ssd_pass"))
                          if ssm else (("K7", "flash_fwd_"),)):
            kern = [e for e in kernels if name in e.key]
            kern_ms = sum(self_device_us(e) for e in kern) / 1e3
            shares.append(f"{tag} {sum(e.count for e in kern)} launches, "
                          f"{kern_ms:.2f} ms ({100 * kern_ms / busy_ms:.1f} "
                          "% of busy)")
        print(f"[profile] {cfg.name} x{cfg.n_layers} layers d{cfg.d_model}, "
              f"{slots} slots, max_seq {max_seq}, {prompt_len}-token "
              f"prompts, one {what}: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms, idle {100 * (1 - busy_ms / wall_ms):.1f} "
              f"%; {'; '.join(shares)}")
        if ssm:
            # the runtime's launch calls are the two kernels' own launches
            inside = operators_inside(prof, SCAN_RANGE)
            calls = sum(v[0] for k, v in inside.items() if k.startswith("cuda"))
            others = {k: v for k, v in inside.items()
                      if not k.startswith("cuda")}
            left_ms = sum(v[1] for v in others.values())
            print(f"[profile] inside kernels.ops.ssd_scan: {calls} launch "
                  f"calls of the runtime (the two kernels'); beside them "
                  f"{sum(v[0] for v in others.values())} operators with "
                  f"{left_ms:.3f} ms of device time "
                  f"({100 * left_ms / busy_ms:.2f} % of busy)")
            for op, (n, ms, sub) in sorted(others.items(),
                                           key=lambda kv: -kv[1][1]):
                print(f"  {ms:9.3f}  {n:4d}  {op} {sorted(sub)[:4]}")
        report_tops(ops, kernels)
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
                    help="with --serve: the served architecture")
    args = ap.parse_args(argv)
    if args.arch != "qwen3-4b" and not args.serve:
        ap.error("--arch goes with --serve")
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import torch

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    if args.serve:
        return profile_serve(torch, args.arch)
    from torch.profiler import ProfilerActivity, profile

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
        cfg = get_config("qwen3-4b").replace(n_layers=N_LAYERS)
        model = build_model(cfg)
        params, opt_state = init_train_state(model, 0, device="cuda")
        step = make_train_step(model, opt, grad_sync="rma_ring",
                               data_axis="data", data_axis_size=N_RANKS)
        what = (f"{cfg.name} d{cfg.d_model} x{N_LAYERS} layers, {N_RANKS} "
                "data-parallel ranks")
    data = make_source(DataConfig(vocab=cfg.vocab, seq_len=SEQ_LEN,
                                  global_batch=GLOBAL_BATCH, seed=0))

    def batch(i):
        return {k: torch.as_tensor(v, dtype=torch.int64).cuda()
                for k, v in data.batch_at(i).items()}

    for i in range(WARMUP):
        params, opt_state, _ = step(params, opt_state, batch(i))
    b = batch(WARMUP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    loss = float(metrics["loss"])
    if loss != loss:
        raise AssertionError("loss is not finite")

    events = prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in events if is_kernel(e)]
    ops = [e for e in events if not is_kernel(e)]
    busy_ms = sum(self_device_us(e) for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    vocab = {cfg.vocab, cfg.vocab_padded}
    vocab_ms = sum(self_device_us(e) for e in ops
                   if any(vocab & set(s) for s in e.input_shapes or []
                          if all(isinstance(d, int) for d in s))) / 1e3
    ring_ms = sum(self_device_us(e) for e in kernels      # K5's kernel
                  if e.key.startswith("ring_ar_kernel")) / 1e3
    signal = [e for e in kernels if e.key.startswith("void signal_kernel")
              or e.key.startswith("signal_kernel")]       # K4 and K6
    signal_ms = sum(self_device_us(e) for e in signal) / 1e3
    rest_ms = busy_ms - vocab_ms - ring_ms - signal_ms
    print(f"[profile] {what}, batch {GLOBAL_BATCH}x{SEQ_LEN}, one step after "
          f"{WARMUP}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f} %")
    print(f"[profile] busy by part: vocabulary-sized operators "
          f"{vocab_ms:.1f} ms ({100 * vocab_ms / busy_ms:.1f} %), K5 ring "
          f"{ring_ms:.1f} ms ({100 * ring_ms / busy_ms:.1f} %), K4/K6 "
          f"{signal_ms:.3f} ms ({100 * signal_ms / busy_ms:.2f} %), rest "
          f"{rest_ms:.1f} ms ({100 * rest_ms / busy_ms:.1f} %)")
    for e in signal:
        print(f"[profile] {e.key[:60]}: {e.count} launches, "
              f"{self_device_us(e) / max(1, e.count) / 1e3:.4f} ms each "
              "(device time)")
    report_tops(ops, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
