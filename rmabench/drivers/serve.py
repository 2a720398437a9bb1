"""What the two serving loops share: the engine built from the seed, its
calls timed from the benchmark's own side, the warm-up, and the check of
served tokens against the plain reference.

The engine is ``repro_torch.serve.engine.ServeEngine`` (paged KV of
``page_tokens``-token pages, greedy decoding, continuous batching) over the
benchmark's weights.  Its executor's ``prefill`` and ``decode`` and its
admission are wrapped (host clock; each call ends in a host read of the
greedy tokens), so every request's first token and every later token get
a time, and every prefill and decode tick a span.

The check: once the window has closed, a sample of the finished requests
drawn from the seed, the longest always in it, is run through the plain
reference once over its prompt and its served tokens; the number compared
is the widest gap by which a served token's reference logit lies below
the reference's best at that position.
"""
from __future__ import annotations

import collections
import gc

import numpy as np

from rmabench import harness, weights
from rmabench.traffic import generate


def build(run) -> None:
    """Weights from the seed and the engine, instrumented; kept in
    ``run.program``."""
    import torch  # noqa: F401

    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine

    w = run.workload
    model = build_model(harness.model_config(run.model))
    layout = model.init(0, device="meta")
    params = weights.make_params(layout, run.seed, run.device)
    eng = ServeEngine(model, params, n_slots=w["slots"],
                      max_seq=w["max_seq"], paged_kv=True,
                      page_tokens=w["page_tokens"])
    run.records["layout"] = layout
    rec = run.records
    rec.update(prefills=[], decodes=[],
               tok_times=collections.defaultdict(list))
    _instrument(eng, rec, run)
    run.program.update(engine=eng, params=params)


def _instrument(eng, rec, run) -> None:
    import torch

    ex = eng.executor
    prefill0, decode0, admit0 = ex.prefill, ex.decode, eng._admit_one
    cur = {}

    def admit_one(entry, slot):
        cur["rid"] = entry.req.rid
        with torch.profiler.record_function("bench:admit"):
            return admit0(entry, slot)

    def prefill(tokens, slot, phys_pages, write_ok):
        t0 = harness.now()
        with torch.profiler.record_function("bench:prefill"):
            first = prefill0(tokens, slot, phys_pages, write_ok)
        t1 = harness.now()
        rid = cur["rid"]
        rec["prefills"].append((rid, t0, t1, int(tokens.shape[1])))
        rec["tok_times"][rid].append(t1)
        return first

    def decode(last_tokens):
        t0 = harness.now()
        with torch.profiler.record_function("bench:decode"):
            nxt = decode0(last_tokens)
        t1 = harness.now()
        live = [eng.slot_req[s].rid for s in eng.slot_req]
        rec["decodes"].append((t0, t1, len(live)))
        for rid in live:
            rec["tok_times"][rid].append(t1)
        return nxt

    eng._admit_one = admit_one
    ex.prefill, ex.decode = prefill, decode


def warm_up(run) -> None:
    """One request at the shortest and one at the longest prompt of the
    cell's traffic, each with a few tokens, through the engine: every
    kernel the cell uses is loaded (built on a checkout's first run) and
    the allocator has seen the largest prefill."""
    from repro_torch.serve.engine import Request

    eng = run.program["engine"]
    t = run.workload["traffic_params"]
    g = generate.rng(run.seed, 99)
    for i, length in enumerate((t["prompt"][0], t["prompt"][1])):
        eng.submit(Request(-1 - i, g.integers(0, run.model["vocab"],
                                              size=length), 4))
    eng.run(strict=True)
    _forget(run.records, [-1, -2])
    eng.done.clear()


def _forget(rec, rids) -> None:
    rids = set(rids)
    rec["prefills"] = [p for p in rec["prefills"] if p[0] not in rids]
    rec["decodes"].clear()
    for r in rids:
        rec["tok_times"].pop(r, None)


def synchronize(run) -> None:
    if run.device == "cuda":
        import torch

        torch.cuda.synchronize()


def finished(run) -> dict:
    """rid → (prompt, served tokens) of every request that finished."""
    eng = run.program["engine"]
    prompts = run.records["prompts"]
    return {c.rid: (prompts[c.rid], list(c.tokens)) for c in eng.done
            if c.finished and c.rid in prompts}


def release(run) -> None:
    """Keep what the check needs; free the engine and the weights."""
    run.records["served"] = served = finished(run)
    tt = run.records["tok_times"]
    lost = [rid for rid, (_, out) in served.items()
            if len(tt.get(rid, ())) != len(out)]
    if lost:
        raise RuntimeError(f"served tokens without a time: requests {lost}")
    run.program.clear()
    gc.collect()


def sample(run, served: dict) -> list:
    """The requests the check runs: the longest finished one and
    ``check.requests - 1`` others drawn from the seed."""
    n = run.workload["check"]["requests"]
    rids = sorted(served)
    if not rids:
        return []
    longest = max(rids, key=lambda r: (len(served[r][0]) + len(served[r][1]),
                                       -r))
    rest = [r for r in rids if r != longest]
    g = generate.rng(run.seed, 77)
    pick = list(g.choice(rest, size=min(n - 1, len(rest)), replace=False)) \
        if rest else []
    return [longest] + sorted(int(r) for r in pick)


def gaps(run, precision: str = "float32", *, control: bool = False) -> dict:
    """The gaps of the sampled requests' served tokens: at each served
    position, how far the reference's logit of the served token lies below
    the reference's best.  With ``control``: the gap of the token the
    control's precision puts first there (the control need not decode).
    Returns the widest gap, the mean gap over every compared token and the
    share of tokens whose gap is not 0 (a token the reference would not
    have put first)."""
    import torch

    from rmabench.reference.numerics import PRECISIONS, exact_float32

    reference = harness.load_module("reference", run.config["reference"])
    served = run.records["served"]
    picks = sample(run, served)
    params = weights.make_params(run.records["layout"], run.seed, run.device)
    every = []
    with exact_float32(), torch.no_grad():
        for rid in picks:
            prompt, out = served[rid]
            seq = torch.as_tensor(np.concatenate([prompt, out[:-1]]),
                                  dtype=torch.long, device=run.device)
            rows = slice(len(prompt) - 1, len(prompt) - 1 + len(out))
            ref = reference.logits(params, seq, run.model, rows=rows)
            if control:
                low = reference.logits(params, seq, run.model, rows=rows,
                                    q=PRECISIONS[precision])
                chosen = low.argmax(-1)
                del low
            else:
                chosen = torch.as_tensor(out, device=run.device)
            best = ref.max(-1).values
            got = ref.gather(-1, chosen[:, None])[:, 0]
            every.append((best - got).double().cpu())
            del ref
    del params
    if run.device == "cuda":
        torch.cuda.empty_cache()
    g = torch.cat(every) if every else torch.zeros(1, dtype=torch.double)
    return {"gap": float(g.max()), "mean_gap": float(g.mean()),
            "mismatch": float((g > 0).double().mean()),
            "tokens": int(g.numel()), "requests": len(picks)}


def check(run) -> list:
    nums = gaps(run)
    run.records["compared"] = nums
    harness.log(f"check: {nums['requests']} requests, {nums['tokens']} "
                f"served tokens compared; widest gap {nums['gap']:.4f}, "
                f"share not the reference's first {nums['mismatch']:.4f}")
    return [(k, nums[k], lim)
            for k, lim in run.workload["check"]["limits"].items()]


def control(run, driver) -> dict:
    """The control's widest gap on the served requests of a short window
    of the program (``driver``'s loop, their prompts and tokens), beside
    the program's own."""
    driver.setup(run)
    driver.window(run, run.workload["check"]["window_s"])
    release(run)
    if run.device == "cuda":
        import torch

        torch.cuda.empty_cache()
    low = gaps(run, run.workload["check"]["control"], control=True)
    prog = gaps(run)
    return {**low, **{f"program_{k}": v for k, v in prog.items()
                      if k not in ("tokens", "requests")}}
