#!/usr/bin/env python3
"""The served greedy tokens, peak memory and call times of the benchmark's
``jamba-v0.1-52b-x8`` for one source tree, so two trees can be compared on
one card in turns.

    python3 benchmarks_torch/serve_turns.py [--src DIR] [--tag NAME] \\
        [--seed N] [--out FILE]

The configuration of ``rmabench/configs/jamba-v0.1-52b-x8.json`` with the
benchmark's weights from ``--seed`` (``rmabench/weights.py``), served by
the paged engine as the benchmark builds it (32 slots, ``max_seq`` 1024,
16-token pages): 32 requests, prompts of 64-512 tokens drawn from the
seed, 48 new tokens each, all submitted at once.  The host clock times
every prefill and decode tick (each ends in a host read).  Only public
entry points are used, so an older tree runs it too.  ``--src`` is the
``src`` directory of the tree to serve (default: this repository's); its
kernels build into that tree's ``build/kernels``.  Writes every request's
tokens to ``--out`` and prints one JSON object: ``{"tag", "card",
"tokens_sha256", "peak_bytes", ...}``.  Needs one CUDA card.
"""
import argparse
import hashlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUESTS, PROMPT, NEW = 32, (64, 512), 48
SLOTS, MAX_SEQ, PAGE = 32, 1024, 16


def run(torch, seed: int) -> tuple[dict, dict]:
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    from rmabench import harness, weights

    model = build_model(harness.model_config(harness.load_json(
        "configs", "jamba-v0.1-52b-x8.json")["model"]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = weights.make_params(model.init(0, device="meta"), seed, "cuda")
    eng = ServeEngine(model, params, n_slots=SLOTS, max_seq=MAX_SEQ,
                      paged_kv=True, page_tokens=PAGE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ex = eng.executor
    times = {"prefill": [], "decode": []}
    for name in times:
        def timed(*args, _fn=getattr(ex, name), _out=times[name]):
            t = time.perf_counter()
            out = _fn(*args)
            _out.append((time.perf_counter() - t) * 1e3)
            return out
        setattr(ex, name, timed)
    rng = np.random.default_rng(seed)
    for rid in range(REQUESTS):
        prompt = rng.integers(0, model.cfg.vocab,
                              size=int(rng.integers(*PROMPT, endpoint=True)))
        eng.submit(Request(rid, prompt, NEW))
    done = eng.run(strict=True)
    torch.cuda.synchronize()
    tokens = {c.rid: [int(t) for t in c.tokens] for c in done}
    blob = json.dumps(tokens, sort_keys=True).encode()
    st = eng.stats()
    # the first calls build and load the kernels
    out = {"tokens_sha256": hashlib.sha256(blob).hexdigest(),
           "requests": len(tokens), "build_s": build_s,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "prefill_ms_median": statistics.median(times["prefill"][1:]),
           "decode_tick_ms_median": statistics.median(times["decode"][1:]),
           "decode_ticks": len(times["decode"]),
           **{k: st.get(k) for k in ("weights_converted",
                                     "weights_converted_bytes",
                                     "weights_kept")}}
    return out, tokens


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--seed", type=int, default=1234567891)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(
        os.path.dirname(src), "build", "kernels")
    sys.path[:0] = [src, ROOT]
    import torch

    if not torch.cuda.is_available():
        print("serve_turns: no CUDA card", file=sys.stderr)
        return 2
    out, tokens = run(torch, args.seed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(tokens, f, sort_keys=True)
    print(json.dumps({"tag": args.tag, "seed": args.seed,
                      "card": torch.cuda.get_device_name(0), **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
