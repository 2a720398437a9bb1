"""Serving launcher: continuous batching over a ported architecture.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --tiny \\
      --requests 8 --max-new 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --full --prompt-len 2040 --max-seq 4096

Runs on the card unless ``--device cpu``; ``--full`` takes the published
widths and depth (``--tiny``, the default, the reduced config).  A Mamba2
stack (``mamba2-370m``) serves dense only: its caches are the conv tail and
the SSM state, with no KV to page.  A hybrid stack (``jamba-v0.1-52b``)
serves dense or paged: only its attention layers' KV is paged, the Mamba2
layers' conv tail and state stay dense::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --device cpu --disagg --prefix-share --shared-prefix-len 16 \\
      --prompt-len 20

An MLA stack (``deepseek-v2-236b``) serves dense only (its compressed
latent cache is not paged); a VLM (``internvl2-1b``) serves as a text LM,
prompt tokens only, dense or paged; an enc-dec stack (``whisper-base``) is
refused with the engine's message: the engine has no encoder frames to
give its prefill.

``--disagg`` first drives the prefill→push→doorbell→admission→decode round
trip (``serve/disagg.py::demo_round_trip``, 8 stacked ranks) in this
process on ``--device``, then runs the decode engine on the paged KV pool
(page-table indirection, page alloc/free at slot admit/release);
``--prefix-share`` adds copy-on-write prefix sharing on it, and
``--disagg --dry-run`` runs only the round trip.  ``--inject SPEC`` drives
the engine through the elastic runtime (``ft/elastic.py::ElasticServing``)
with a scripted fault spec::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --device cpu --disagg --dry-run
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --device cpu --inject dead:1@4 --workers 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, tiny_config
from repro_torch.ft.elastic import ElasticServing
from repro_torch.ft.inject import FaultScript
from repro_torch.models import build_model
from repro_torch.serve.disagg import demo_round_trip
from repro_torch.serve.engine import ENCDEC_REFUSAL, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated mode: the prefill→decode handle-path "
                         "round trip, then the paged-KV decode engine")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="tokens per KV page in --disagg mode")
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "static", "priority", "fair"],
                    help="admission policy: continuous batching (default), "
                         "static whole-batch, priority, or fair-share")
    ap.add_argument("--prefix-share", action="store_true",
                    help="COW KV prefix sharing on the paged pool "
                         "(requires --disagg); requests with a common "
                         "prompt prefix map the same physical pages")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="cap the allocatable physical KV pages below "
                         "slots*max_seq/page_tokens (admission backs off "
                         "under pool pressure)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="give every request the same random prefix of this "
                         "many tokens")
    ap.add_argument("--inject", default=None, metavar="SPEC",
                    help="elastic mode: drive the engine through "
                         "repro_torch.ft.elastic with a scripted fault spec, "
                         "e.g. 'slow:1@4x6,dead:1@8' (kind:worker@tick[xmag];"
                         " kinds slow/dead/bell/rejoin) or 'random:SEED'")
    ap.add_argument("--workers", type=int, default=2,
                    help="with --inject: decode slots are owned "
                         "n_slots//workers per worker; evicting a worker "
                         "drains and requeues its slots")
    ap.add_argument("--dry-run", action="store_true",
                    help="with --disagg: run only the round-trip demo")
    args = ap.parse_args(argv)

    if args.dry_run and not args.disagg:
        ap.error("--dry-run requires --disagg")
    if args.prefix_share and not args.disagg:
        ap.error("--prefix-share requires --disagg (the paged pool)")
    if args.disagg:
        checks = demo_round_trip(device=args.device)
        if args.dry_run:
            return checks

    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    if cfg.enc_layers:
        ap.error(ENCDEC_REFUSAL.format(name=cfg.name))
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    eng = ServeEngine(model, params, n_slots=args.slots, max_seq=args.max_seq,
                      paged_kv=args.disagg, page_tokens=args.page_tokens,
                      policy=args.policy, prefix_share=args.prefix_share,
                      kv_pages=args.kv_pages)
    rng = np.random.RandomState(args.seed)
    shared = rng.randint(0, cfg.vocab, size=args.shared_prefix_len)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        tail = max(args.prompt_len - args.shared_prefix_len, 1)
        prompt = np.concatenate([shared, rng.randint(0, cfg.vocab, size=tail)])
        eng.submit(Request(rid=rid, prompt=prompt,
                           max_new_tokens=args.max_new))
    es = None
    if args.inject is not None:
        if args.inject.startswith("random:"):
            script = FaultScript.random(int(args.inject.split(":", 1)[1]),
                                        n_workers=args.workers)
        else:
            script = FaultScript.parse(args.inject)
        es = ElasticServing(eng, script, n_workers=args.workers)
        done = es.run()
    else:
        done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(c.tokens) for c in done)
    mode = "disagg/paged" if args.disagg else "dense"
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {args.slots} slots, {mode} KV, "
          f"{args.policy} admission, device {args.device})")
    if es is not None:
        st = es.stats()
        print(f"[serve] elastic: workers={st['elastic']['workers']} "
              f"evictions={st['evictions']} "
              f"faults={st['faults_injected']} "
              f"offline_slots={st['offline_slots']}")
    if args.disagg:
        print(f"[serve] pool stats: {eng.stats()}")
    for c in sorted(done, key=lambda c: c.rid)[:3]:
        print(f"[serve]   rid={c.rid}: {c.tokens[:8]}...")
    return done


if __name__ == "__main__":
    main()
