"""Serving example on the PyTorch port: continuous batching + the paged KV
window (P5 in action).

  PYTHONPATH=src python examples_torch/serve_decode.py [--device cpu]

Part 1 drives the ServeEngine with a stream of batched requests on a small
qwen3-family model.  Part 2 contrasts the scheduler layer's admission
policies (continuous vs static batching) and shows COW KV prefix sharing
admitting more concurrent sequences on a page-capped pool.  Part 3 (8
stacked ranks) shows the paged KV window: pages allocated/freed with memory
handles, a page shipped to a peer decode engine through its handle (the
disaggregated-prefill pattern), and a stale-handle write dropped after free.
Everything runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.tiny import tiny_config
from repro_torch.core.rma import win_from_memhandle
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged import PagedKVWindow, PageSpec


def engine_config():
    return get_config("qwen3-4b").replace(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=1024, vocab=4096, max_seq=256,
        dtype="float32", param_dtype="float32")


def engine_requests(vocab):
    rng = np.random.RandomState(0)
    return [Request(rid=rid, prompt=rng.randint(0, vocab, size=8 + rid % 7),
                    max_new_tokens=6 + rid % 5)
            for rid in range(10)]


def engine_demo(dev, params=None):
    """Ten requests over 4 slots; ``params`` default: ``model.init(0)``.
    Returns the generated tokens by request id."""
    cfg = engine_config()
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    eng = ServeEngine(model, params, n_slots=4, max_seq=128)
    for r in engine_requests(cfg.vocab):
        eng.submit(r)
    done = eng.run()
    for c in sorted(done, key=lambda c: c.rid)[:4]:
        print(f"[serve] request {c.rid}: generated {len(c.tokens)} tokens "
              f"{c.tokens[:6]}...")
    assert len(done) == 10
    print(f"[serve] completed {len(done)} requests over 4 slots "
          f"(continuous batching)")
    return {c.rid: c.tokens for c in done}


def scheduler_and_cow_demo(dev):
    """Returns the greedy tokens by request id without and with prefix
    sharing."""
    cfg = tiny_config("qwen3-4b")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    rng = np.random.RandomState(1)

    # continuous vs static admission on the same arrival burst: continuous
    # backfills freed slots every tick, static drains the whole batch first
    prompts = [rng.randint(0, cfg.vocab, size=6) for _ in range(6)]
    for policy in ("continuous", "static"):
        eng = ServeEngine(model, params, n_slots=2, max_seq=32, policy=policy)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p,
                               max_new_tokens=2 + rid % 4))
        eng.run()
        st = eng.stats()
        print(f"[sched] {policy:10s}: {st['completed']} done in "
              f"{st['ticks']} ticks")

    # COW prefix sharing: 4 requests with a common 16-token prefix on a
    # pool capped at 8 pages (2 sequences' worth) — sharing maps the prefix
    # pages once and admits more sequences concurrently, bit-identically
    prefix = rng.randint(0, cfg.vocab, size=16)
    reqs = [Request(rid=rid,
                    prompt=np.concatenate(
                        [prefix, rng.randint(0, cfg.vocab, size=4)]),
                    max_new_tokens=4)
            for rid in range(4)]
    outs = {}
    for share in (False, True):
        eng = ServeEngine(model, params, n_slots=4, max_seq=32,
                          paged_kv=True, page_tokens=8, prefix_share=share,
                          kv_pages=8)
        for r in reqs:
            eng.submit(Request(r.rid, r.prompt, r.max_new_tokens))
        outs[share] = {c.rid: c.tokens for c in eng.run()}
        st = eng.stats()
        print(f"[cow] prefix_share={share!s:5s}: max_live={st['max_live']} "
              f"pages_shared={st['pages_shared']} "
              f"cow_copies={st['cow_copies']}")
    assert outs[True] == outs[False], "sharing must not change greedy output"
    print("[cow] shared and unshared greedy decodes are bit-identical")
    return outs


def paged_demo(dev):
    """The paged KV window on 8 stacked ranks.  Returns what each rank
    received through the handle and the stale writes each rank dropped."""
    n = 8
    spec = PageSpec(page_tokens=16, kv_heads=2, head_dim=32, n_pages=4)
    perm = [(i, (i + 1) % n) for i in range(n)]
    pool = PagedKVWindow.create(spec, "x", n, dtype=torch.float32,
                                device=dev)
    pool = pool.alloc_page(0)                       # attach + memhandle
    kv = torch.ones((n, 2, 16, 2, 32), dtype=torch.float32, device=dev) * 7.0
    pool = pool.write_page_local(0, kv)             # prefill fills the page
    # disaggregated path: ship the page to the next decode engine through
    # the page handle — one RDMA phase, zero target involvement
    pool = pool.put_page_remote(0, kv * 2.0, perm)
    received = pool.read_page(0)[:, 0, 0, 0, 0].clone()  # what the peer put
    handle = pool.handles[:, 0].clone()             # a handle a peer kept
    pool = pool.free_page(0)                        # epoch bump: handles die
    # stale write after free: dropped + counted, never corrupts
    before = pool.window.buffer.clone()
    stale = win_from_memhandle(pool.window, handle)
    stale.put(torch.full((n, spec.page_elems), -1.0, device=dev), perm)
    stale.flush(0)
    dropped = stale.err_count.cpu()
    assert torch.equal(pool.window.buffer, before), "a stale write landed"
    received = received.cpu()
    assert (received == 14.0).all(), received  # peer's page arrived via handle
    assert (dropped == 1).all(), dropped
    print("[paged] page shipped through memhandle; value at peer:",
          received[0].item())
    print("[paged] stale-handle write after free: dropped and counted "
          f"{dropped.tolist()} (per rank), pool unchanged")
    print("PAGED OK")
    return received, dropped


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tokens = engine_demo(dev)
    cow = scheduler_and_cow_demo(dev)
    received, dropped = paged_demo(dev)
    print("SERVE_DECODE OK")
    return {"tokens": tokens, "cow": cow, "received": received,
            "dropped": dropped}


if __name__ == "__main__":
    main()
