"""The closed serving loop: ``clients`` clients, each with one request
outstanding; a client sends its next request (``traffic.generate.
closed_loop``) the moment its last one finishes.

Set-up builds and warms the engine, then admits every client's first
request (the slots are full when the window opens).  The window runs
engine ticks until ``--seconds`` have passed; its work is every token
produced inside it.
"""
from __future__ import annotations

import sys

from rmabench import harness
from rmabench.drivers import serve
from rmabench.traffic import generate

release, check = serve.release, serve.check


def control(run) -> dict:
    return serve.control(run, sys.modules[__name__])


def setup(run) -> None:
    from repro_torch.serve.engine import Request

    serve.build(run)
    serve.warm_up(run)
    queues = generate.closed_loop(run.workload["traffic_params"], run.seed,
                                  run.model["vocab"])
    run.records["prompts"] = {r.rid: r.prompt for q in queues for r in q}
    eng = run.program["engine"]
    for q in queues:
        r = q.pop(0)
        eng.submit(Request(r.rid, r.prompt, r.max_new))
    eng._admit()
    run.program["queues"] = queues
    serve.synchronize(run)


def window(run, seconds: float) -> None:
    import torch

    from repro_torch.serve.engine import Request

    eng = run.program["engine"]
    queues = run.program["queues"]       # request i is client i % clients
    seen = len(eng.done)
    t_open = harness.now()
    while True:
        with torch.profiler.record_function("bench:tick"):
            eng.step()
        for c in eng.done[seen:]:
            q = queues[c.rid % len(queues)]
            if q:
                r = q.pop(0)
                eng.submit(Request(r.rid, r.prompt, r.max_new))
        seen = len(eng.done)
        t = harness.now() - t_open
        if t >= seconds:
            break
    t_close = harness.now()
    done = [c for c in eng.done if c.finished]
    run.records.update(t_open=t_open, t_close=t_close, attempted=len(done),
                       failed=0)
    if not all(queues):
        harness.log("a client ran out of requests: raise per_client")
