"""The open serving loop: requests due on a schedule fixed by the seed
(``traffic.generate.open_loop``), sent when due whatever the engine is
doing, each timed from its due time.

Set-up builds the engine and warms it (``serve.warm_up``).  The window
opens at the first due time and lasts ``--seconds``; every request due in
it is sent at its due time (the loop submits whatever is due before each
engine tick, and sleeps until the next due time when the engine is idle).
After the window closes the loop keeps ticking until every request it sent
has finished, ``drain_s`` at most; a request that has not finished by then
is failed.
"""
from __future__ import annotations

import sys
import time

from rmabench import harness
from rmabench.drivers import serve
from rmabench.traffic import generate

release, check = serve.release, serve.check


def control(run) -> dict:
    return serve.control(run, sys.modules[__name__])


def setup(run) -> None:
    serve.build(run)
    serve.warm_up(run)
    reqs = generate.open_loop(run.workload["traffic_params"], run.seed,
                              run.seconds, run.model["vocab"])
    run.records["requests"] = reqs
    run.records["prompts"] = {r.rid: r.prompt for r in reqs}
    serve.synchronize(run)


def window(run, seconds: float) -> None:
    import torch

    from repro_torch.serve.engine import Request

    eng = run.program["engine"]
    rec = run.records
    reqs = rec["requests"]
    drain = run.workload["drain_s"]
    due, i = {}, 0
    t_open = harness.now()
    while True:
        t = harness.now() - t_open
        while i < len(reqs) and reqs[i].due <= t:
            r = reqs[i]
            due[r.rid] = t_open + r.due
            eng.submit(Request(r.rid, r.prompt, r.max_new))
            i += 1
        busy = eng.scheduler.pending_count or eng.slot_req
        if busy:
            with torch.profiler.record_function("bench:tick"):
                eng.step()
        elif i < len(reqs):
            time.sleep(max(0.0, reqs[i].due - (harness.now() - t_open)))
        else:
            break
        t = harness.now() - t_open
        if t >= seconds + drain:
            break
    done = {c.rid for c in eng.done if c.finished}
    rec.update(due=due, t_open=t_open, t_close=t_open + seconds,
               t_end=harness.now(),
               attempted=len(reqs),
               failed=sum(1 for r in reqs if r.rid not in done))


def sweep(run, rates, seconds: float) -> list:
    """The loop at each of ``rates`` (requests/s) on one engine: for each,
    its tails and whether its queue grew (the queue wait of the last fifth
    of the requests against the first fifth's)."""
    from rmabench import stats

    out = []
    for rate in rates:
        run.workload["traffic_params"]["rate"] = rate
        reqs = generate.open_loop(run.workload["traffic_params"], run.seed,
                                  seconds, run.model["vocab"])
        rec = run.records
        rec.update(requests=reqs, prompts={r.rid: r.prompt for r in reqs},
                   prefills=[], decodes=[])
        rec["tok_times"].clear()
        run.program["engine"].done.clear()
        window(run, seconds)
        waits = sorted((rec["due"][rid], t0 - rec["due"][rid])
                       for rid, t0, _, _ in rec["prefills"]
                       if rid in rec["due"])
        k = max(1, len(waits) // 5)
        ttft = [rec["tok_times"][rid][0] - rec["due"][rid]
                for rid in rec["due"] if rec["tok_times"].get(rid)]
        row = {"rate": rate, "requests": len(reqs),
               "failed": rec["failed"],
               "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90),
               "wait_first_ms": 1e3 * sum(w for _, w in waits[:k]) / k,
               "wait_last_ms": 1e3 * sum(w for _, w in waits[-k:]) / k}
        harness.log(f"sweep {row}")
        out.append(row)
    return out
