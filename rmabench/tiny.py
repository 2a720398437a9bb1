"""The cells at a size a CPU test can hold: the same files, drivers,
references and checks, with every width and count cut down.  The CPU
tests drive whole runs through ``harness.execute`` at this size (the plain
versions stand in for the kernels)."""
from __future__ import annotations

import time

from rmabench import harness

DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=256)
HYBRID = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
              vocab=256)
HYBRID_SSM = dict(headdim=16, chunk=16)
#: 4 experts, top 2: capacity factor experts / top_k never drops
HYBRID_MOE = dict(num_experts=4, d_ff_expert=64, capacity_factor=2.0)

#: limits at this size, set as the cells' are: above the largest of 12
#: sound CPU runs (seeds 100-111: loss 2.2e-4, grad 0.0026, change 0.096;
#: mean served-token gap 0.028 chat, 0.023 batch) and below the planted
#: faults (grad 0.21-1.0; mean gap 0.47-0.54) and the control (seeds
#: 200-202: loss 1.1e-3 and up, grad 0.012 and up; mean gap 0.085 and
#: up).
LIMITS = {"train": {"loss": 5e-4, "grad": 0.006, "change": 0.3},
          "serve": {"mean_gap": 0.06}}


def run(cell: str, seed: int, seconds: float | None = None,
        **kw) -> harness.Run:
    """A CPU run of ``cell`` at the tiny size: a 1 s window, 4 s for the
    closed loop, whose check needs requests finished inside the window
    (on a CPU shared with other tests, a tick can take 100 ms)."""
    if seconds is None:
        closed = harness.load_json("workloads", f"{cell}.json")[
            "driver"] == "serve_closed"
        seconds = 4.0 if closed else 1.0
    r = harness.make_run(cell, seed, seconds, False, device="cpu",
                         t_process=time.perf_counter(), **kw)
    m, w = r.config["model"], r.workload
    if m.get("ssm"):
        m.update(HYBRID)
        m["ssm"].update(HYBRID_SSM)
        m["moe"].update(HYBRID_MOE)
        w.update(slots=4, max_seq=96, page_tokens=16, drain_s=30)
        w["check"]["limits"] = dict(LIMITS["serve"])
        w["check"]["window_s"] = seconds
        tp = w["traffic_params"]
        if "rate" in tp:
            tp.update(rate=12.0, prompt=[8, 40], output=[4, 12])
        else:
            tp.update(clients=4, per_client=6, prompt=[8, 40],
                      output=[4, 12])
    else:
        m.update(DENSE)
        w["traffic_params"].update(ranks=4, rows=2, seq_len=16)
        w["check"]["limits"] = dict(LIMITS["train"])
    return r
