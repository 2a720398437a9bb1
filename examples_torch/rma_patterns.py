"""The paper's usage patterns, side by side (Listings 1/2, dup, scopes), on
the PyTorch port.

  PYTHONPATH=src python examples_torch/rma_patterns.py [--device cpu]

The 8 ranks are the rows of stacked ``(8, ...)`` tensors on one device (the
card unless ``--device cpu``).  Prints the communication-phase count of each
pattern from the port's phase ledger — the structural costs behind the
paper's latency plots, billed by the cost model of
``docs/rma_architecture.md``.  The JAX package's ``examples/rma_patterns.py``
counts the same patterns as collective-permutes in lowered HLO.
"""
import argparse
import os

import torch

from repro_torch.core.rma import (
    RmaPlan,
    Topology,
    Window,
    WindowConfig,
    accumulate_signal,
    crossover_elems,
    put_signal,
    rma_all_to_all,
    route_accumulate,
    win_op_intrinsic,
)
from repro_torch.core.rma import accumulate as acc_engine
from repro_torch.core.rma.collectives import (all_reduce_plan,
                                              plan_all_reduce)
from repro_torch.core.rma.substrate import recorded_ledgers
from repro_torch.device import resolve_device

N = 8
perm = [(i, (i + 1) % N) for i in range(N)]
F32 = torch.float32


def ledger(fn, dev):
    """Run ``fn`` on a zero ``(N, 16)`` window buffer; returns the phases
    every window it allocated billed: ``(total, inter, intra)``."""
    with recorded_ledgers() as books:
        fn(torch.zeros((N, 16), dtype=F32, device=dev))
    return (sum(b.total for b in books), sum(b.inter for b in books),
            sum(b.intra for b in books))


def phases(fn, dev) -> int:
    return ledger(fn, dev)[0]


def ones(dev, *shape):
    return torch.ones((N,) + shape, dtype=F32, device=dev)


def listing1(buf):
    """put; FLUSH; signal — ordering via completion (paper Listing 1)."""
    win = Window.allocate(buf, "x", N, WindowConfig(order=False))
    win = put_signal(win, ones(buf.device, 8), perm, data_offset=0,
                     flag_offset=8)
    return win.flush().buffer


def listing2(buf):
    """mpi_win_order=true: put; signal — chained, no flush (Listing 2)."""
    win = Window.allocate(buf, "x", N, WindowConfig(order=True))
    win = put_signal(win, ones(buf.device, 8), perm, data_offset=0,
                     flag_offset=8)
    return win.flush().buffer


def dup_demo(buf):
    """P4: one window, two differently-configured handles in one region.

    The latency handle additionally declares a same-op streak (paper §2.3),
    so its flag accumulate routes through the engine's intrinsic path — no
    private APIs, the declaration alone selects the specialization."""
    win = Window.allocate(buf, "x", N, WindowConfig(max_streams=2))
    latency = win.dup_with_info(order=True, scope="thread",
                                same_op="sum")                   # signals
    bulk = win                                                   # bandwidth
    bulk = bulk.put(ones(buf.device, 8), perm, offset=0, stream=0)
    latency = latency.accumulate(ones(buf.device, 1), perm, op="sum",
                                 offset=8, stream=1)
    # synchronization on either handle covers both (shared group)
    return latency.flush(stream=1).buffer


def acc_declared(buf):
    """Same-op dup tour: a declared sum streak routes specialized (1 phase
    per accumulate)."""
    win = Window.allocate(buf, "x", N, WindowConfig(scope="thread"))
    sumw = win.dup_with_info(same_op="sum")
    sumw = sumw.accumulate(ones(buf.device, 4), perm, op="sum", offset=0)
    return sumw.flush(stream=0).buffer


def acc_generic(buf):
    """The hint-less baseline: the same accumulate takes the conservative
    software path and pays a completion-ack phase per op (paper Fig. 5)."""
    win = Window.allocate(buf, "x", N, WindowConfig(scope="thread"))
    win = win.accumulate(ones(buf.device, 4), perm, op="sum", offset=0)
    return win.flush(stream=0).buffer


def acc_fused_signal(buf):
    """Fused accumulate+signal: under P2 the flag chains behind the routed
    update with no intermediate flush (Listing 2 applied to accumulates)."""
    win = Window.allocate(buf, "x", N,
                          WindowConfig(scope="thread", order=True,
                                       same_op="sum"))
    win = accumulate_signal(win, ones(buf.device, 4), perm, op="sum",
                            data_offset=0, flag_offset=8)
    return win.flush(stream=0).buffer


def a2a_declared(buf):
    """The MoE dispatch exchange with everything declared: per-peer chunked
    puts on per-direction streams, fetch_op count headers, and one doorbell
    per peer chained under P2 — no intermediate flush epochs."""
    return rma_all_to_all(buf, "x", N, chunks=2, order=True,
                          declare=True).data


def a2a_undeclared(buf):
    """The hint-less baseline of the same exchange: one completion-ack RTT
    per peer before its doorbell, and the flag itself takes the software
    path (one more ack per peer) — the per-peer tax the declarations
    remove."""
    return rma_all_to_all(buf, "x", N, chunks=2, order=False,
                          declare=False).data


# --- the plan layer: record once, compile, replay (docs/rma_plan.md) --------
plan = RmaPlan("example-push-notify")
plan.window("w", scope="thread", order=True, same_op="sum",
            accumulate_ops=("sum",), dtype=F32, max_streams=2,
            exit_epoch=True)
plan.bind("a", (4,), F32)
plan.bind("b", (4,), F32)
_pa = plan.put("w", "a", perm, offset=0)               # independent chains →
_pb = plan.put("w", "b", perm, offset=4)               # auto streams 0 and 1
plan.signal("w", perm, flag_offset=8, after=(_pa, _pb))  # completion edges
plan_compiled = plan.compile()                          # planner passes, once
plan_naive = plan.compile(naive_flush=True)             # per-op-flush baseline


def planned_pattern(buf):
    """Replay of the compiled schedule: the signal chains behind both put
    chains under P2 (no flush epochs between), one exit epoch per stream.
    ``CompiledPlan.phases`` predicts the billed phase count exactly."""
    win = Window.allocate(buf, "x", N,
                          WindowConfig(scope="thread", order=True,
                                       same_op="sum", max_streams=2))
    res = plan_compiled.execute(
        {"w": win}, {"a": ones(buf.device, 4),
                     "b": torch.full((N, 4), 2.0, device=buf.device)})
    return res.windows["w"].buffer


# --- the two-level tour: topology as a plan input (docs/rma_plan.md) --------
# Declare the 8-rank axis as 2 hosts x 4 local devices and the SAME recorded
# ring all-reduce compiles hierarchically: intra-node reduce-scatter (shared
# memory, no acks) -> inter-node ring over one leader lane per local index ->
# intra-node all-gather.  Inter-node phases: 2(n-1)=14 flat -> 2(g-1)=2.
TOPO = Topology(2, 4)
ring_flat = all_reduce_plan("x", N, (8,), F32, order=True)
ring_hier = all_reduce_plan("x", N, (8,), F32, order=True, topology=TOPO)


def hier_ring(buf):
    """Replay of the topology-declared ring: numerics identical to flat,
    schedule split across the two tiers."""
    return plan_all_reduce(buf[:, :8], "x", N, order=True, topology=TOPO)


def hier_split(dev):
    """(inter, intra) phases of the hierarchical ring's replay, from the
    ledger's two tiers."""
    _, inter, intra = ledger(hier_ring, dev)
    return inter, intra


# --- the backend tour: one plan, three lowering targets (docs/rma_plan.md) --
# The SAME recorded ring all-reduce compiles to (a) the RMA substrate
# schedule, (b) the GSPMD collective it is recognized as (one phase-free
# sum), and (c) a substrate-free walk on stacked tensors.  Same numerics on
# all three — the plan is the portable artifact, the target a compile knob.
ring_gspmd = all_reduce_plan("x", N, (8,), F32, order=True, backend="gspmd")


def ring_on(backend):
    def body(buf):
        return plan_all_reduce(buf[:, :8], "x", N, order=True,
                               backend=backend)
    return body


def backend_tour(dev):
    shard = torch.arange(8, dtype=F32, device=dev) % 5
    stacked = shard.expand(N, 8)
    buf = torch.cat([stacked, torch.zeros((N, 8), device=dev)], dim=1)
    outs = {backend: ring_on(backend)(buf.clone())[0]
            for backend in ("rma", "gspmd")}
    outs["interpret"] = plan_all_reduce(stacked.contiguous(), "x", N,
                                        order=True, backend="interpret")[0]
    return outs


def crossover_source(cfg) -> str:
    """Where :func:`crossover_elems` took its value from (its own order)."""
    if os.environ.get("RMA_ACC_CROSSOVER"):
        return "RMA_ACC_CROSSOVER"
    if cfg.max_atomic_elems is not None:
        return "the window's max_atomic_elems"
    if acc_engine.calibrated_crossover() is not None:
        return f"the card's table {acc_engine._default_bench_json()}"
    return ("the hardware envelope (INTRINSIC_MAX_COUNT; no "
            "benchmarks_torch/results/ table)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    counts = {}

    print("pattern phase counts (phases in the port's ledger; the reference "
          "counts collective-permutes in lowered HLO):")
    p1, p2 = phases(listing1, dev), phases(listing2, dev)
    print(f"  listing1 (put;flush;signal;flush): {p1}")
    print(f"  listing2 (ordered put+signal;flush): {p2}  <- P2 saves {p1-p2}")
    pdup = phases(dup_demo, dev)
    print(f"  dup_with_info mixed-config region: {pdup}")
    # the accumulate engine: declared same-op streak vs hint-less baseline
    pd, pg = phases(acc_declared, dev), phases(acc_generic, dev)
    print(f"  accumulate via same_op dup: {pd}")
    print(f"  accumulate undeclared:      {pg}  <- the generic-path ack tax")
    pf = phases(acc_fused_signal, dev)
    print(f"  fused accumulate+signal:    {pf}")
    # the MoE dispatch exchange (docs/moe_ep.md): declared all-to-all vs the
    # undeclared per-peer-ack baseline
    ad, au = phases(a2a_declared, dev), phases(a2a_undeclared, dev)
    print(f"  all-to-all declared:        {ad}")
    print(f"  all-to-all undeclared:      {au}  <- >=3 phases/peer saved")
    assert au - ad >= 3 * (N - 1)
    # the plan layer: the compiled schedule predicts its own phase count,
    # and the naive per-op-flush compile of the SAME recorded pattern shows
    # what the coalescing pass saves (docs/rma_plan.md)
    pp = phases(planned_pattern, dev)
    print(f"  compiled plan replay:       {pp}  (predicted "
          f"{plan_compiled.phases}, naive baseline {plan_naive.phases})")
    assert pp == plan_compiled.phases
    assert plan_naive.phases > plan_compiled.phases
    # the hierarchical pass: same ring, topology declared — the inter-node
    # phase count collapses to 2(g-1) and the rest rides shared memory
    inter, intra = hier_split(dev)
    print(f"  ring flat:                  inter={ring_flat.phases_inter} "
          f"intra={ring_flat.phases_intra}")
    print(f"  ring topology=2x4:          inter={inter} intra={intra}  "
          f"<- 2(g-1) inter-node")
    assert (inter, intra) == (ring_hier.phases_inter, ring_hier.phases_intra)
    assert inter == 2 * (TOPO.hosts - 1) < ring_flat.phases_inter
    # the backend tour: same plan, three lowering targets, same numerics
    outs = backend_tour(dev)
    assert torch.equal(outs["gspmd"], outs["rma"])
    assert torch.equal(outs["interpret"], outs["rma"])
    br, bg = phases(ring_on("rma"), dev), phases(ring_on("gspmd"), dev)
    print(f"  ring backend=rma:           {br} phases "
          f"(substrate schedule; planned {ring_flat.phases})")
    print(f"  ring backend=gspmd:         {bg} phases  <- macro lowered "
          f"to one sum, {ring_gspmd.phases} phases")
    print(f"  ring backend=interpret:     substrate-free walk, "
          f"same result on all three")
    assert br == ring_flat.phases
    assert ring_gspmd.backend == "gspmd" and ring_gspmd.phases == 0
    assert bg == 0
    # P3: the capability query applications use to pick an algorithm
    print("win_op_intrinsic('sum,cas', 8, int32):",
          win_op_intrinsic("sum,cas", 8, torch.int32))
    print("win_op_intrinsic('sum', 4096, float32):",
          win_op_intrinsic("sum", 4096, F32),
          "(large counts -> tiled/bandwidth path)")
    cfg = WindowConfig(same_op="sum")
    print("crossover_elems(default):", crossover_elems(cfg),
          "| route(sum, 4):", route_accumulate("sum", 4, F32, cfg),
          "| route(sum, 4096):", route_accumulate("sum", 4096, F32, cfg),
          "| from", crossover_source(cfg))
    assert p2 < p1
    assert pd < pg, "declared accumulate must lower with fewer phases"
    counts.update(listing1=p1, listing2=p2, dup=pdup, acc_declared=pd,
                  acc_generic=pg, acc_fused_signal=pf, a2a_declared=ad,
                  a2a_undeclared=au, planned=pp,
                  planned_predicted=plan_compiled.phases,
                  planned_naive=plan_naive.phases,
                  flat_inter=ring_flat.phases_inter,
                  flat_intra=ring_flat.phases_intra, hier_inter=inter,
                  hier_intra=intra, backend_rma=br, backend_gspmd=bg)
    print("RMA_PATTERNS OK")
    return counts


if __name__ == "__main__":
    main()
