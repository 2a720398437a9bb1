"""Parity of the port's RMA layer with the JAX package: accumulate routing
and crossover resolution, window semantics (the JAX window runs under
``vmap`` over the stacked rank axis, as its meshless oracle does), the phase
ledger against the reference cost model, and compiled ring plans — their
phase predictions row for row and their results bit for bit.  Inputs are
numpy arrays from a seed."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rma as J
from repro.core.rma import accumulate as j_acc
from repro.core.rma.collectives import all_reduce_plan as j_all_reduce_plan
from repro.core.rma.collectives import plan_all_reduce as j_plan_all_reduce
from repro.kernels import ref as JR

from repro_torch.core import rma as T
from repro_torch.core.rma import accumulate as t_acc
from repro_torch.core.rma.collectives import (all_reduce_plan,
                                              plan_all_reduce)


@pytest.fixture(autouse=True)
def _hermetic_crossover(monkeypatch):
    """Routing must not depend on a calibration artifact on this machine."""
    monkeypatch.setenv("RMA_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.setenv("RMA_TORCH_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.delenv("RMA_ACC_CROSSOVER", raising=False)
    monkeypatch.delenv("RMA_TOPOLOGY", raising=False)


def _cfgs(**kw):
    return J.WindowConfig(**kw), T.WindowConfig(**kw)


# ---------------------------------------------------------------------------
# routing: the tests/test_accumulate_router.py matrix, both packages
# ---------------------------------------------------------------------------

SUM = dict(same_op="sum", max_atomic_elems=8)
ROUTES = [
    ("sum", 1, "float32", SUM), ("sum", 8, "float32", SUM),
    ("sum", 9, "float32", SUM), ("sum", 4096, "float32", SUM),
    ("sum", 4, "int32", SUM), ("sum", 2, "bfloat16", SUM),
    ("sum", 2, "float16", SUM),
    ("prod", 2, "float32", dict(same_op="prod", accumulate_ops=("prod",),
                                max_atomic_elems=8)),
    ("min", 2, "int32", dict(same_op="min", accumulate_ops=("min",),
                             max_atomic_elems=8)),
    ("bxor", 2, "int32", dict(same_op="bxor", accumulate_ops=("bxor",),
                              max_atomic_elems=8)),
    ("sum", 1, "float32", {}), ("sum", 4096, "float32", {}),
    ("min", 2, "int32", dict(accumulate_ops=("sum", "min"))),
    ("sum", 4, "float32", dict(assert_accumulate_intrinsic=True)),
    ("sum", 32, "float64", dict(same_op="sum")),
    ("sum", 32, "float64", dict(same_op="sum", max_atomic_elems=64)),
]


@pytest.mark.parametrize("op,count,dtype,kw", ROUTES)
def test_route_matrix_agrees(op, count, dtype, kw):
    jc, tc = _cfgs(**kw)
    want = J.route_accumulate(op, count, jnp.dtype(dtype), jc)
    assert T.route_accumulate(op, count, dtype, tc) == want
    assert T.route_accumulate(op, count, torch.__dict__[dtype], tc) == want


def test_route_violations_agree():
    jc, tc = _cfgs(**SUM)
    for route, cfg, dt in ((J.route_accumulate, jc, jnp.float32),
                           (T.route_accumulate, tc, torch.float32)):
        with pytest.raises(ValueError, match="declaration violation"):
            route("min", 2, dt, cfg)
    jc, tc = _cfgs(assert_accumulate_intrinsic=True)
    for route, cfg, dt in ((J.route_accumulate, jc, jnp.float32),
                           (T.route_accumulate, tc, torch.float32)):
        with pytest.raises(ValueError, match="outside the hardware envelope"):
            route("sum", 1000, dt, cfg)


def test_crossover_resolution_agrees(monkeypatch, tmp_path):
    for kw in ({}, dict(max_atomic_elems=64)):
        jc, tc = _cfgs(**kw)
        assert t_acc.crossover_elems(tc) == j_acc.crossover_elems(jc)
    monkeypatch.setenv("RMA_ACC_CROSSOVER", "3")
    jc, tc = _cfgs(max_atomic_elems=64)
    assert t_acc.crossover_elems(tc) == j_acc.crossover_elems(jc) == 3
    monkeypatch.delenv("RMA_ACC_CROSSOVER")
    rows = []
    for count, (i_us, t_us) in {1: (1.0, 5.0), 8: (2.0, 5.0),
                                64: (9.0, 5.0), 256: (20.0, 5.0)}.items():
        rows.append({"name": f"acc_latency/intrinsic/{count}",
                     "us_per_call": i_us})
        rows.append({"name": f"acc_latency/tiled/{count}",
                     "us_per_call": t_us})
    art = tmp_path / "BENCH_acc_latency_h100.json"
    art.write_text(json.dumps({"rows": rows}))
    assert t_acc.calibrated_crossover(str(art)) == \
        j_acc.calibrated_crossover(str(art)) == 8
    assert t_acc.calibrated_crossover("/nonexistent") is None
    # the port reads its own artifact only, never the reference's variable
    monkeypatch.setenv("RMA_ACC_BENCH_JSON", str(art))
    assert t_acc.crossover_elems(T.WindowConfig()) == T.INTRINSIC_MAX_COUNT
    monkeypatch.setenv("RMA_TORCH_ACC_BENCH_JSON", str(art))
    assert t_acc.crossover_elems(T.WindowConfig()) == 8


def test_win_op_intrinsic_agrees():
    jw = J.Window.allocate(jnp.zeros((64,)), "x", 1,
                           J.WindowConfig(max_atomic_elems=32))
    tw = T.Window.allocate(torch.zeros(1, 64), "x", 1,
                           T.WindowConfig(max_atomic_elems=32))
    for ops, count, dt, win in (("sum", 32, "float32", True),
                                ("sum", 32, "float32", False),
                                ("sum", 33, "float32", True),
                                ("sum,replace,cas", 4, "int64", False),
                                ("sum,prod", 4, "float32", False),
                                ("sum", 4, "bfloat16", False)):
        want = J.win_op_intrinsic(ops, count, jnp.dtype(dt),
                                  jw if win else None)
        assert T.win_op_intrinsic(ops, count, dt, tw if win else None) == want


def test_config_validation_agrees():
    for kw, msg in ((dict(same_op="min"), "contradicts accumulate_ops"),
                    (dict(accumulate_ops=("landau",)), "unknown accumulate op"),
                    (dict(max_atomic_elems=0), "max_atomic_elems"),
                    (dict(scope="galaxy"), "invalid scope"),
                    (dict(max_streams=0), "max_streams")):
        for cls in (J.WindowConfig, T.WindowConfig):
            with pytest.raises(ValueError, match=msg):
                cls(**kw)


def test_dup_shares_substrate_and_keeps_streams():
    win = T.Window.allocate(torch.zeros(2, 8), "x", 2,
                            T.WindowConfig(max_streams=2))
    dup = win.dup_with_info(order=True, scope="thread", max_streams=1)
    assert dup.substrate is win.substrate and dup.buffer is win.buffer
    assert dup.group is win.group and dup.ledger is win.ledger
    assert dup.config.order and not win.config.order
    assert dup.config.max_streams == 2          # dup-immutable, kept
    with pytest.raises(ValueError, match="exceeds"):
        win.dup_with_info(max_streams=3)
    with pytest.raises(ValueError, match="contradicts"):
        win.dup_with_info(same_op="max")


# ---------------------------------------------------------------------------
# window semantics vs the JAX window under vmap, and the phase ledger
# ---------------------------------------------------------------------------

N = 4
RING = [(r, (r + 1) % N) for r in range(N)]


def _jax_vmapped(step, *arrays):
    return np.asarray(jax.vmap(step, axis_name="x")(*map(jnp.asarray, arrays)))


def test_put_and_thread_flush():
    rng = np.random.default_rng(0)
    buf = rng.standard_normal((N, 10)).astype(np.float32)
    data = rng.standard_normal((N, 3)).astype(np.float32)
    cfg = dict(scope="thread", max_streams=2)

    def jstep(b, d):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(**cfg))
        return w.put(d, RING, offset=4, stream=1).flush(stream=1).buffer

    win = T.Window.allocate(torch.from_numpy(buf.copy()), "x", N,
                            T.WindowConfig(**cfg))
    win.put(torch.from_numpy(data), RING, offset=4, stream=1)
    assert win.ledger.total == 1                       # put = 1
    win.flush(stream=0)
    assert win.ledger.total == 1                       # nothing on stream 0
    win.flush(stream=1)
    assert win.ledger.total == 3                       # thread flush = 2
    np.testing.assert_array_equal(win.buffer.numpy(), _jax_vmapped(jstep, buf, data))
    assert win.substrate.completion_ok()
    with pytest.raises(ValueError, match="must name the stream"):
        win.flush()


def test_partial_perm_put_touches_targets_only():
    win = T.Window.allocate(torch.zeros(N, 4), "x", N, T.WindowConfig())
    win.put(torch.arange(8.0).view(N, 2), [(0, 2), (3, 1)], offset=1)
    want = torch.zeros(N, 4)
    want[2, 1:3] = torch.tensor([0.0, 1.0])
    want[1, 1:3] = torch.tensor([6.0, 7.0])
    assert torch.equal(win.buffer, want)


def test_process_flush_walks_every_pending_stream():
    win = T.Window.allocate(torch.zeros(N, 8), "x", N,
                            T.WindowConfig(max_streams=3))
    for s in (0, 2):
        win.put(torch.ones(N, 2), RING, offset=2 * s, stream=s)
    win.flush()
    assert win.ledger.by_kind["flush"] == 4            # 2 x pending streams
    win.flush()
    assert win.ledger.by_kind["flush"] == 4


def test_flush_waits_on_its_streams_counters_only():
    """A thread-scope flush consumes the completion counters of the stream
    it names: a short count there is reported; one on another stream is
    left to that stream's flush, and a process-scope flush walks both."""
    win = T.Window.allocate(torch.zeros(N, 8), "x", N,
                            T.WindowConfig(scope="thread", max_streams=2))
    sub = win.substrate
    for s in (0, 1):
        win.put(torch.ones(N, 2), RING, offset=2 * s, stream=s)
    assert sub.expected == [[1, 1]] * N
    sub.counters[2, 1] -= 1                 # a block of stream 1 never landed
    win.flush(stream=0)
    assert int(sub.stalls) == 0
    win.flush(stream=1)
    assert int(sub.stalls) == 1 and not sub.completion_ok()
    proc = T.Window.allocate(torch.zeros(N, 8), "x", N,
                             T.WindowConfig(max_streams=2))
    for s in (0, 1):
        proc.put(torch.ones(N, 2), RING, offset=2 * s, stream=s)
    proc.substrate.counters[:, 0] -= 1
    proc.substrate.counters[0, 1] -= 1
    proc.flush()
    assert int(proc.substrate.stalls) == N + 1


def test_get_and_rank_offsets():
    rng = np.random.default_rng(1)
    buf = rng.standard_normal((N, 10)).astype(np.float32)
    data = rng.standard_normal((N, 2)).astype(np.float32)
    offs = np.array([0, 3, 5, 8], np.int32)
    perm = [(r, (r + 2) % N) for r in range(N)]

    def jstep(b, d, o):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(scope="thread"))
        w = w.put(d, perm, offset=o)
        w, got = w.get(RING, offset=1, size=3)
        return jnp.concatenate([w.flush(stream=0).buffer, got])

    want = _jax_vmapped(jstep, buf, data, offs)
    win = T.Window.allocate(torch.from_numpy(buf.copy()), "x", N,
                            T.WindowConfig(scope="thread"))
    win.put(torch.from_numpy(data), perm, offset=torch.from_numpy(offs))
    assert win.ledger.by_kind["put"] == 2              # + address word
    _, got = win.get(RING, offset=1, size=3)
    assert win.ledger.by_kind["get"] == 2              # request + response
    win.flush(stream=0)
    np.testing.assert_array_equal(
        torch.cat([win.buffer, got], dim=1).numpy(), want)


ACC_CASES = [
    # (op, count, dtype, declared, expected path, expected phases)
    ("sum", 4, "float32", True, "intrinsic", 1),
    ("min", 4, "int32", True, "intrinsic", 1),
    ("replace", 4, "float32", True, "intrinsic", 1),
    ("bor", 4, "int32", True, "intrinsic", 1),
    ("sum", 16, "float32", True, "tiled", 1),
    ("max", 16, "int32", True, "tiled", 1),
    ("prod", 4, "float32", True, "tiled", 1),
    ("sum", 4, "float32", False, "software", 2),
    ("max", 16, "float32", False, "software", 2),
]


@pytest.mark.parametrize("op,count,dtype,declared,path,phases", ACC_CASES)
def test_routed_accumulate_lands_reference_values(op, count, dtype, declared,
                                                  path, phases):
    rng = np.random.default_rng(count)
    if dtype == "int32":
        buf = rng.integers(-50, 50, (N, 20)).astype(dtype)
        data = rng.integers(-50, 50, (N, count)).astype(dtype)
    else:
        buf = rng.standard_normal((N, 20)).astype(dtype)
        data = rng.standard_normal((N, count)).astype(dtype)
    kw = dict(scope="thread", accumulate_ops=(op,), max_atomic_elems=8)
    if declared:
        kw["same_op"] = op

    def jstep(b, d):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(**kw))
        return w.accumulate(d, RING, op=op, offset=2).flush(stream=0).buffer

    tc = T.WindowConfig(**kw)
    assert T.route_accumulate(op, count, dtype, tc) == path
    win = T.Window.allocate(torch.from_numpy(buf.copy()), "x", N, tc)
    win.accumulate(torch.from_numpy(data), RING, op=op, offset=2)
    assert win.ledger.total == phases
    win.flush(stream=0)
    assert win.ledger.total == phases + 2
    want = np.asarray(JR.ring_accumulate_ref(jnp.asarray(buf), jnp.asarray(data),
                                             axis_size=N, op=op, offset=2))
    np.testing.assert_array_equal(win.buffer.numpy(), want)
    if path != "tiled":   # the Pallas tiled kernel does not run under vmap
        np.testing.assert_array_equal(win.buffer.numpy(),
                                      _jax_vmapped(jstep, buf, data))


def test_accumulate_signal_orders_update_and_flag():
    def jstep(b):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(
            scope="thread", order=True, same_op="sum"))
        w = j_acc.accumulate_signal(w, jnp.full((4,), 2.0), RING, op="sum",
                                    data_offset=0, flag_offset=6)
        return w.flush(stream=0).buffer

    win = T.Window.allocate(torch.zeros(N, 8), "x", N, T.WindowConfig(
        scope="thread", order=True, same_op="sum"))
    t_acc.accumulate_signal(win, torch.full((N, 4), 2.0), RING, op="sum",
                            data_offset=0, flag_offset=6)
    assert win.ledger.total == 2                       # no flush between (P2)
    np.testing.assert_array_equal(win.buffer.numpy(),
                                  _jax_vmapped(jstep, np.zeros((N, 8), np.float32)))


# ---------------------------------------------------------------------------
# compiled ring plans: phase predictions row for row, results bit for bit
# ---------------------------------------------------------------------------

PLANS = [
    dict(n=2), dict(n=4), dict(n=8),
    dict(n=8, topology=(2, 4)), dict(n=8, topology=(4, 2)),
    dict(n=8, topology=(1, 8)), dict(n=8, topology=(8, 1)),
    dict(n=4, order=False), dict(n=4, declare_op=False),
    dict(n=4, bidirectional=True), dict(n=4, lent=True),
    dict(n=4, naive_flush=True), dict(n=8, topology=(2, 4), lent=True),
]


def _plans(n, topology=None, **kw):
    shape = (4 * n,)
    jt = J.Topology(*topology) if topology else None
    tt = T.Topology(*topology) if topology else None
    return (j_all_reduce_plan("x", n, shape, jnp.float32, topology=jt, **kw),
            all_reduce_plan("x", n, shape, torch.float32, topology=tt, **kw))


@pytest.mark.parametrize("case", PLANS, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()))
def test_ring_plan_phases_agree(case):
    jc, tc = _plans(**case)
    assert tc.phase_table() == jc.phase_table()
    assert (tc.phases, tc.phases_inter, tc.phases_intra) == \
        (jc.phases, jc.phases_inter, jc.phases_intra)


def test_ring_phase_splits_at_eight():
    want = {None: (14, 0), (2, 4): (2, 6), (4, 2): (6, 2), (1, 8): (0, 14)}
    for topo, split in want.items():
        _, tc = _plans(8, topology=topo)
        assert (tc.phases_inter, tc.phases_intra) == split


VALUES = [
    dict(n=4), dict(n=8), dict(n=8, topology=(2, 4)),
    dict(n=8, topology=(4, 2)), dict(n=4, order=False),
    dict(n=4, declare_op=False), dict(n=4, bidirectional=True),
]


@pytest.mark.parametrize("length", [16, 13])
@pytest.mark.parametrize("case", VALUES, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()))
def test_plan_all_reduce_bit_identical(case, length):
    case = dict(case)
    n, topo = case.pop("n"), case.pop("topology", None)
    x = np.random.default_rng(n + length).standard_normal(
        (n, length)).astype(np.float32)
    want = np.asarray(j_plan_all_reduce(
        jnp.asarray(x), "x", n, backend="interpret",
        topology=J.Topology(*topo) if topo else None, **case))
    got = plan_all_reduce(torch.from_numpy(x), "x", n,
                          topology=T.Topology(*topo) if topo else None, **case)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", [dict(), dict(order=False),
                                  dict(declare_op=False),
                                  dict(topology=(2, 2))],
                         ids=["k5", "no_p2", "undeclared", "hier"])
def test_replay_ledger_equals_prediction(case):
    """A lent window's ledger after the replay bills exactly the phases the
    planner predicted — through K5 and op by op alike."""
    case = dict(case)
    topo = T.Topology(*case.pop("topology")) if "topology" in case else None
    n = 4
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, 16)).astype(np.float32))
    win = T.Window.allocate(x.clone(), "x", n, T.WindowConfig(
        scope="thread", order=True, same_op="sum"))
    plan_all_reduce(x, "x", n, win=win, topology=topo, **case)
    compiled = all_reduce_plan("x", n, (16,), torch.float32, lent=True,
                               topology=topo, **case)
    assert win.ledger.total == compiled.phases
    assert win.ledger.inter == compiled.phases_inter
    assert not win.group.pending                       # exit epoch drained
    k5 = [low for low in compiled.lowering if low[1] == "k5"]
    assert bool(k5) == (not case and topo is None)


def test_plan_errors_agree():
    for mod in (J, T):
        p = mod.RmaPlan("bad")
        p.window("w", accumulate_ops=("sum",))
        p.bind("g", (4,), "float32")
        p.accumulate("w", "g", [(0, 1)], op="max")
        with pytest.raises(mod.PlanError, match="undeclared operation"):
            p.compile()
        p = mod.RmaPlan("bad")
        p.window("w")
        p.bind("g", (4,), "float32")
        p.put("w", "g", [(0, 1)], stream=3)
        with pytest.raises(mod.PlanError, match="max_streams"):
            p.compile()
        p = mod.RmaPlan("cyc")
        p.window("w")
        p.bind("g", (4,), "float32")
        a = p.put("w", "g", [(0, 1)])
        b = p.put("w", "g", [(1, 0)], after=(a,))
        p.order(b, a)
        with pytest.raises(mod.PlanError, match="cycle"):
            p.compile()


def test_unported_surface_raises_not_implemented(monkeypatch):
    """The backends this surface once refused now compile: a plan with no
    macro stays on the substrate under ``gspmd`` (as the reference's does),
    and the all-to-all macro collapses to one collective step whose result
    equals the substrate's bit for bit."""
    monkeypatch.setenv("RMA_BACKEND_BENCH_JSON", "/nonexistent")
    monkeypatch.setenv("RMA_TORCH_BACKEND_BENCH_JSON", "/nonexistent")
    tables = []
    for mod in (J, T):
        p = mod.RmaPlan("x")
        p.window("w")
        p.bind("g", (2,), "float32")
        p.put("w", "g", [(0, 1), (1, 0)])
        c = p.compile(backend="gspmd")
        assert c.backend == "rma" and c.lowering[:1] == ()
        tables.append(c.phase_table())
    assert tables[0] == tables[1]
    c = T.all_to_all_plan("x", 2, (2,), "float32", backend="gspmd")
    rma = T.all_to_all_plan("x", 2, (2,), "float32", backend="rma")
    assert c.backend == "gspmd" and c.phases == 0
    assert c.phase_table() == [("backend[gspmd]", 0),
                               ("gspmd:all_to_all[a2a[data]]", 0)]
    x = torch.arange(4, dtype=torch.float32).view(2, 2)
    cnts = torch.tensor([[1, 1], [0, 1]], dtype=torch.int32)
    outs = []
    for compiled in (c, rma):
        wins = {"data": T.Window.allocate(x.clone(), "x", 2),
                "hdr": T.Window.allocate(torch.zeros(2, 4, dtype=torch.int32),
                                         "x", 2, T.WindowConfig(
                                             same_op="sum"))}
        outs.append(compiled.execute(wins, {"x": x, "counts": cnts}).outputs)
    for name in ("out", "counts", "bells"):
        assert torch.equal(outs[0][name], outs[1][name]), name


def test_fused_puts_agree_and_land():
    """Same-peer static puts marked fusable compile to one gather-write
    phase in both packages, and land every segment."""
    perm = [(r, (r + 1) % N) for r in range(N)]
    compiled = []
    for mod in (J, T):
        p = mod.RmaPlan("fuse")
        p.window("w", scope="thread", exit_epoch=True)
        p.bind("a", (2,), "float32")
        p.bind("b", (3,), "float32")
        p.put("w", "a", perm, offset=0, fuse=True)
        p.put("w", "b", perm, offset=4, fuse=True)
        compiled.append(p.compile())
    jc, tc = compiled
    assert tc.phase_table() == jc.phase_table() == [
        ("fused-put[w/0]x2", 1), ("flush[w/0]", 2)]
    a = torch.arange(8.0).view(N, 2)
    b = torch.arange(12.0).view(N, 3) + 100
    win = T.Window.allocate(torch.zeros(N, 8), "x", N, T.WindowConfig())
    tc.execute({"w": win}, {"a": a, "b": b})
    want = torch.zeros(N, 8)
    want[:, 0:2] = torch.roll(a, 1, 0)
    want[:, 4:7] = torch.roll(b, 1, 0)
    assert torch.equal(win.buffer, want)
    assert win.ledger.total == tc.phases == 3


def test_fetch_op_and_compare_and_swap():
    rng = np.random.default_rng(9)
    buf = rng.integers(-50, 50, (N, 10)).astype(np.int32)
    data = rng.integers(-50, 50, (N, 3)).astype(np.int32)
    new = rng.integers(100, 200, (N,)).astype(np.int32)
    compare = rng.integers(-50, 50, (N,)).astype(np.int32)
    compare[::2] = buf[(np.arange(0, N, 2) + 1) % N, 7]   # these ranks swap

    def jstep(b, d, c, nw):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(scope="thread"))
        w, old = w.fetch_op(d, RING, op="max", offset=2)
        w, old2 = w.compare_and_swap(c, nw, RING, offset=7)
        return jnp.concatenate([w.flush(stream=0).buffer, old, old2[None]])

    want = _jax_vmapped(jstep, buf, data, compare, new)
    win = T.Window.allocate(torch.from_numpy(buf.copy()), "x", N,
                            T.WindowConfig(scope="thread"))
    _, old = win.fetch_op(torch.from_numpy(data), RING, op="max", offset=2)
    _, old2 = win.compare_and_swap(torch.from_numpy(compare),
                                   torch.from_numpy(new), RING, offset=7)
    assert dict(win.ledger.by_kind) == {"fetch_op": 2, "compare_swap": 2}
    win.flush(stream=0)
    got = torch.cat([win.buffer, old, old2[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plan_fetch_op_agrees():
    from repro.core.rma.backends.interpret import vmapped_execute

    rng = np.random.default_rng(10)
    buf = rng.standard_normal((N, 8)).astype(np.float32)
    g = rng.standard_normal((N, 2)).astype(np.float32)
    compiled = []
    for mod in (J, T):
        p = mod.RmaPlan("fetch")
        p.window("w", scope="thread", accumulate_ops=("sum",), exit_epoch=True)
        p.bind("g", (2,), "float32")
        f = p.fetch_op("w", "g", RING, op="sum", offset=3)
        p.output("old", f)
        compiled.append(p.compile())
    jc, tc = compiled
    assert tc.phase_table() == jc.phase_table()
    want = vmapped_execute(jc, {"w": jnp.asarray(buf)}, {"g": jnp.asarray(g)})
    win = T.Window.allocate(torch.from_numpy(buf.copy()), "x", N,
                            T.WindowConfig())
    res = tc.execute({"w": win}, {"g": torch.from_numpy(g)})
    np.testing.assert_array_equal(res.outputs["old"].numpy(),
                                  np.asarray(want.outputs["old"]))
    np.testing.assert_array_equal(win.buffer.numpy(),
                                  np.asarray(want.buffers["w"]))
    assert win.ledger.total == tc.phases == 4


@pytest.mark.parametrize("scope", ["thread", "process"])
def test_mixed_plan_schedules_agree(scope):
    """A hand-built pattern without P2 — puts on streams the planner
    assigns, a dependent read, a routed accumulate and a signal — compiles
    to the JAX planner's schedule row for row, and its replay bills the
    predicted phases."""
    tables = []
    for mod in (J, T):
        p = mod.RmaPlan("mixed")
        p.window("w", scope=scope, order=False, max_streams=2,
                 accumulate_ops=("sum",), same_op="sum", exit_epoch=True)
        p.bind("a", (2,), "float32")
        p.bind("b", (6,), "float32")
        a = p.put("w", "a", RING, offset=0, label="a")
        b = p.put("w", "a", RING, offset=2, label="b")
        g = p.get("w", RING, offset=0, size=2, after=(a,), label="g")
        acc = p.accumulate("w", "b", RING, offset=4, after=(b, g),
                           label="acc")
        p.signal("w", RING, flag_offset=10, after=(acc,), label="flag")
        p.output("g", g)
        tables.append(p.compile())
    jc, tc = tables
    assert tc.phase_table() == jc.phase_table()
    assert tc.phases == jc.phases
    rng = np.random.default_rng(12)
    buf = rng.standard_normal((N, 12)).astype(np.float32)
    av = rng.standard_normal((N, 2)).astype(np.float32)
    bv = rng.standard_normal((N, 6)).astype(np.float32)
    win = T.Window.allocate(torch.from_numpy(buf.copy()), "x", N,
                            T.WindowConfig(max_streams=2))
    res = tc.execute({"w": win}, {"a": torch.from_numpy(av),
                                  "b": torch.from_numpy(bv)})
    assert win.ledger.total == tc.phases
    want = np.roll(buf, 0, 0).copy()
    want[:, 0:2] = np.roll(av, 1, 0)
    want[:, 2:4] = np.roll(av, 1, 0)
    np.testing.assert_array_equal(res.outputs["g"].numpy(),
                                  np.roll(want[:, 0:2], -1, 0))
    want[:, 4:10] += np.roll(bv, 1, 0)
    want[:, 10] += 1.0
    np.testing.assert_array_equal(win.buffer.numpy(), want)
