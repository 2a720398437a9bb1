"""Parity of the port's planned all-to-all and put+signal with the JAX
package.  The reference side is the meshless ``plan_all_to_all(...,
backend="interpret")`` on stacked inputs and ``all_to_all_plan(...)``'s
predicted phases; the port replays the same pattern on its substrate (the
plain versions of K3/K4/K6 here).  Inputs are numpy arrays from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rma as J
from repro.core.rma.alltoall import all_to_all_plan as j_a2a_plan
from repro.core.rma.alltoall import plan_all_to_all as j_plan_a2a
from repro.core.rma.collectives import put_signal as j_put_signal
from repro.core.rma.collectives import \
    put_signal_pipelined as j_put_signal_pipelined

from repro_torch.core import rma as T
from repro_torch.core.rma.alltoall import all_to_all_plan, plan_all_to_all
from repro_torch.core.rma.collectives import (put_signal,
                                              put_signal_pipelined)

M, W = 4, 3        # rows per peer block, row width


def _topo(mod, topology):
    return mod.Topology(*topology) if topology else None


def _payload(rng, n, dtype):
    shape = (n, n * M, W)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


# (n, topology, op, chunks, dtype): flat n ∈ {2, 4, 8}, hierarchical 2×2
# and 2×4, both landing rules, chunked and not, integer and float payloads
# (each reference replay costs seconds, so every case covers several axes)
CASES = [
    (2, None, "sum", 2, "int32"),
    (4, None, None, 1, "int32"),
    (4, None, "sum", 1, "float32"),
    (4, None, None, 2, "float32"),
    (8, None, None, 1, "float32"),
    (4, (2, 2), "sum", 1, "float32"),
    (8, (2, 4), None, 1, "int32"),
]


def _case_id(c):
    n, topo, op, chunks, dt = c
    return f"n{n}-{'x'.join(map(str, topo)) if topo else 'flat'}-{op}-c{chunks}-{dt}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plan_all_to_all_bit_identical(case):
    n, topology, op, chunks, dtype = case
    rng = np.random.default_rng(CASES.index(case))
    x = _payload(rng, n, dtype)
    counts = rng.integers(0, M + 1, (n, n)).astype(np.int32)
    want = j_plan_a2a(jnp.asarray(x), "x", n, counts=jnp.asarray(counts),
                      op=op, chunks=chunks, topology=_topo(J, topology),
                      backend="interpret")
    got = plan_all_to_all(torch.from_numpy(x), "x", n,
                          counts=torch.from_numpy(counts), op=op,
                          chunks=chunks, topology=_topo(T, topology))
    for name in ("data", "counts", "bells"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


# compile-only: predicted phases of every declaration the reference plans
PHASE_CASES = [dict(n=n, topology=t, op=op, chunks=c, order=o, declare=d,
                    lent=lent, naive_flush=nf)
               for n, t in ((2, None), (4, None), (8, None), (4, (2, 2)),
                            (8, (2, 4)), (8, (4, 2)))
               for op in (None, "sum") for c in (1, 2)
               for o, d, lent, nf in ((True, True, False, False),
                                      (False, True, False, False),
                                      (True, False, False, False),
                                      (True, True, True, False),
                                      (True, True, False, True))
               if not (t and c == 2)]


def _plans(n, topology, **kw):
    shape = (n * M, W)
    return (j_a2a_plan("x", n, shape, jnp.float32,
                       topology=_topo(J, topology), **kw),
            all_to_all_plan("x", n, shape, torch.float32,
                            topology=_topo(T, topology), **kw))


def test_all_to_all_phases_agree():
    for case in PHASE_CASES:
        jc, tc = _plans(**case)
        assert (tc.phases, tc.phases_inter, tc.phases_intra) == \
            (jc.phases, jc.phases_inter, jc.phases_intra), case
        assert tc.phase_table() == [tuple(r) for r in jc.phase_table()], case


def test_moe_exchange_phase_count_is_pinned():
    """The count ``chip_smoke.py`` holds the card's ledger to: per peer one
    fetch_op (2) + one data phase + one doorbell, plus the header window's
    exit epoch on both streams — 16 at n = 4, for either landing rule."""
    for op in (None, "sum"):
        jc, tc = _plans(4, None, op=op)
        assert jc.phases == tc.phases == 16


def _windows(n, x, order=True, declare=True, op=None):
    hdr = T.Window.allocate(
        torch.zeros((n, 2 * n), dtype=torch.int32), "x", n,
        T.WindowConfig(scope="thread", order=order, max_streams=2,
                       same_op="sum" if declare else None,
                       accumulate_ops=("sum",)))
    acc = ({"same_op": op, "accumulate_ops": (op,)}
           if op is not None and declare else {})
    data = T.Window.allocate(x, "x", n, T.WindowConfig(
        scope="thread", order=order, max_streams=2, **acc))
    return {"data": data, "hdr": hdr}


@pytest.mark.parametrize("order,declare,kernel", [
    (True, True, None), (False, True, "rma"), (True, False, "rma")])
@pytest.mark.parametrize("op", [None, "sum"])
def test_lowering_and_ledger(op, order, declare, kernel):
    """Declared and ordered, every peer's last transfer and its doorbell
    are one K4 (plain) or K6 (sum) launch; the baselines run op by op.  The
    replay's ledger equals the prediction either way."""
    n = 4
    kernel = kernel or ("k4" if op is None else "k6")
    compiled = all_to_all_plan("x", n, (n * M, W), torch.float32, op=op,
                               order=order, declare=declare)
    pairs = [low for low in compiled.lowering if "+" in low[0]]
    assert [low[1] for low in pairs] == [kernel] * (n - 1)
    x = torch.from_numpy(_payload(np.random.default_rng(3), n, "float32"))
    wins = _windows(n, x, order, declare, op)
    res = compiled.execute(wins, {"x": x, "counts": torch.full(
        (n, n), M, dtype=torch.int32)})
    assert sum(w.ledger.total for w in wins.values()) == compiled.phases
    ref = plan_all_to_all(x, "x", n, op=op, order=order, declare=declare)
    np.testing.assert_array_equal(res.outputs["out"].numpy(),
                                  ref.data.numpy())


@pytest.mark.parametrize("op", [None, "sum"])
@pytest.mark.parametrize("topology", [None, (2, 2)])
def test_exchange_gradient_is_the_exchange(op, topology):
    """The block exchange is its own transpose: the gradient of
    ``<w, a2a(x)>`` with respect to x is ``a2a(w)``, and the integer
    outputs carry none."""
    n = 4
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_payload(rng, n, "float32")).requires_grad_(True)
    w = torch.from_numpy(_payload(rng, n, "float32"))
    res = plan_all_to_all(x, "x", n, op=op, topology=_topo(T, topology))
    assert not res.counts.requires_grad and not res.bells.requires_grad
    (g,) = torch.autograd.grad((res.data * w).sum(), x)
    want = w.view(n, n, M, W).transpose(0, 1).reshape(n, n * M, W)
    torch.testing.assert_close(g, want, rtol=0, atol=0)
    torch.testing.assert_close(
        plan_all_to_all(w, "x", n, op=op).data, want, rtol=0, atol=0)


def test_exchange_rejects_unported_backends(monkeypatch):
    """Every backend the exchange once refused now runs and lands the
    ``rma`` exchange's data, counts and bells bit for bit (``auto`` with no
    table falls back to ``rma``); only ``interpret`` on a lent window is
    refused, as in the reference."""
    monkeypatch.setenv("RMA_TORCH_BACKEND_BENCH_JSON", "/nonexistent")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-9, 9, (2, 4, 1)).astype(np.float32))
    cnts = torch.tensor([[2, 1], [0, 2]], dtype=torch.int32)
    want = plan_all_to_all(x, "x", 2, counts=cnts)
    for backend in ("gspmd", "auto", "interpret"):
        got = plan_all_to_all(x, "x", 2, counts=cnts, backend=backend)
        for a, b in zip(got, want):
            assert torch.equal(a, b), backend
    lent = T.Window.allocate(torch.zeros(2, 4, 1), "x", 2)
    with pytest.raises(ValueError, match="lent window"):
        plan_all_to_all(x, "x", 2, backend="interpret", win=lent)


# ---------------------------------------------------------------------------
# put_signal / put_signal_pipelined (paper Listings 1 and 2)
# ---------------------------------------------------------------------------

N = 4
RING = [(r, (r + 1) % N) for r in range(N)]
SIGNAL_CASES = [dict(order=o, scope=s, same_op=d)
                for o in (True, False) for s in ("thread", "process")
                for d in ("sum", None)]


def _signal_phases(order, scope, same_op, pending_streams=1):
    """The reference cost model: put 1, the flag accumulate 1 (2 on a
    hint-less window), and without P2 a flush between them — 2 per stream
    it drains."""
    flush = 0 if order else 2 * pending_streams
    return 1 + flush + (1 if same_op else 2)


@pytest.mark.parametrize("case", SIGNAL_CASES, ids=lambda c: "-".join(
    map(str, c.values())))
@pytest.mark.parametrize("pipelined", [False, True])
def test_put_signal_lands_and_bills_like_the_reference(case, pipelined):
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((N, 12)).astype(np.float32)
    data = rng.standard_normal((N, 4)).astype(np.float32)
    cfg = dict(scope=case["scope"], order=case["order"], max_streams=2)
    if case["same_op"]:
        cfg.update(same_op="sum", accumulate_ops=("sum",))

    def jstep(b, d):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(**cfg))
        if pipelined:
            w = j_put_signal_pipelined(w, d, RING, chunks=2, data_offset=2,
                                       flag_offset=10)
        else:
            w = j_put_signal(w, d, RING, data_offset=2, flag_offset=10)
        return w.buffer

    want = np.asarray(jax.vmap(jstep, axis_name="x")(jnp.asarray(buf),
                                                     jnp.asarray(data)))
    win = T.Window.allocate(torch.from_numpy(buf.copy()), "x", N,
                            T.WindowConfig(**cfg))
    d = torch.from_numpy(data)
    if pipelined:
        put_signal_pipelined(win, d, RING, chunks=2, data_offset=2,
                             flag_offset=10)
    else:
        put_signal(win, d, RING, data_offset=2, flag_offset=10)
    np.testing.assert_array_equal(win.buffer.numpy(), want)
    assert win.ledger.total == _signal_phases(**case) + (1 if pipelined else 0)
    assert win.substrate.completion_ok()


def test_unordered_process_put_signal_drains_every_stream():
    """Listing 1 under process scope: the flush walks every pending stream
    (2 phases each) before the flag, as ``Window.flush`` would."""
    win = T.Window.allocate(torch.zeros(N, 12), "x", N, T.WindowConfig(
        scope="process", order=False, max_streams=2, same_op="sum",
        accumulate_ops=("sum",)))
    win.put(torch.ones(N, 2), RING, offset=0, stream=1)
    put_signal(win, torch.ones(N, 4), RING, data_offset=2, flag_offset=10)
    assert win.ledger.by_kind["flush"] == 4
    assert win.ledger.total == 1 + _signal_phases(False, "process", "sum", 2)
    assert list(win.group.pending) == [0]            # the flag is in flight
    # after= takes a window's completion token, nothing else
    with pytest.raises(TypeError, match="completion token"):
        put_signal(win, torch.ones(N, 4), RING, flag_offset=10, after=object())
