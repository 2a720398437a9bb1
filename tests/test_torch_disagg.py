"""Parity of the port's disaggregated prefill→decode data plane with the JAX
package: the control window's layout, ``push_sequence`` (a planned page
push, then a doorbell ordered after the pool's completion token),
``claim_slots`` (tickets, slots, the scheduler's claim counts),
``read_doorbell``, a read through a freed page's stale handle,
``pool_stats``, the pool and control buffers, and the phase ledger against
the reference's collective permutes and its cost model; ``put_signal``
with and without ``after=``; ``PageAllocator``; and ``demo_round_trip`` in
both shapes of the reference's multi-device script.  The JAX side runs
under ``vmap`` over the stacked rank axis; inputs are numpy arrays from a
seed, handed to both.  Every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rma as J
from repro.serve import disagg as jdis
from repro.serve import paged as jpaged
from repro.serve.scheduler import Scheduler as JScheduler

from repro_torch.core import rma as T
from repro_torch.serve import disagg as tdis
from repro_torch.serve import paged as tpaged
from repro_torch.serve.scheduler import Scheduler

N = 4
RING = [(r, (r + 1) % N) for r in range(N)]
CPU = "cpu"
PAGE = dict(page_tokens=4, kv_heads=2, head_dim=4)


@pytest.fixture(autouse=True)
def _hermetic_crossover(monkeypatch):
    monkeypatch.setenv("RMA_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.setenv("RMA_TORCH_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.delenv("RMA_ACC_CROSSOVER", raising=False)
    monkeypatch.delenv("RMA_TOPOLOGY", raising=False)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the control window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_seqs,n_lanes", [(1, 1), (2, 2), (5, 3)])
def test_control_window_layout_matches_reference(n_seqs, n_lanes):
    """Word offsets, size and declarations equal the reference's; the
    port's buffer is the stacked (n, size) int32 zeros."""
    for seq in range(n_seqs):
        assert tdis.ctrl_meta_offset(seq) == jdis.ctrl_meta_offset(seq)
        assert tdis.ctrl_flag_offset(seq) == jdis.ctrl_flag_offset(seq)
    assert tdis.ctrl_size(n_seqs) == jdis.ctrl_size(n_seqs)
    assert tdis.CTRL_TICKET == jdis.CTRL_TICKET == 0
    ctrl = tdis.make_control_window(n_seqs, "x", N, n_lanes=n_lanes,
                                    device=CPU)
    jctrl = jax.vmap(lambda _: jdis.make_control_window(
        n_seqs, "x", N, n_lanes=n_lanes).buffer, axis_name="x")(jnp.zeros(N))
    np.testing.assert_array_equal(_np(ctrl.buffer), np.asarray(jctrl))
    assert ctrl.buffer.dtype == torch.int32
    tc, jc = ctrl.config, jdis.make_control_window(
        n_seqs, "x", N, n_lanes=n_lanes).config
    for key in ("scope", "order", "max_streams", "same_op",
                "accumulate_ops"):
        assert getattr(tc, key) == getattr(jc, key), key
    assert tdis.__all__ == jdis.__all__


# ---------------------------------------------------------------------------
# push, doorbell, admission, stale read: the scenario on both packages
# ---------------------------------------------------------------------------

#: (sequences, pages a sequence, lanes, policy, max_claims a lane)
SHAPES = [(2, 2, 2, "continuous", 1), (3, 1, 1, "static", None),
          (3, 2, 2, "continuous", 2)]


def _spec(n_seqs, pps):
    return dict(PAGE, n_pages=n_seqs * pps + 1)


def _kvs(n_seqs, pps, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n_seqs * pps, N, 2, PAGE["page_tokens"], PAGE["kv_heads"],
             PAGE["head_dim"])
    return rng.standard_normal(shape).astype(np.float32)


def _scenario(mod, pool, ctrl, sched, n_seqs, pps, n_lanes, max_claims,
              page_kv):
    """The reference demo's scenario through ``mod``'s functions: allocate,
    push every sequence on its lane, flush, claim per lane (each lane a
    worker), read the doorbells, free page 0 and read through its old
    handle."""
    win_mod = J if mod is jdis else T
    for p in range(n_seqs * pps):
        pool = pool.alloc_page(p)
    for s in range(n_seqs):
        pages = [s * pps + j for j in range(pps)]
        pool, ctrl = mod.push_sequence(pool, ctrl, s, pages,
                                       [page_kv(p) for p in pages], RING,
                                       lane=s % n_lanes)
    for lane in range(min(n_lanes, n_seqs)):
        ctrl = ctrl.flush(stream=lane)
    ledger_before_claims = (None if mod is jdis else
                            dict(ctrl.ledger.by_kind))
    tickets, slots = [], []
    for lane in range(n_lanes):
        ctrl, ts, ss = mod.claim_slots(ctrl, RING, sched, live=0, lane=lane,
                                       max_claims=max_claims,
                                       source=f"worker{lane}")
        ctrl = ctrl.flush(stream=lane)
        tickets += ts
        slots += ss
    bells = [mod.read_doorbell(ctrl, s) for s in range(n_seqs)]
    if mod is jdis:
        stale_handle = pool.handles[0]
    else:
        stale_handle = pool.handles[:, 0].clone()
    pool_phases = None if mod is jdis else pool.window.ledger.total
    pool = pool.free_page(0)
    mhw = win_mod.win_from_memhandle(pool.window, stale_handle)
    mhw, stale = mhw.get(RING, offset=0, size=8)
    stats = mod.pool_stats(pool)
    stack = jnp.stack if mod is jdis else (lambda xs: torch.stack(xs, 1))
    out = dict(pool=pool.window.buffer, ctrl=ctrl.buffer,
               tickets=stack(tickets), slots=stack(slots),
               flags=stack([b[0] for b in bells]),
               metas=stack([b[1] for b in bells]), stale=stale,
               err=stats["err_count"] + mhw.err_count,
               live=stats["live_pages"], read=pool.read_page(1))
    return out, (pool, ctrl, ledger_before_claims, pool_phases)


def _jax_scenario(n_seqs, pps, n_lanes, policy, max_claims, kvs):
    """The scenario on the reference under ``vmap``, its scheduler, and the
    collective permutes one rank's program issues (its phase count)."""
    def step(kv, sched):
        pool = jpaged.PagedKVWindow.create(jpaged.PageSpec(
            **_spec(n_seqs, pps)), "x", N, jnp.float32)
        ctrl = jdis.make_control_window(n_seqs, "x", N, n_lanes=n_lanes)
        out, _ = _scenario(jdis, pool, ctrl, sched, n_seqs, pps, n_lanes,
                           max_claims, lambda p: kv[p])
        return out

    per_rank = jnp.asarray(np.moveaxis(kvs, 1, 0))     # (N, pages, ...)
    sched = JScheduler(n_seqs, policy)
    want = jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda kv: step(kv, sched), axis_name="x")(per_rank))
    jaxpr = jax.make_jaxpr(lambda kv: step(kv, JScheduler(n_seqs, policy)),
                           axis_env=[("x", N)])(per_rank[0])
    return want, sched, str(jaxpr).count("ppermute[")


@pytest.mark.parametrize("n_seqs,pps,n_lanes,policy,max_claims", SHAPES)
def test_round_trip_scenario_matches_reference(n_seqs, pps, n_lanes, policy,
                                               max_claims):
    """Pool and control buffers, tickets and slots, doorbells and meta
    words, the stale read (zeros, counted once a rank), pool_stats and the
    scheduler's claim counts equal the reference's; the phase ledger equals
    the reference's collective permutes and its cost model: 2 a page + 2 a
    push, put 1 + flag 1 a doorbell, 2 a fetch_op, 2 a lane flush."""
    kvs = _kvs(n_seqs, pps)
    want, jsched, jphases = _jax_scenario(n_seqs, pps, n_lanes, policy,
                                          max_claims, kvs)
    sched = Scheduler(n_seqs, policy)
    pool = tpaged.PagedKVWindow.create(tpaged.PageSpec(**_spec(n_seqs, pps)),
                                       "x", N, torch.float32, device=CPU)
    ctrl = tdis.make_control_window(n_seqs, "x", N, n_lanes=n_lanes,
                                    device=CPU)
    got, (pool, ctrl, before, pool_phases) = _scenario(
        tdis, pool, ctrl, sched, n_seqs, pps, n_lanes, max_claims,
        lambda p: torch.from_numpy(kvs[p]))
    for key, w in want.items():
        g = _np(got[key])
        if key == "live":                   # one host mirror for every rank
            assert (w == g).all(), key
            continue
        np.testing.assert_array_equal(g, w, err_msg=key)
    n_claims = got["tickets"].shape[1]
    assert (got["tickets"] == torch.arange(n_claims)).all()
    assert (got["flags"] == 1).all() and (got["metas"] == pps).all()
    assert not got["stale"].any() and got["err"].tolist() == [1] * N
    assert sched.stats() == jsched.stats()
    assert sched.outstanding_claims() == jsched.outstanding_claims() \
        == n_claims
    lanes = min(n_lanes, n_seqs)
    assert pool_phases == n_seqs * (2 * pps + 2)
    assert before == {"put": n_seqs, "accumulate": n_seqs,
                      "flush": 2 * lanes}
    assert ctrl.ledger.by_kind == {"put": n_seqs, "accumulate": n_seqs,
                                   "flush": 2 * lanes + 2 * n_lanes,
                                   "fetch_op": 2 * n_claims}
    assert pool.window.ledger.total + ctrl.ledger.total == jphases


def test_put_signal_after_a_token_equals_the_call_without():
    """``after=`` orders and bills nothing more: buffers and ledger equal
    the same calls without it; a token of a stream the window lacks, or
    something else than a token, raises."""
    rng = np.random.default_rng(3)
    data = rng.integers(-50, 50, (N, 3)).astype(np.int32)
    outs = []
    for after in (False, True):
        pool = tpaged.PagedKVWindow.create(tpaged.PageSpec(**_spec(1, 1)),
                                           "x", N, torch.float32, device=CPU)
        ctrl = tdis.make_control_window(3, "x", N, device=CPU)
        for lane in (0, 1):
            tok = pool.window.completion_token(lane) if after else None
            T.put_signal(ctrl, torch.from_numpy(data), RING,
                         data_offset=1 + lane, flag_offset=5 + lane,
                         stream=lane, after=tok)
        outs.append((ctrl.buffer.clone(), dict(ctrl.ledger.by_kind),
                     pool.window.ledger.total))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:] and outs[1][2] == 0
    tok = ctrl.completion_token(1)
    assert tok.stream == 1 and tok.event is None
    with pytest.raises(ValueError, match="out of range"):
        ctrl.completion_token(2)
    with pytest.raises(ValueError, match="out of range"):
        pool.window.completion_token(4)
    with pytest.raises(TypeError, match="completion token"):
        T.put_signal(ctrl, torch.from_numpy(data), RING, flag_offset=4,
                     after=torch.zeros(1))


def test_claim_slot_matches_reference():
    """One claim: the ticket and its slot (ticket mod n_slots) per rank,
    after three earlier claims."""
    def jstep(_):
        ctrl = jdis.make_control_window(1, "x", N, n_lanes=1)
        out = []
        for _ in range(4):
            ctrl, t, s = jdis.claim_slot(ctrl, RING, n_slots=3)
            out.append((t, s))
        return jnp.stack([jnp.stack(p) for p in out]), ctrl.buffer

    want = jax.tree_util.tree_map(np.asarray, jax.vmap(
        jstep, axis_name="x")(jnp.zeros(N)))
    ctrl = tdis.make_control_window(1, "x", N, n_lanes=1, device=CPU)
    got = []
    for _ in range(4):
        ctrl, t, s = tdis.claim_slot(ctrl, RING, n_slots=3)
        got.append(torch.stack([t, s], 1))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), want[0])
    np.testing.assert_array_equal(ctrl.buffer.numpy(), want[1])


def test_page_allocator_fifo_and_exhaustion_match_reference():
    outs = []
    for mod in (jdis, tdis):
        a = mod.PageAllocator(5)
        first = a.alloc(3)
        a.free([first[1], first[0]])
        second = a.alloc(4)
        with pytest.raises(RuntimeError, match="exhausted: need 2 pages, "
                                               "0/5 free"):
            a.alloc(2)
        outs.append((first, second, a.n_free, a.allocs, a.frees))
    assert outs[0] == outs[1]
    assert outs[1][1] == [3, 4, 1, 0]          # freed pages reused last


@pytest.mark.parametrize("shape", [
    dict(n_seqs=2, pages_per_seq=2, n_lanes=2),
    dict(n_seqs=3, pages_per_seq=1, n_lanes=1, policy="static")],
    ids=["2x2x2-continuous", "3x1x1-static"])
def test_demo_round_trip_on_the_cpu(shape, capsys):
    """Both shapes of the reference's multi-device script, on 8 stacked
    ranks: the reference's seven checks and the port's ``no_stalls`` (no
    flush gave up, no doorbell withheld) all true."""
    checks = tdis.demo_round_trip(device=CPU, **shape)
    assert list(checks) == ["pages_landed", "doorbells", "meta_page_counts",
                            "tickets", "stale_read_masked",
                            "stale_read_counted", "live_pages", "no_stalls"]
    assert all(checks.values())
    assert f"{tdis.N_DEMO_DEV}-rank ring" in capsys.readouterr().out
