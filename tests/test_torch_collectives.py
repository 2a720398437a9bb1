"""Parity of the port's imperative rings with the JAX package:
``ring_reduce_scatter`` (``order``, ``bidirectional``, ``declare_op``, a
lent window), ``ring_all_gather`` (``owner_shift``) and their composition,
against the reference's run under ``jax.vmap(..., axis_name="x")`` on the
same stacked input (as the reference's ``vmapped_execute`` runs its
substrate); every ring's phase ledger against the collective permutes in
the reference's jaxpr; and ``rma_all_reduce``'s one ``DeprecationWarning``.
Integer-valued float32 payloads from a seed, so sums are exact in any
order; n ∈ {2, 4}."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rma as J
from repro.core.rma import collectives as JC

from repro_torch.core import rma as T
from repro_torch.core.rma import plan as t_plan

L = 24                 # one rank's rows: divisible by 2n for n ∈ {2, 4}


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for var in ("RMA_ACC_BENCH_JSON", "RMA_TORCH_ACC_BENCH_JSON",
                "RMA_BACKEND_BENCH_JSON", "RMA_TORCH_BACKEND_BENCH_JSON"):
        monkeypatch.setenv(var, "/nonexistent")
    monkeypatch.delenv("RMA_ACC_CROSSOVER", raising=False)
    monkeypatch.delenv("RMA_TOPOLOGY", raising=False)


def _x(n, seed, width=()):
    rng = np.random.default_rng(seed)
    return rng.integers(-20, 20, (n, L) + width).astype(np.float32)


def _ppermutes(fn, x, n):
    """The collective permutes one rank's program issues."""
    return str(jax.make_jaxpr(fn, axis_env=[("x", n)])(
        jnp.asarray(x)[0])).count("ppermute[")


def _jwin(x, n, streams):
    return J.Window.allocate(jnp.zeros_like(x), "x", n,
                             J.WindowConfig(max_streams=streams))


def _twin(x, n, streams):
    return T.Window.allocate(torch.zeros_like(x), "x", n,
                             T.WindowConfig(max_streams=streams))


CASES = [(n, order, bidi, declare, lent)
         for n in (2, 4) for order in (True, False)
         for bidi in (False, True)
         for declare, lent in ((True, False), (True, True), (False, True))
         if not (n == 2 and not declare)]


@pytest.mark.parametrize(
    "n,order,bidi,declare,lent", CASES,
    ids=[f"n{c[0]}-{'P2' if c[1] else 'flush'}-{'bidi' if c[2] else 'uni'}"
         f"-{'decl' if c[3] else 'undecl'}{'-lent' if c[4] else ''}"
         for c in CASES])
def test_reduce_scatter_then_all_gather(n, order, bidi, declare, lent):
    x = _x(n, n + 10 * order + 100 * bidi)
    streams = 2 if bidi else 1
    kw = dict(order=order, bidirectional=bidi, declare_op=declare)

    def j_rs(a):
        win = _jwin(a, n, streams) if lent else None
        return JC.ring_reduce_scatter(a, "x", n, win=win, **kw)

    def j_ag(a):
        win = _jwin(jnp.zeros(L), n, 1) if lent else None
        return JC.ring_all_gather(a, "x", n, order=order, owner_shift=1,
                                  win=win)

    j_mine = jax.vmap(j_rs, axis_name="x")(jnp.asarray(x))
    j_full = jax.vmap(j_ag, axis_name="x")(j_mine)
    tx = torch.from_numpy(x)
    twin = _twin(tx, n, streams) if lent else None
    t_mine = T.ring_reduce_scatter(tx, "x", n, win=twin, **kw)
    np.testing.assert_array_equal(t_mine.numpy(), np.asarray(j_mine))
    agwin = _twin(torch.zeros(n, L), n, 1) if lent else None
    t_full = T.ring_all_gather(t_mine, "x", n, order=order, owner_shift=1,
                               win=agwin)
    np.testing.assert_array_equal(t_full.numpy(), np.asarray(j_full))
    if not bidi:
        # RS + AG(owner_shift=1) is the all-reduce
        np.testing.assert_array_equal(t_full.numpy(),
                                      np.tile(x.sum(0), (n, 1)))
    assert torch.equal(tx, torch.from_numpy(x)), "the input was written"
    if lent:
        # the ledger equals the reference's permutes, and the cost model:
        # (n-1) data phases a direction, a completion ack a hop when
        # undeclared, 2 a dependent hop's flush without P2, 2 a stream on
        # exit; nothing is left in flight on the lent window
        want = _ppermutes(j_rs, x, n)
        assert twin.ledger.total == want
        hops = (n - 1) * streams
        model = (hops * (1 if declare else 2)
                 + (0 if order else 2 * (n - 2) * streams) + 2 * streams)
        assert want == model
        assert not twin.group.pending
        assert agwin.ledger.total == _ppermutes(j_ag, np.asarray(j_mine), n) \
            == (n - 1) + (0 if order else 2 * (n - 2)) + 2


@pytest.mark.parametrize("n", [2, 4])
def test_all_gather_owner_shift_and_width(n):
    rng = np.random.default_rng(7)
    x = rng.integers(-9, 9, (n, 3, 2)).astype(np.float32)
    for shift in (0, 1, n - 1):
        want = jax.vmap(lambda a: JC.ring_all_gather(
            a, "x", n, owner_shift=shift), axis_name="x")(jnp.asarray(x))
        got = T.ring_all_gather(torch.from_numpy(x), "x", n,
                                owner_shift=shift)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ring_argument_checks():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="not divisible"):
        T.ring_reduce_scatter(x, "x", 4)
    with pytest.raises(ValueError, match="stacked"):
        T.ring_reduce_scatter(torch.zeros(3, 8), "x", 4)
    with pytest.raises(ValueError, match="max_streams"):
        T.ring_reduce_scatter(torch.zeros(4, 8), "x", 4, bidirectional=True,
                              win=_twin(torch.zeros(4, 8), 4, 1))
    one = torch.ones(1, 5)
    assert T.ring_reduce_scatter(one, "x", 1) is one


def test_rma_all_reduce_warns_once_and_equals_plan_all_reduce():
    x = torch.from_numpy(_x(4, 3))
    t_plan._LEGACY_WARNED.discard("repro_torch.core.rma.rma_all_reduce")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = T.rma_all_reduce(x, "x", 4)
        second = T.rma_all_reduce(x, "x", 4, order=False, bidirectional=True)
    hits = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(hits) == 1 and "rma_all_reduce" in str(hits[0].message)
    assert torch.equal(first, T.plan_all_reduce(x, "x", 4))
    assert torch.equal(second, T.plan_all_reduce(x, "x", 4, order=False,
                                                 bidirectional=True))
    want = jax.vmap(lambda a: JC.plan_all_reduce(a, "x", 4),
                    axis_name="x")(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(first.numpy(), np.asarray(want))
