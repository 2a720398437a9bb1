"""Parity of the port's tiered KV pool with the JAX package: the plans
(``tier_step_plan`` and ``transfer_plan``, their prefetch edges and phase
tables), ``PagedKVWindow`` on every data path, ``HostKVTier`` (round trips,
stale cold pages, the int32 pool guard), the executor's payload
gather/scatter and ``map_slot``, and the tiered engine's greedy tokens and
tier counters on ``tiny_config("qwen3-4b")`` at float32 with the
reference's parameters (``params_from_jax``).  The JAX side of the window
tests runs under ``vmap`` over the stacked rank axis; inputs are numpy
arrays from a seed, handed to both.  Every comparison is exact (integer
counts, copied payloads, greedy tokens) unless its line names a
tolerance."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.core import rma as J
from repro.core.rma import accumulate as j_acc
from repro.models import build_model as j_build_model
from repro.serve import paged as jpaged
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.core import rma as T
from repro_torch.core.rma import plan as tplan
from repro_torch.models import build_model
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import leaves_with_paths

N = 4
RING = [(r, (r + 1) % N) for r in range(N)]
SHIFT2 = [(r, (r + 2) % N) for r in range(N)]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _hermetic_crossover(monkeypatch):
    monkeypatch.setenv("RMA_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.setenv("RMA_TORCH_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.delenv("RMA_ACC_CROSSOVER", raising=False)
    monkeypatch.delenv("RMA_TOPOLOGY", raising=False)


@pytest.fixture
def plain_tiled_reference(monkeypatch):
    """The reference's tiled route folds through its Pallas kernel, which
    has no batching rule under ``vmap``; fold through its plain combine."""
    monkeypatch.setattr(j_acc, "path_combine",
                        lambda path, op: (lambda c, u: j_acc.apply_op(c, u, op)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# plans: tier_step_plan, transfer_plan, prefetch edges
# ---------------------------------------------------------------------------

TIER_SETS = [((0, 1), (2,)), ((0,), ()), ((), (1, 2)), ((3, 1, 0), (2,)),
             ((2,), (0, 1, 3)), ((5, 4), (0, 1, 2, 3))]


@pytest.mark.parametrize("promote,demote", TIER_SETS)
def test_tier_step_plan_phase_table_matches_reference(promote, demote):
    """Row for row, phase for phase; the streams each op rides; the
    reference's prefetch ordering (promotes lead on stream 3, the demotes
    ride another, the prefetch-wait lands after them and before the
    gather)."""
    jc = jpaged.tier_step_plan(6, promote, demote, 8, jnp.float32)
    tc = tpaged.tier_step_plan(6, promote, demote, 8, torch.float32)
    assert tc.phase_table() == jc.phase_table()
    assert tc.phases == jc.phases
    streams = [(s.op.label, s.stream) for s in tc.steps
               if s.kind == "op" and s.op.kind != "compute"]
    assert streams == [(s.op.label, s.stream) for s in jc.steps
                       if s.kind == "op" and s.op.kind != "compute"]
    assert all(st == 3 for lb, st in streams if lb.startswith("promote"))
    assert all(st != 3 for lb, st in streams if lb.startswith("demote"))
    names = [n for n, _ in tc.phase_table()]
    if promote:
        assert names[:len(promote)] == [f"prefetch:promote[{s}]"
                                        for s in promote]
        pw = names.index("prefetch-wait[host/3]")
        assert all(n.startswith(("prefetch:", "demote")) for n in names[:pw])
        assert pw == len(promote) + len(demote)
        assert dict(tc.phase_table())[f"prefetch:promote[{promote[0]}]"] == 2
    else:
        assert not any("prefetch" in n for n in names)


@pytest.mark.parametrize("pages,perm,stream,topology", [
    ((0, 2), tuple(RING), 0, None),
    ((1,), tuple(SHIFT2), 1, None),
    ((3, 0, 1), tuple(RING), 2, (2, 2)),
    ((2, 3), ((0, 1), (1, 0), (2, 3), (3, 2)), 0, (2, 2)),
])
def test_transfer_plan_matches_reference(pages, perm, stream, topology):
    """The page push: phase tables row for row (2 per page and 2 for the
    epoch; the intra tier under a declared topology), and the build-once
    cache keyed exactly as the reference keys it."""
    jt = None if topology is None else J.Topology(*topology)
    tt = None if topology is None else T.Topology(*topology)
    jc = jpaged.transfer_plan(4, pages, 16, jnp.float32, perm, stream,
                              topology=jt)
    tc = tpaged.transfer_plan(4, pages, 16, torch.float32, perm, stream,
                              topology=tt)
    assert tc.phase_table() == jc.phase_table()
    assert (tc.phases, tc.phases_inter, tc.phases_intra) == \
        (jc.phases, jc.phases_inter, jc.phases_intra)
    jkey = next(k for k, v in jpaged._TRANSFER_PLANS.items() if v is jc)
    tkey = next(k for k, v in tpaged._TRANSFER_PLANS.items() if v is tc)
    assert tkey == jkey
    assert tpaged.transfer_plan(4, pages, 16, "float32", perm, stream,
                                topology=tt) is tc


def test_tier_plan_cache_keys_match_reference():
    jc = jpaged.tier_step_plan(4, (1, 0), (2,), 8, jnp.bfloat16)
    tc = tpaged.tier_step_plan(4, (1, 0), (2,), 8, torch.bfloat16)
    jkey = next(k for k, v in jpaged._TIER_PLANS.items() if v is jc)
    tkey = next(k for k, v in tpaged._TIER_PLANS.items() if v is tc)
    assert tkey == jkey
    assert tplan.plan_cache_stats()["kv_tier_step"] >= 1
    assert tplan.plan_cache_stats()["kv_transfer"] >= 0


def _prefetch_plans(mod, dt):
    """A generic plan with one prefetch edge: a get prefetched for a
    compute, a put issued meanwhile."""
    p = mod.RmaPlan("pf")
    p.window("w", scope="thread", max_streams=3, dtype=dt, exit_epoch=True)
    p.bind("x", (4,), dt)
    a = p.put("w", "x", RING, offset=0, label="a")
    g = p.get("w", SHIFT2, offset=4, size=4, label="g")
    b = p.put("w", "x", SHIFT2, offset=8, label="b", after=(a,))
    c = p.compute(lambda env: env[g] * 2, reads=(g,), label="use")
    p.prefetch(g, c)
    p.output("y", c)
    return p.compile(), b


def test_generic_prefetch_edge_matches_reference_and_replays():
    """Outside the tier plan: the prefetched get takes the last stream,
    the other chains keep to the rest, the wait lands before the consumer;
    the replay's buffer and output equal the reference's bit for bit and
    its ledger equals the prediction."""
    jc, _ = _prefetch_plans(J, jnp.float32)
    tc, _ = _prefetch_plans(T, "float32")
    assert tc.phase_table() == jc.phase_table()
    assert [n for n, _ in tc.phase_table()][:4] == \
        ["a", "prefetch:g", "b", "prefetch-wait[w/2]"]
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((N, 16)).astype(np.float32)
    x = rng.standard_normal((N, 4)).astype(np.float32)

    def jstep(b, d):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(scope="thread",
                                                         max_streams=3))
        res = jc.execute({"w": w}, {"x": d})
        return res.windows["w"].buffer, res.outputs["y"]

    want = jax.vmap(jstep, axis_name="x")(jnp.asarray(pool), jnp.asarray(x))
    win = T.Window.allocate(_t(pool), "x", N,
                            T.WindowConfig(scope="thread", max_streams=3))
    res = tc.execute({"w": win}, {"x": _t(x)})
    np.testing.assert_array_equal(win.buffer.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(res.outputs["y"].numpy(),
                                  np.asarray(want[1]))
    assert win.ledger.total == tc.phases
    assert not win.group.pending


def test_prefetch_on_compute_rejected():
    for mod, dt in ((J, jnp.float32), (T, "float32")):
        plan = mod.RmaPlan("bad")
        plan.window("w", dtype=dt)
        plan.bind("x", (4,), dt)
        plan.put("w", "x", [(0, 0)], offset=0)
        g = plan.get("w", [(0, 0)], offset=0, size=4)
        b = plan.compute(lambda env: env[g] + 1, reads=(g,))
        c = plan.compute(lambda env: env[b] * 2, reads=(b,))
        plan.prefetch(b, c)
        with pytest.raises(mod.PlanError, match="only transport"):
            plan.compile()


def test_plain_plans_render_identically_without_prefetch():
    tables = []
    for mod, dt in ((J, jnp.float32), (T, "float32")):
        plan = mod.RmaPlan("plain")
        plan.window("w", dtype=dt, max_streams=2, exit_epoch=True)
        plan.bind("x", (4,), dt)
        plan.put("w", "x", [(0, 0)], offset=0, stream=0, label="a")
        plan.get("w", [(0, 0)], offset=0, size=4, stream=1, label="b")
        compiled = plan.compile()
        tables.append(compiled.phase_table())
        assert not any(getattr(s, "pwait", False) for s in compiled.steps)
    assert tables[0] == tables[1]
    assert all("prefetch" not in n for n, _ in tables[1])


# ---------------------------------------------------------------------------
# PagedKVWindow
# ---------------------------------------------------------------------------

SPEC = dict(page_tokens=4, kv_heads=2, head_dim=4, n_pages=3)


def _window_inputs(seed=0):
    rng = np.random.default_rng(seed)
    page = (N, 2, SPEC["page_tokens"], SPEC["kv_heads"], SPEC["head_dim"])
    kvs = [rng.standard_normal(page).astype(np.float32) for _ in range(4)]
    small = rng.standard_normal((N, 4)).astype(np.float32)
    big = rng.standard_normal((N, 64)).astype(np.float32)
    junk = np.full((N, 8), 99.0, np.float32)
    return kvs, small, big, junk


@pytest.mark.usefixtures("plain_tiled_reference")
def test_paged_window_matches_reference():
    """The scenario of the reference's multi-device paged-window script at
    n = 4: a local fill, a handle push, a batched plan push, accumulates on
    the intrinsic and the tiled route, a handle read, a freed page's stale
    put dropped and its read zeroed, both counted — pools, reads, handles
    and err_count equal bit for bit."""
    kvs, small, big, junk = _window_inputs()

    def jstep(k0, k1, k2, k3, sm, bg, jk):
        pool = jpaged.PagedKVWindow.create(jpaged.PageSpec(**SPEC), "x", N,
                                           jnp.float32)
        pool = pool.alloc_page(0).alloc_page(1)
        pool = pool.write_page_local(0, k0)
        pool = pool.put_page_remote(1, k1, RING)
        pool = pool.alloc_page(2)
        pool = pool.push_pages([0, 2], [k2, k3], SHIFT2)
        pool = pool.accumulate_page(1, sm, RING, offset=3)       # intrinsic
        pool = pool.accumulate_page(2, bg, SHIFT2)               # tiled
        pool, got = pool.get_page_remote(1, RING)
        stale = pool.handles[1]
        pool = pool.free_page(1)
        mhw = J.win_from_memhandle(pool.window, stale).put(jk, RING)
        pool = pool._replace(window=mhw.parent,
                             err_count=pool.err_count + mhw.err_count)
        pool, freed = pool.get_page_remote(1, SHIFT2)
        return (pool.window.buffer, pool.handles, pool.live, pool.err_count,
                got, freed, pool.read_page(0))

    want = jax.tree_util.tree_map(np.asarray, jax.vmap(
        jstep, axis_name="x")(*map(jnp.asarray, (*kvs, small, big, junk))))

    pool = tpaged.PagedKVWindow.create(tpaged.PageSpec(**SPEC), "x", N,
                                       torch.float32, device=CPU)
    pool.alloc_page(0).alloc_page(1)
    pool.write_page_local(0, _t(kvs[0]))
    pool.put_page_remote(1, _t(kvs[1]), RING)
    pool.alloc_page(2)
    pool.push_pages([0, 2], [_t(kvs[2]), _t(kvs[3])], SHIFT2)
    pool.accumulate_page(1, _t(small), RING, offset=3)
    pool.accumulate_page(2, _t(big), SHIFT2)
    _, got = pool.get_page_remote(1, RING)
    stale = pool.handles[:, 1].clone()
    pool.free_page(1)
    mhw = T.win_from_memhandle(pool.window, stale).put(_t(junk), RING)
    pool.err_count += mhw.err_count
    _, freed = pool.get_page_remote(1, SHIFT2)
    got_all = (pool.window.buffer, pool.handles, pool.live, pool.err_count,
               got, freed, pool.read_page(0))
    names = ("pool", "handles", "live", "err_count", "read", "freed read",
             "read_page")
    for name, g, w in zip(names, got_all, want):
        if name == "live":                   # every rank holds the same
            assert (w == _np(g)[None]).all(), name
            continue
        np.testing.assert_array_equal(_np(g), w, err_msg=name)
    assert pool.err_count.tolist() == [2] * N
    assert not _np(freed).any()


def test_paged_window_guards_raise_with_the_page_id():
    spec = tpaged.PageSpec(page_tokens=4, kv_heads=1, head_dim=2, n_pages=3)
    pool = tpaged.PagedKVWindow.create(spec, "x", 1, torch.float32,
                                       device=CPU)
    pool.alloc_page(1)
    with pytest.raises(ValueError, match=r"alloc_page\(1\)"):
        pool.alloc_page(1)
    pool.free_page(1)
    with pytest.raises(ValueError, match=r"free_page\(1\)"):
        pool.free_page(1)
    with pytest.raises(ValueError, match=r"free_page\(7\)"):
        pool.free_page(7)
    pool.alloc_page(1)                   # free then re-alloc is legitimate
    assert pool.live.tolist() == [False, True, False]
    with pytest.raises(ValueError, match="host=True"):
        tpaged.PagedKVWindow.create(spec, "x", 1, torch.float32, device=CPU,
                                    host=True)


def test_transfer_pages_warns_once_and_equals_push_pages():
    kvs, *_ = _window_inputs(3)
    spec = tpaged.PageSpec(**SPEC)
    out = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for legacy in (True, True, False):
            pool = tpaged.PagedKVWindow.create(spec, "x", N, torch.float32,
                                               device=CPU)
            pool.alloc_page(0).alloc_page(2)
            push = pool.transfer_pages if legacy else pool.push_pages
            push([0, 2], [_t(kvs[0]), _t(kvs[1])], RING)
            out.append(pool.window.buffer.clone())
            assert pool.window.ledger.total == 2 * 2 + 2
    deps = [w for w in caught if issubclass(w.category, DeprecationWarning)
            and "transfer_pages" in str(w.message)]
    assert len(deps) <= 1                # once per process
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[2])


# ---------------------------------------------------------------------------
# HostKVTier
# ---------------------------------------------------------------------------

def test_host_tier_round_trip_matches_reference():
    """Demote two pages, promote them back (and one in the reverse order):
    bit-exact, equal to the reference tier's, no stale drop."""
    rng = np.random.default_rng(5)
    pay = rng.standard_normal((3, 16)).astype(np.float32)
    jt = jpaged.HostKVTier(4, 16, jnp.float32)
    tt = tpaged.HostKVTier(4, 16, torch.float32, device=CPU)
    for tier, arr in ((jt, jnp.asarray), (tt, _t)):
        tier.alloc([0, 1, 3])
        assert tier.step((), (0, 1, 3), arr(pay)) is None
    jout = np.asarray(jt.step((3, 0), (), None))
    tout = tt.step((3, 0), (), None)
    np.testing.assert_array_equal(tout.numpy(), jout)
    np.testing.assert_array_equal(tout.numpy(), pay[[2, 0]])
    assert tt.err_count.tolist() == [0] == [int(jt.err_count)]
    assert tt.pool.window.ledger.total == sum(
        tpaged.tier_step_plan(4, p, d, 16, torch.float32).phases
        for p, d in (((), (0, 1, 3)), ((3, 0), ())))
    assert tt.step((), ()) is None


def test_demoted_then_freed_page_never_read():
    """The reference's stale-cold-page scenario on both packages: a promote
    through a handle snapshot taken before the free returns the live slot's
    bytes, zeros for the freed one, and counts one drop; the slot re-arms
    cleanly."""
    outs = []
    for mod, arr, dt in ((jpaged, jnp.asarray, jnp.float32),
                         (tpaged, _t, torch.float32)):
        kw = {} if mod is jpaged else dict(device=CPU)
        tier = mod.HostKVTier(4, 16, dt, **kw)
        tier.alloc([0, 1])
        tier.step((), (0, 1), arr(np.stack([np.full(16, 5.0, np.float32),
                                            np.full(16, 7.0, np.float32)])))
        stale = (tier.pool.handles.clone() if mod is tpaged
                 else tier.pool.handles)
        tier.free([1])
        compiled = mod.tier_step_plan(4, (0, 1), (), 16, dt)
        if mod is jpaged:
            win = jax.tree_util.tree_map(lambda x: x[None], tier.pool.window)

            def run(w, h, compiled=compiled):
                res = compiled.execute({"host": w}, {"handles": h})
                return res.outputs["promoted"], res.err_count

            out, errs = jax.vmap(run, axis_name="x")(win, stale[None])
            out, errs = np.asarray(out[0]), int(errs.reshape(()))
        else:
            res = compiled.execute({"host": tier.pool.window},
                                   {"handles": stale})
            out, errs = res.outputs["promoted"][0].numpy(), int(
                res.err_count.sum())
        tier.alloc([1])
        tier.step((), (1,), arr(np.full((1, 16), 9.0, np.float32)))
        again = np.asarray(tier.step((1,), (), None))
        outs.append((out, errs, again))
    (jo, je, ja), (to, te, ta) = outs
    np.testing.assert_array_equal(to, jo)
    assert (to[0] == 5.0).all() and not to[1].any()
    assert te == je == 1
    np.testing.assert_array_equal(ta, ja)
    assert (ta == 9.0).all()


def test_host_tier_pool_guard_and_placement():
    """The int32 pool guard raises before anything is allocated (the
    reference wraps); an unpinned CPU buffer under control state on the
    card raises."""
    with pytest.raises(ValueError, match="2\\^31"):
        tpaged.HostKVTier(2**31 // 1024, 1024, torch.bfloat16, device=CPU)
    with pytest.raises(ValueError, match="even"):
        tpaged.HostKVTier(2, 15, torch.float32, device=CPU)
    tpaged.HostKVTier(2**31 // (1 << 20) - 1, 1 << 20, torch.bfloat16,
                      device="meta")
    with pytest.raises(ValueError, match="pinned"):
        T.Window.allocate(torch.zeros(1, 8), "x", 1, device="cuda")


# ---------------------------------------------------------------------------
# the executor's payload ops and the tiered engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny_config("qwen3-4b")
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = tiny_config("qwen3-4b")
    m = build_model(cfg)
    p = params_from_jax(jax.device_get(jp), cfg, device=CPU)
    return jm, jp, cfg, m, p


def _assert_caches_equal(tc, jc, what):
    for (path, t), (_, j) in zip(leaves_with_paths(tc),
                                 leaves_with_paths(jax.device_get(jc))):
        np.testing.assert_array_equal(_np(t), np.asarray(j),
                                      err_msg=f"{what} {path}")


def test_executor_payloads_and_map_slot_match_reference(models):
    """On a paged cache carried across from a few engine ticks:
    ``gather_page_payloads`` equals the reference's, a scatter of fresh
    payloads and ``map_slot`` leave every cache leaf equal, exactly (the
    reference's cache is copied into the port's first)."""
    jm, jp, cfg, m, p = models
    rng = np.random.RandomState(4)
    reqs = [(i, rng.randint(0, cfg.vocab, size=5 + 3 * i), 8)
            for i in range(3)]
    kw = dict(n_slots=4, max_seq=32, paged_kv=True, page_tokens=8)
    jeng, teng = JServeEngine(jm, jp, **kw), ServeEngine(m, p, **kw)
    for r in reqs:
        jeng.submit(JRequest(*r))
        teng.submit(Request(*r))
    for _ in range(3):
        jeng.step()
        teng.step()
    jex, tex = jeng.executor, teng.executor
    # carry the reference's cache across, so every comparison is exact
    for (path, t), (_, j) in zip(leaves_with_paths(tex.cache),
                                 leaves_with_paths(jax.device_get(jex.cache))):
        t.copy_(torch.from_numpy(np.array(j)))
    assert tex.page_payload_elems == jex.page_payload_elems
    assert str(tex.page_payload_dtype).endswith(
        str(jex.page_payload_dtype))
    pages = teng.slot_pages[1] + teng.slot_pages[0][:2]
    assert pages == jeng.slot_pages[1] + jeng.slot_pages[0][:2]
    np.testing.assert_array_equal(
        tex.gather_page_payloads(pages).numpy(),
        np.asarray(jex.gather_page_payloads(pages)))
    fresh = rng.standard_normal((2, tex.page_payload_elems)).astype(
        np.float32)
    free = teng.pool._free[:2]
    assert free == jeng.pool._free[:2]
    tex.scatter_page_payloads(free, _t(fresh))
    jex.scatter_page_payloads(free, jnp.asarray(fresh))
    np.testing.assert_array_equal(tex.gather_page_payloads(free).numpy(),
                                  fresh)
    tex.map_slot(2, [free[0], free[1]] + teng.slot_pages[2][2:], 11)
    jex.map_slot(2, [free[0], free[1]] + jeng.slot_pages[2][2:], 11)
    tex.set_pages_hot([free[1]], False)
    jex.set_pages_hot([free[1]], False)
    _assert_caches_equal(tex.cache, jex.cache, "after scatter + map_slot")


def _run(model, params, reqs, engine, req_cls, **kw):
    eng = engine(model, params, n_slots=4, max_seq=64, **kw)
    for r in reqs:
        eng.submit(req_cls(*r))
    done = {c.rid: c.tokens for c in eng.run(max_ticks=600, strict=True)}
    return done, eng


@pytest.mark.parametrize("page_tokens", [8, 16])
def test_tiered_decode_matches_dense_paged_and_reference(models,
                                                         page_tokens):
    """Greedy tokens of the tiered engine equal the dense engine's, the
    all-HBM paged engine's and the reference tiered engine's, with more
    live sequences than HBM alone backs; demotions and promotions equal
    the reference's; no stale drop; both tiers drain and conserve."""
    jm, jp, cfg, m, p = models
    rng = np.random.RandomState(3)
    reqs = [(i, rng.randint(0, cfg.vocab, size=5 + 2 * i), 6)
            for i in range(6)]
    pps = 64 // page_tokens
    tiers = (2 * pps, 4 * pps)
    dense, _ = _run(m, p, reqs, ServeEngine, Request)
    hbm, e_hbm = _run(m, p, reqs, ServeEngine, Request, paged_kv=True,
                      page_tokens=page_tokens, kv_pages=2 * pps)
    tier, e = _run(m, p, reqs, ServeEngine, Request, paged_kv=True,
                   page_tokens=page_tokens, kv_pages=tiers)
    jtier, je = _run(jm, jp, reqs, JServeEngine, JRequest, paged_kv=True,
                     page_tokens=page_tokens, kv_pages=tiers)
    assert hbm == dense and tier == dense and tier == jtier
    s, js = e.stats(), je.stats()
    for key in ("demotions", "promotions", "max_live", "ticks",
                "tier_stale_drops", "host_pages", "cold_slots"):
        assert s[key] == js[key], key
    assert s["demotions"] > 0 and s["promotions"] > 0
    assert s["tier_stale_drops"] == 0
    assert s["max_live"] >= 2 * e_hbm.stats()["max_live"]
    assert e.pool.n_free == e.pool.n_pages
    assert e.pool.host.n_free == e.pool.host.capacity
    assert not e.tier.pool.live.any()
    e.pool.check_conservation()


def test_tiered_decode_with_cow_prefix_sharing(models):
    """COW prefix sharing stacked on tiering (sharing dissolves at
    demotion): tokens equal dense and the reference's; the tier counters
    equal the reference's."""
    jm, jp, cfg, m, p = models
    rng = np.random.RandomState(7)
    base = rng.randint(0, cfg.vocab, size=16)
    reqs = []
    for i in range(4):
        tail = rng.randint(0, cfg.vocab, size=3 * i)
        prompt = np.concatenate([base, tail]) if i else base.copy()
        reqs.append((10 + i, prompt, 5))
    kw = dict(paged_kv=True, page_tokens=16, prefix_share=True,
              kv_pages=(8, 16))
    dense, _ = _run(m, p, reqs, ServeEngine, Request)
    tier, e = _run(m, p, reqs, ServeEngine, Request, **kw)
    jtier, je = _run(jm, jp, reqs, JServeEngine, JRequest, **kw)
    assert tier == dense == jtier
    s, js = e.stats(), je.stats()
    for key in ("demotions", "promotions", "pages_shared", "cow_copies"):
        assert s[key] == js[key], key
    assert s["pages_shared"] > 0 and s["demotions"] > 0
    assert s["tier_stale_drops"] == 0
    e.pool.check_conservation()


def test_tiered_admission_requeues_instead_of_deadlocking(models):
    """More submissions than the whole hierarchy holds: excess requests
    wait in the queue and the engine drains everything, tokens equal
    dense."""
    jm, jp, cfg, m, p = models
    rng = np.random.RandomState(11)
    reqs = [(i, rng.randint(0, cfg.vocab, size=4), 4) for i in range(8)]
    done, e = _run(m, p, reqs, ServeEngine, Request, paged_kv=True,
                   page_tokens=16, kv_pages=(4, 8))   # 3 sequences at most
    dense, _ = _run(m, p, reqs, ServeEngine, Request)
    assert sorted(done) == list(range(8)) and done == dense
    assert all(len(t) == 4 for t in done.values())
    assert e.stats()["tier_stale_drops"] == 0
    assert e.stats()["max_live"] <= 3
    e.pool.check_conservation()


def test_kv_pages_tuple_validation(models):
    *_, m, p = models
    with pytest.raises(ValueError, match="kv_pages"):
        ServeEngine(m, p, n_slots=2, max_seq=64, paged_kv=True,
                    page_tokens=16, kv_pages=(2, 8))   # hbm < pages_per_slot
    with pytest.raises(ValueError, match="host"):
        ServeEngine(m, p, n_slots=2, max_seq=64, paged_kv=True,
                    page_tokens=16, kv_pages=(4, 2))   # host < pages_per_slot
    with pytest.raises(ValueError, match="host pages must be >= 0"):
        ServeEngine(m, p, n_slots=2, max_seq=64, paged_kv=True,
                    page_tokens=16, kv_pages=(4, -1))
    eng = ServeEngine(m, p, n_slots=2, max_seq=64, paged_kv=True,
                      page_tokens=16, kv_pages=(4, 0))  # no host tier
    assert not eng.tiered and "demotions" not in eng.stats()
