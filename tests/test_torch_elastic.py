"""Parity of the port's elastic runtime (``repro_torch.ft``) with the JAX
package's: fault scripts (parsed, rejected, and random scripts drawn from
the same seeds), the injector, the controller's lifecycle transition for
transition, ``shrink_topology``, eviction dropping exactly the dying
topology's cached plans, ``migrate_pages`` through memory handles (no stale
read; a freed victim page reads zeros, counted), ticket claims released on
eviction, and ``ElasticServing`` draining a faulted run to the tokens of the
JAX engine's run of the same script on ``tiny_config("qwen3-4b")`` at
float32 with the reference's parameters (``params_from_jax``), also on the
tiered engine with no stale tier read.  The meshless cases of the
reference's ``tests/test_elastic.py``; every comparison is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.core import rma as J
from repro.ft import elastic as jel
from repro.ft import inject as jinj
from repro.ft import straggler as jstr
from repro.models import build_model as j_build_model
from repro.serve import paged as jpaged
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.core import rma as T
from repro_torch.core.rma import plan as tplan
from repro_torch.core.rma.collectives import all_reduce_plan
from repro_torch.ft import elastic as tel
from repro_torch.ft import inject as tinj
from repro_torch.ft import straggler as tstr
from repro_torch.ft.elastic import (EVICTED, HEALTHY, MIGRATION_STREAM,
                                   QUARANTINED, REJOINED, SUSPECT,
                                   ElasticController, ElasticServing,
                                   migrate_pages, shrink_topology)
from repro_torch.ft.inject import Fault, FaultInjector, FaultScript
from repro_torch.models import build_model
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import Scheduler

CPU = "cpu"


def _faults(script):
    return [(f.tick, f.kind, f.worker, f.magnitude) for f in script]


# ---------------------------------------------------------------------------
# fault scripts + injector
# ---------------------------------------------------------------------------

def test_fault_script_parse_matches_reference():
    spec = "dead:3@10,slow:1@4x6,bell:2@7,rejoin:3@12,slow_step:2@1"
    s = FaultScript.parse(spec)
    assert _faults(s) == _faults(jinj.FaultScript.parse(spec))
    assert [(f.kind, f.worker, f.tick) for f in s][:4] == [
        ("slow_step", 2, 1), ("slow_step", 1, 4), ("lost_doorbell", 2, 7),
        ("dead_worker", 3, 10)]
    assert s.at(4)[0].magnitude == 6.0 and s.at(1)[0].magnitude == 4.0
    assert s.horizon == 12 and len(s) == 5


def test_fault_script_parse_rejects_garbage():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultScript.parse("explode:1@2")
    with pytest.raises(ValueError, match="bad fault spec"):
        FaultScript.parse("dead-3-10")
    with pytest.raises(ValueError, match="magnitude"):
        Fault(1, "slow_step", 0, magnitude=0.5)
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault(1, "meteor", 0)
    with pytest.raises(ValueError, match=">= 0"):
        Fault(-1, "dead_worker", 0)


@pytest.mark.parametrize("seed", [0, 7, 42, 1234])
def test_random_scripts_equal_the_reference(seed):
    """Same seed, same script as the JAX package's, any process; rank 0
    protected, at most one dead_worker a rank."""
    for kw in (dict(n_workers=4, n_faults=5), dict(n_workers=2, n_faults=3,
                                                   max_tick=8)):
        got = FaultScript.random(seed, **kw)
        assert _faults(got) == _faults(jinj.FaultScript.random(seed, **kw))
        assert _faults(got) == _faults(FaultScript.random(seed, **kw))
        assert all(f.worker != 0 for f in got)
        dead = [f.worker for f in got if f.kind == "dead_worker"]
        assert len(dead) == len(set(dead))


def test_injector_matches_reference():
    spec = "slow:1@1x4,dead:2@2,rejoin:2@4,bell:1@3"
    ours = FaultInjector(FaultScript.parse(spec), base_step=1.0)
    ref = jinj.FaultInjector(jinj.FaultScript.parse(spec), base_step=1.0)
    for _ in range(6):
        assert _faults(ours.advance()) == _faults(ref.advance())
        assert ours.durations(3) == ref.durations(3)
        assert ours.lost_bells == ref.lost_bells
        assert ours.dead == ref.dead and ours.slow == ref.slow
    assert ours.alive(2) and ours.duration(2) == 1.0
    assert ours.durations(3)[1] == 4.0, "slow persists until cleared"


# ---------------------------------------------------------------------------
# controller lifecycle
# ---------------------------------------------------------------------------

def _controller(mod, smod, n=4, **kw):
    kw.setdefault("monitor", smod.StragglerMonitor(
        threshold=2.0, warmup_steps=2, escalate_after=2))
    return mod.ElasticController(n, **kw)


def _edges(c):
    return [(t.worker, t.frm, t.to, t.tick, t.reason) for t in c.transitions]


def _drive(c, steps):
    """Feed step times, faults and ticks: ``steps`` is a list of
    (tick, {worker: duration}, [faults], rejoins)."""
    for tick, durs, faults, rejoins in steps:
        for f in faults:
            c.apply_fault(f, tick)
        for w, d in durs.items():
            c.observe_step(w, d, tick)
        for w in rejoins:
            c.rejoin(w)
        c.advance(tick)


def _lifecycle_steps(fault_cls):
    steps = [(t, {w: 1.0 for w in range(4)}, [], []) for t in range(4)]
    steps += [(t, {0: 1.0, 1: 1.0, 2: 5.0, 3: 1.0}, [], []) for t in range(4, 9)]
    steps += [(9, {0: 1.0, 1: 1.0, 3: 1.0}, [fault_cls(9, "lost_doorbell", 3)],
               [])]
    steps += [(10, {0: 1.0, 1: 1.0}, [fault_cls(10, "dead_worker", 1),
                                      fault_cls(10, "lost_doorbell", 3)], [])]
    steps += [(11, {0: 1.0}, [], [2])]
    steps += [(t, {0: 1.0, 2: 1.0}, [], []) for t in range(12, 16)]
    return steps


def test_controller_lifecycle_equals_reference():
    """One script of slow steps, lost doorbells, a death and a rejoin
    through both controllers: the same transitions (worker, from, to,
    tick, reason), recovery reports, topologies and stats."""
    ours = _controller(tel, tstr, suspect_strikes=2, quarantine_grace=1)
    ref = _controller(jel, jstr, suspect_strikes=2, quarantine_grace=1)
    _drive(ours, _lifecycle_steps(Fault))
    _drive(ref, _lifecycle_steps(jinj.Fault))
    assert _edges(ours) == _edges(ref)
    assert [s for w, _, s, _, _ in _edges(ours) if w == 2] == [
        SUSPECT, QUARANTINED, EVICTED, REJOINED, HEALTHY]
    for a, b in zip(ours.reports, ref.reports):
        assert (a.worker, a.tick, a.reason, a.requeued, a.migration,
                a.plans_rebuilt) == (b.worker, b.tick, b.reason, b.requeued,
                                     b.migration, b.plans_rebuilt)
        assert repr(a.old_topology) == repr(b.old_topology)
        assert repr(a.new_topology) == repr(b.new_topology)
    assert len(ours.reports) == len(ref.reports) >= 3
    so, sr = ours.stats(), ref.stats()
    for key in ("topology", "workers", "states", "transitions", "evictions",
                "rejoins"):
        assert so[key] == sr[key], key
    assert ours.serving() == ref.serving() and ours.alive() == ref.alive()


def test_dead_worker_skips_grace_and_reports():
    requeued, migrated = [], []
    c = _controller(
        tel, tstr,
        on_evict=lambda w: requeued.append(w) or 3,
        migrate=lambda w, topo: migrated.append((w, topo)) or
        {"pages": 4, "peers": 1})
    rep = c.apply_fault(Fault(5, "dead_worker", 1), 5)
    assert c.state_of(1) == EVICTED
    assert rep.reason == "dead_worker" and rep.requeued == 3
    assert rep.migration == {"pages": 4, "peers": 1}
    assert rep.old_topology == T.Topology.flat(4)
    assert rep.new_topology == T.Topology.flat(3)
    assert requeued == [1] and migrated[0][0] == 1
    assert c.apply_fault(Fault(6, "dead_worker", 1), 6) is None


def test_rejoin_probation_and_monitor_reset():
    c = _controller(tel, tstr, suspect_strikes=1, quarantine_grace=0,
                    probation=2)
    src = ElasticController.source_of(1)
    for t in range(4):
        for w in range(4):
            c.observe_step(w, 1.0, t)
    for t in range(4, 8):
        c.observe_step(1, 9.0, t)
        c.advance(t)
        if c.state_of(1) == EVICTED:
            break
    assert c.state_of(1) == EVICTED
    assert c.monitor.offenders.get(src, 0) >= 2
    rep = c.rejoin(1)
    assert c.state_of(1) == REJOINED
    assert rep.new_topology == T.Topology.flat(4)
    assert c.monitor.offenders.get(src, 0) == 0
    assert all(e.source != src for e in c.monitor.events)
    assert c.monitor.ema == pytest.approx(1.0)
    for t in range(10, 13):
        for w in range(4):
            c.observe_step(w, 1.0, t)
        c.advance(t)
    assert c.state_of(1) == HEALTHY
    assert c.rejoin(0) is None


def test_controller_guards():
    with pytest.raises(ValueError, match="n_workers >= 2"):
        ElasticController(1)
    with pytest.raises(ValueError, match="declares"):
        ElasticController(4, topology=T.Topology(2, 4))


# ---------------------------------------------------------------------------
# topology shrink + plan-cache invalidation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo,alive,evicted", [
    ((4, 2), 6, [2, 3]), ((4, 2), 4, [0, 1, 6, 7]), ((4, 2), 7, [5]),
    ((8, 1), 7, [3]), ((2, 4), 4, [4, 5, 6, 7])])
def test_shrink_topology_matches_reference(topo, alive, evicted):
    got = shrink_topology(T.Topology(*topo), alive, evicted)
    want = jel.shrink_topology(J.Topology(*topo), alive, evicted)
    assert (got.hosts, got.local) == (want.hosts, want.local)
    assert got.fingerprint() == want.fingerprint()
    with pytest.raises(ValueError):
        shrink_topology(T.Topology(2, 1), 0, [0, 1])


def test_eviction_recompiles_only_affected_plans():
    """Two cached ring plans under different declared topologies: evicting
    a worker drops exactly the dying fingerprint's entry; the other is
    still served from cache, and the rebuild hook restores the survivor
    mesh's plan."""
    topo_a, topo_b = T.Topology(6, 1), T.Topology(3, 2)
    p_a = all_reduce_plan("x", 6, (8,), torch.float32, topology=topo_a)
    p_b = all_reduce_plan("x", 6, (8,), torch.float32, topology=topo_b)
    rebuilt = []

    def rebuild(new_topo, dropped):
        rebuilt.append(all_reduce_plan("x", new_topo.axis_size, (8,),
                                       torch.float32, topology=new_topo))
        return 1

    c = ElasticController(6, topology=topo_a, rebuild=rebuild)
    rep = c.apply_fault(Fault(1, "dead_worker", 5), 1)
    assert list(rep.plans_dropped) == ["ring_collectives"]
    assert all(topo_a.fingerprint() in k
               for k in rep.plans_dropped["ring_collectives"])
    assert rep.plans_rebuilt == 1 and rebuilt
    assert rep.dropped_count == len(rep.plans_dropped["ring_collectives"])
    assert all_reduce_plan("x", 6, (8,), torch.float32,
                           topology=topo_b) is p_b
    assert all_reduce_plan("x", 6, (8,), torch.float32,
                           topology=topo_a) is not p_a
    assert "ring_collectives" in c.stats()["plan_caches"]


def test_registry_reports_dropped_keys_per_cache():
    cache = tplan.register_plan_cache("test_scratch", {})
    fp = T.Topology(97, 1).fingerprint()
    cache[("a", fp)] = "x"
    cache[("b", None)] = "y"
    dropped = tplan.invalidate_topology(fp)
    assert dropped.get("test_scratch") == [("a", fp)]
    assert cache == {("b", None): "y"}
    assert "test_scratch" in tplan.plan_cache_stats()
    with pytest.raises(ValueError, match="ambiguous"):
        tplan.invalidate_topology(None)


# ---------------------------------------------------------------------------
# KV-page migration through memory handles
# ---------------------------------------------------------------------------

SPEC = dict(page_tokens=2, kv_heads=1, head_dim=2, n_pages=5)


def _page(v):
    return np.full((1, 2, 2, 1, 2), v, np.float32)


def test_migrate_pages_matches_reference_with_no_stale_reads():
    """The reference's single-rank migration (perm ((0, 0),)) on both
    packages: the pool, handles and err_count equal; the payloads moved
    and no stale drop."""
    def jrun(p0, p1):
        pool = jpaged.PagedKVWindow.create(jpaged.PageSpec(**SPEC), "x", 1,
                                           jnp.float32)
        for p in (0, 1, 2, 3):
            pool = pool.alloc_page(p)
        pool = pool.write_page_local(0, p0).write_page_local(1, p1)
        pool, n = jel.migrate_pages(pool, [(0, 2), (1, 3)], ((0, 0),))
        return pool.window.buffer, pool.handles, pool.err_count, n

    want = jax.tree_util.tree_map(np.asarray, jax.vmap(jrun, axis_name="x")(
        jnp.asarray(_page(3.0)), jnp.asarray(_page(7.0))))
    pool = tpaged.PagedKVWindow.create(tpaged.PageSpec(**SPEC), "x", 1,
                                       torch.float32, device=CPU)
    for p in (0, 1, 2, 3):
        pool.alloc_page(p)
    pool.write_page_local(0, torch.from_numpy(_page(3.0)))
    pool.write_page_local(1, torch.from_numpy(_page(7.0)))
    pool, n = migrate_pages(pool, [(0, 2), (1, 3)], ((0, 0),))
    for g, w in zip((pool.window.buffer, pool.handles, pool.err_count, n),
                    want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert n == 2 and (pool.read_page(2) == 3.0).all()
    assert (pool.read_page(3) == 7.0).all()
    assert pool.err_count.tolist() == [0]
    assert pool.window.ledger.total == 2 * 2 + 2
    queued = dict(pool.window.ledger.by_kind)
    same, n0 = migrate_pages(pool, [], ((0, 0),))
    assert n0 == 0 and same is pool
    assert dict(pool.window.ledger.by_kind) == queued
    assert MIGRATION_STREAM == jel.MIGRATION_STREAM == 2


def test_freed_victim_page_reads_zero_and_counted_after_migration():
    """Sources freed *after* migration, so a read still racing the eviction
    hits the epoch bump: zeroed and counted, never the reused bytes."""
    pool = tpaged.PagedKVWindow.create(tpaged.PageSpec(**SPEC), "x", 1,
                                       torch.float32, device=CPU)
    pool.alloc_page(0).alloc_page(2)
    pool.write_page_local(0, torch.from_numpy(_page(5.0)))
    migrate_pages(pool, [(0, 2)], ((0, 0),))
    stale_handle = pool.handles[:, 0].clone()
    pool.free_page(0)
    pool.alloc_page(0)                    # the slot is reused...
    pool.write_page_local(0, torch.from_numpy(_page(9.0)))
    mhw = T.win_from_memhandle(pool.window, stale_handle)
    _, data = mhw.get(((0, 0),), offset=0,
                      size=tpaged.PageSpec(**SPEC).page_elems)
    assert not data.any(), "stale read must be zeroed"
    assert mhw.err_count.tolist() == [1], "and counted"
    assert (pool.read_page(2) == 5.0).all()
    assert (pool.read_page(0) == 9.0).all()


# ---------------------------------------------------------------------------
# scheduler ticket claims (released on eviction)
# ---------------------------------------------------------------------------

def test_ticket_claims_price_the_window_and_release_on_eviction():
    s = Scheduler(4, "continuous")
    assert s.ticket_window(live=0) == 4
    s.note_claims(2, source="worker1")
    s.note_claims(1, source="worker2")
    assert s.outstanding_claims() == 3
    assert s.ticket_window(live=0) == 1, "outstanding claims hold slots"
    assert s.consume_claims(1, source="worker1") == 1
    assert s.ticket_window(live=1) == 1
    assert s.release_claims("worker1") == 1
    assert s.ticket_window(live=1) == 2
    assert s.outstanding_claims("worker1") == 0
    assert s.release_claims("worker1") == 0
    assert s.consume_claims(5, source="worker2") == 1
    assert s.outstanding_claims() == 0
    assert s.stats()["outstanding_claims"] == {}


# ---------------------------------------------------------------------------
# ElasticServing: the engine drained to the reference's tokens
# ---------------------------------------------------------------------------

_ENGINE_KW = dict(n_slots=4, max_seq=32, paged_kv=True, page_tokens=8)
SCRIPT = "dead:1@2"


@pytest.fixture(scope="module")
def serving():
    """The port's model with the reference's parameters, the requests, and
    the JAX engine's tokens and stats for :data:`SCRIPT` (the one JAX
    engine run of this file)."""
    jcfg = j_tiny_config("qwen3-4b")
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = tiny_config("qwen3-4b")
    m = build_model(cfg)
    p = params_from_jax(jax.device_get(jp), cfg, device=CPU)
    rng = np.random.RandomState(0)
    reqs = [(i, rng.randint(0, cfg.vocab, size=6), 4) for i in range(6)]
    jeng = JServeEngine(jm, jp, **_ENGINE_KW)
    for r in reqs:
        jeng.submit(JRequest(*r))
    jes = jel.ElasticServing(jeng, jinj.FaultScript.parse(SCRIPT),
                             n_workers=2)
    jdone = {c.rid: c.tokens for c in jes.run(300)}
    base = _engine(m, p, reqs)
    baseline = {c.rid: c.tokens for c in base.run()}
    return m, p, reqs, jdone, jes.stats(), baseline


def _engine(m, p, reqs, **overrides):
    eng = ServeEngine(m, p, **{**_ENGINE_KW, **overrides})
    for r in reqs:
        eng.submit(Request(*r))
    return eng


def test_elastic_serving_dead_worker_equals_reference(serving):
    """The JAX engine's elastic run of the same script: tokens bit for bit,
    the fault-free run's tokens too, worker 1 evicted, its slots offline,
    the pool conserved and no claim outstanding."""
    m, p, reqs, jdone, jstats, baseline = serving
    eng = _engine(m, p, reqs)
    es = ElasticServing(eng, FaultScript.parse(SCRIPT), n_workers=2)
    done = {c.rid: c.tokens for c in es.run(300)}
    assert done == jdone == baseline
    st = es.stats()
    for key in ("evictions", "offline_slots", "ticks", "completed",
                "faults_injected"):
        assert st[key] == jstats[key], key
    assert st["elastic"]["workers"] == jstats["elastic"]["workers"]
    assert st["elastic"]["transitions"] == jstats["elastic"]["transitions"]
    assert st["evictions"] >= 1 and st["offline_slots"] == 2
    assert st["elastic"]["workers"][1] == EVICTED
    assert eng.scheduler.outstanding_claims() == 0
    eng.pool.check_conservation()
    assert eng.pool.n_free == eng.pool.n_pages


def test_elastic_serving_tiered_eviction_no_stale_reads(serving):
    """Eviction on the tiered engine: the drain equals the fault-free
    tokens and no tier read lands on a freed host slot."""
    m, p, reqs, _, _, baseline = serving
    eng = _engine(m, p, reqs, kv_pages=(8, 16))
    es = ElasticServing(eng, FaultScript.parse("dead:1@3"), n_workers=2)
    done = {c.rid: c.tokens for c in es.run(500)}
    assert done == baseline
    assert es.stats()["tier_stale_drops"] == 0
    eng.pool.check_conservation()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_script_sweep_conserves_pages_and_tokens(serving, seed):
    """A random script of slow / dead / doorbell faults against worker 1:
    the run drains every request to the fault-free tokens, the pool
    conserves, rank 0 stays healthy and no state is left inconsistent."""
    m, p, reqs, _, _, baseline = serving
    script = FaultScript.random(seed, n_workers=2, n_faults=3, max_tick=8)
    eng = _engine(m, p, reqs)
    es = ElasticServing(eng, script, n_workers=2)
    done = {c.rid: c.tokens for c in es.run(500)}
    assert done == baseline
    eng.pool.check_conservation()
    states = es.controller.stats()["workers"]
    assert states[0] == HEALTHY
    assert all(s in (HEALTHY, SUSPECT, QUARANTINED, EVICTED)
               for s in states.values())


def test_elastic_serving_needs_even_slots():
    with pytest.raises(ValueError, match="divide evenly"):
        ElasticServing(type("E", (), {"n_slots": 3})(), FaultScript(),
                       n_workers=2)
