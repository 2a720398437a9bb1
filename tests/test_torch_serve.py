"""Parity of the port's serving path with the JAX package, on
``tiny_config("qwen3-4b")`` at float32 with the reference's parameters
carried over by ``params_from_jax``: prefill and decode logits, the
engines' greedy tokens (dense, paged, paged with copy-on-write prefix
sharing, and the MoE family), the scheduler's admission order, the KV pool's refcounts, forks,
debt and conservation, the paged layout leaf for leaf, and the dropped
scatters.  Inputs are numpy arrays from a seed, handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.models import attention as j_attention
from repro.models import build_model as j_build_model
from repro.serve.disagg import paginate_cache as j_paginate_cache
from repro.serve.disagg import park_slot as j_park_slot
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.paged import KVPoolManager as JKVPoolManager
from repro.serve.scheduler import Scheduler as JScheduler

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import COUNTER as K7
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import attention, build_model
from repro_torch.serve.disagg import paginate_cache, park_slot
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged import KVPoolManager
from repro_torch.serve.scheduler import POLICIES, Scheduler
from repro_torch.tree import leaves_with_paths, tree_map

#: float32 logits: the two packages differ only in summation order
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny_config("qwen3-4b")
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = tiny_config("qwen3-4b")
    m = build_model(cfg)
    p = params_from_jax(jax.device_get(jp), cfg, device=CPU)
    return jcfg, jm, jp, cfg, m, p


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# model: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_logits_match_reference(models, paged):
    """Prefill (through K7's plain version) and three decode steps: the
    logits and the written caches agree with the JAX package's."""
    jcfg, jm, jp, cfg, m, p = models
    B, S, S_max, pt = 2, 11, 32, 8
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (B, S))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                        jm.init_cache(B, S_max))
    before = K7.count
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)},
                       m.init_cache(B, S_max, device=CPU))
    assert K7.count == before
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    if paged:
        # re-page both prefilled caches identically: row r on pages
        # r·ppr … (r+1)·ppr − 1 (the contiguous pool order)
        ppr = S_max // pt
        jc, tc = j_paginate_cache(jc, pt), paginate_cache(tc, pt)
        table = np.arange(B * ppr, dtype=np.int32).reshape(B, ppr)
        jblk, tblk = jc["scan"]["l0"]["attn"], tc["scan"]["l0"]["attn"]
        jblk["page_table"] = jnp.broadcast_to(
            jnp.asarray(table), jblk["page_table"].shape)
        tblk["page_table"][:] = torch.from_numpy(table)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1))
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL,
                                   err_msg=f"decode step {step}")
    for (path, t), (_, j) in zip(leaves_with_paths(tc),
                                 leaves_with_paths(jax.device_get(jc))):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5,
                                   err_msg=str(path))


def test_cache_layout_and_specs_match_reference(models):
    jcfg, jm, jp, cfg, m, p = models
    jc = jax.device_get(jm.init_cache(3, 16))
    tc = m.init_cache(3, 16, device=CPU)
    for name, c in (("dense", (jc, tc)),
                    ("paged", (jax.device_get(j_paginate_cache(jc, 4)),
                               paginate_cache(tc, 4)))):
        jl, tl = leaves_with_paths(c[0]), leaves_with_paths(c[1])
        assert [q for q, _ in jl] == [q for q, _ in tl], name
        for (path, j), (_, t) in zip(jl, tl):
            assert _np(t).dtype == np.asarray(j).dtype, (name, path)
            np.testing.assert_array_equal(_np(t), np.asarray(j),
                                          err_msg=f"{name} {path}")
    spec = jax.tree.map(list, jm.cache_specs(),
                        is_leaf=lambda x: isinstance(x, tuple))
    assert jax.tree.map(list, m.cache_specs(),
                        is_leaf=lambda x: isinstance(x, tuple)) == spec
    direct = attention.init_paged_gqa_cache(cfg, 2, 16, torch.float32, CPU, 4)
    jdirect = j_attention.init_paged_gqa_cache(jcfg, 2, 16, jnp.float32, 4)
    for key in jdirect:
        np.testing.assert_array_equal(_np(direct[key]),
                                      np.asarray(jdirect[key]))
    # park_slot: table row → the parking page, position rewound
    paged = paginate_cache(m.init_cache(3, 16, device=CPU), 4)
    jpaged = j_paginate_cache(jm.init_cache(3, 16), 4)
    blk, jblk = paged["scan"]["l0"]["attn"], jpaged["scan"]["l0"]["attn"]
    blk["page_table"][:] = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    blk["pos"][:] = 7
    jpaged["scan"]["l0"]["attn"] = dict(
        jblk, page_table=jnp.broadcast_to(jnp.arange(12).reshape(3, 4),
                                          jblk["page_table"].shape
                                          ).astype(jnp.int32),
        pos=jnp.full_like(jblk["pos"], 7))
    park_slot(paged, 1)
    jpaged = j_park_slot(jpaged, 1)
    for (path, t), (_, j) in zip(leaves_with_paths(paged),
                                 leaves_with_paths(jax.device_get(jpaged))):
        np.testing.assert_array_equal(_np(t), np.asarray(j), str(path))


# ---------------------------------------------------------------------------
# attention: dropped scatters (the JAX scatter drops out-of-range ids)
# ---------------------------------------------------------------------------

def _attn_params(cfg, jcfg, key=1):
    jparams = j_attention.init_gqa(jax.random.PRNGKey(key), jcfg)
    return jparams, tree_map(_t, jax.device_get(jparams))


def _decode_x(cfg, B, S=1, seed=0):
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_paged_decode_drops_overflow_writes_like_dense(models):
    jcfg, _, _, cfg, _, _ = models
    B, S, pt = 1, 8, 4
    _, params = _attn_params(cfg, jcfg)
    paged = attention.init_paged_gqa_cache(cfg, B, S, torch.float32, CPU, pt)
    paged["page_table"][0] = torch.arange(S // pt, dtype=torch.int32)
    paged["k_pages"] += 3.0
    paged["v_pages"] += 3.0
    paged["pos"][:] = S
    base = {k: v.clone() for k, v in paged.items()}
    _, x = _decode_x(cfg, B)
    attention.gqa_attention(params, x, cfg, positions=torch.full((B, 1), S),
                            cache=paged)
    assert torch.equal(paged["k_pages"], base["k_pages"])
    assert torch.equal(paged["v_pages"], base["v_pages"])
    assert paged["pos"].tolist() == [S + 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_drops_writes_to_ro_pages(models, dtype):
    """A write-protected (shared) page drops decode scatters aimed at it
    while the gather still reads it."""
    jcfg, _, _, cfg, _, _ = models
    B, S, pt = 1, 8, 4
    _, params = _attn_params(cfg, jcfg)
    base = attention.init_paged_gqa_cache(cfg, B, S, dtype, CPU, pt)
    base["page_table"][0] = torch.arange(S // pt, dtype=torch.int32)
    _, x = _decode_x(cfg, B)
    positions = torch.zeros((B, 1), dtype=torch.int64)
    ro = {k: v.clone() for k, v in base.items()}
    ro["page_ro"][0] = True
    attention.gqa_attention(params, x, cfg, positions=positions, cache=ro)
    assert torch.equal(ro["k_pages"], base["k_pages"])
    rw = {k: v.clone() for k, v in base.items()}
    attention.gqa_attention(params, x, cfg, positions=positions, cache=rw)
    assert not torch.equal(rw["k_pages"], base["k_pages"])


@pytest.mark.parametrize("pos", [6, 8, 10])
def test_dense_writes_past_the_end_drop_like_reference(models, pos):
    """Three new tokens at ``pos`` of an 8-token dense cache: the writes
    past the end are dropped (straddling the end at 6, all of them at 8 and
    10) and the cache and output equal the JAX package's."""
    jcfg, _, _, cfg, _, _ = models
    B, S_max, S = 2, 8, 3
    jparams, params = _attn_params(cfg, jcfg)
    rng = np.random.default_rng(pos)
    k0 = rng.standard_normal((B, S_max, cfg.n_kv_heads, cfg.head_dim)
                             ).astype(np.float32)
    v0 = rng.standard_normal(k0.shape).astype(np.float32)
    posv = np.array([pos, 2], np.int32)
    jx, x = _decode_x(cfg, B, S, seed=pos)
    positions = posv[:, None] + np.arange(S)[None]
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
              "pos": jnp.asarray(posv)}
    jout, jnew = j_attention.gqa_attention(jparams, jx, jcfg,
                                           positions=jnp.asarray(positions),
                                           cache=jcache)
    cache = {"k": _t(k0), "v": _t(v0), "pos": _t(posv)}
    out = attention.gqa_attention(params, x, cfg,
                                  positions=torch.from_numpy(positions),
                                  cache=cache)
    np.testing.assert_array_equal(_np(cache["pos"]), np.asarray(jnew["pos"]))
    written = np.zeros((B, S_max), bool)
    for r in range(B):
        written[r, posv[r]:posv[r] + S] = True
    for key, old in (("k", k0), ("v", v0)):
        got = _np(cache[key])
        np.testing.assert_allclose(got, np.asarray(jnew[key]), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
        assert np.array_equal(got[~written], old[~written]), key
        assert not np.array_equal(got[written], old[written]), key
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# engine: greedy tokens equal the JAX engine's
# ---------------------------------------------------------------------------

def _requests(vocab):
    """Two prompts sharing a 2-page prefix, two identical prompts (a COW
    fork on their first decode write), one unrelated — three prompt
    lengths, so the reference compiles its prefill three times."""
    rng = np.random.RandomState(24)
    pre = rng.randint(0, vocab, size=8)
    same = rng.randint(0, vocab, size=11)
    prompts = [np.concatenate([pre, rng.randint(0, vocab, size=3)]),
               np.concatenate([pre, rng.randint(0, vocab, size=5)]),
               same, same.copy(), rng.randint(0, vocab, size=13)]
    return [(i, p, 3 + i % 3) for i, p in enumerate(prompts)]


MODES = {"dense": {}, "paged": dict(paged_kv=True, page_tokens=4),
         "prefix_share": dict(paged_kv=True, page_tokens=4,
                              prefix_share=True)}


@pytest.fixture(scope="module")
def reference_tokens(models):
    jcfg, jm, jp, cfg, m, p = models
    out = {}
    for mode, kw in MODES.items():
        eng = JServeEngine(jm, jp, n_slots=3, max_seq=32, **kw)
        for rid, prompt, n in _requests(cfg.vocab):
            eng.submit(JRequest(rid, prompt, n))
        out[mode] = ({c.rid: c.tokens for c in eng.run()}, eng.stats())
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_matches_reference(models, reference_tokens, mode):
    jcfg, jm, jp, cfg, m, p = models
    eng = ServeEngine(m, p, n_slots=3, max_seq=32, **MODES[mode])
    reqs = _requests(cfg.vocab)
    for rid, prompt, n in reqs:
        eng.submit(Request(rid, prompt, n))
    before = K7.count
    done = eng.run(strict=True)
    assert K7.count == before                # the plain version on the CPU
    want, jstats = reference_tokens[mode]
    assert {c.rid: c.tokens for c in done} == want
    assert {c.rid: c.tokens for c in done} == reference_tokens["dense"][0]
    st = eng.stats()
    for key in jstats:
        assert st.get(key, jstats[key]) == jstats[key], key
    if mode == "prefix_share":
        assert st["pages_shared"] > 0 and st["cow_copies"] >= 1
        eng.pool.check_conservation()
        assert eng.pool.n_free == eng.pool.n_pages


def test_moe_engine_greedy_matches_reference():
    """The MoE family serves through the same cache path: the paged
    engine's greedy tokens on ``tiny_config("llama4-maverick-400b-a17b")``
    equal the JAX engine's."""
    arch = "llama4-maverick-400b-a17b"
    jm = j_build_model(j_tiny_config(arch))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = tiny_config(arch)
    p = params_from_jax(jax.device_get(jp), cfg, device=CPU)
    rng = np.random.RandomState(0)
    reqs = [(i, rng.randint(0, cfg.vocab, size=9), 4) for i in range(3)]
    jeng = JServeEngine(jm, jp, n_slots=2, max_seq=32, paged_kv=True,
                        page_tokens=8)
    eng = ServeEngine(build_model(cfg), p, n_slots=2, max_seq=32,
                      paged_kv=True, page_tokens=8)
    for r in reqs:
        jeng.submit(JRequest(*r))
        eng.submit(Request(*r))
    assert {c.rid: c.tokens for c in eng.run(strict=True)} == \
        {c.rid: c.tokens for c in jeng.run()}


def test_engine_rejects_bad_configs(models):
    *_, m, p = models
    with pytest.raises(ValueError, match="prefix_share"):
        ServeEngine(m, p, n_slots=1, max_seq=32, prefix_share=True)
    with pytest.raises(ValueError, match="kv_pages"):
        ServeEngine(m, p, n_slots=2, max_seq=32, paged_kv=True,
                    page_tokens=8, kv_pages=2)
    with pytest.raises(ValueError, match="not divisible"):
        ServeEngine(m, p, n_slots=1, max_seq=20, paged_kv=True,
                    page_tokens=16)
    with pytest.raises(ValueError, match="host"):
        ServeEngine(m, p, n_slots=2, max_seq=32, paged_kv=True,
                    page_tokens=8, kv_pages=(4, 2))


def test_engine_evict_requeue_and_offline_slots(models, reference_tokens):
    """An evicted sequence re-prefills from its prompt and reproduces its
    tokens; offline slots take no work until they come back."""
    *_, cfg, m, p = models
    eng = ServeEngine(m, p, n_slots=3, max_seq=32, paged_kv=True,
                      page_tokens=4, prefix_share=True)
    for rid, prompt, n in _requests(cfg.vocab):
        eng.submit(Request(rid, prompt, n))
    eng.step()
    live = sorted(eng.slot_req)
    assert eng.evict_slots(live[:1]) == 1
    eng.set_slots_offline(live[:1])
    with pytest.raises(ValueError, match="evict_slots"):
        eng.set_slots_offline(live[1:2])
    eng.step()
    assert live[0] not in eng.slot_req
    eng.set_slots_offline(live[:1], offline=False)
    done = {c.rid: c.tokens for c in eng.run(strict=True)}
    assert done == reference_tokens["dense"][0]
    assert eng.stats()["evictions"] == 1
    eng.pool.check_conservation()


# ---------------------------------------------------------------------------
# scheduler and pool: pure Python, held to the reference op for op
# ---------------------------------------------------------------------------

class _R:
    def __init__(self, rid, priority=0, tenant=0):
        self.rid, self.priority, self.tenant = rid, priority, tenant


@pytest.mark.parametrize("policy", POLICIES)
def test_scheduler_selection_order_matches_reference(policy):
    rng = np.random.RandomState(7)
    port, ref = Scheduler(4, policy), JScheduler(4, policy)
    picked = {"port": [], "ref": []}
    for tick in range(12):
        for _ in range(rng.randint(0, 3)):
            rid = port.submitted
            r = _R(rid, priority=int(rng.randint(0, 3)),
                   tenant=int(rng.randint(0, 2)))
            port.submit(r, tick=tick)
            ref.submit(r, tick=tick)
        free, live = int(rng.randint(0, 4)), int(rng.randint(0, 2))
        for name, s in (("port", port), ("ref", ref)):
            got = s.select(free, live=live, tick=tick)
            if got and tick % 5 == 0:
                s.requeue(got[-1])
                got = got[:-1]
            picked[name].append([e.req.rid for e in got])
        assert port.stats() == ref.stats()
        assert port.ticket_window(live) == ref.ticket_window(live)
    assert picked["port"] == picked["ref"]
    assert any(picked["port"])
    with pytest.raises(ValueError, match="unknown policy"):
        Scheduler(2, "lifo")


def test_kv_pool_manager_mirrors_reference():
    """The reference's refcount, COW fork, debt and exhaustion cases."""
    pool = KVPoolManager(6)
    assert pool.alloc(3) == [0, 1, 2] and pool.n_free == 3
    pool.share_pages([0, 1])
    assert pool.refcount_of(0) == 2 and pool.shared_maps == 2
    assert set(pool.release([0, 1, 2])) == {0, 1, 2}
    assert pool.n_free == 4 and pool.refcount_of(0) == 1
    pool.release([0, 1])
    assert pool.n_free == 6 and pool.frees == 3
    with pytest.raises(ValueError, match=r"release\(2\).*double free"):
        pool.release([2])
    with pytest.raises(ValueError, match=r"share_pages\(5\)"):
        pool.share_pages([5])
    assert pool.alloc(6) == [3, 4, 5, 2, 0, 1]   # FIFO reuse order

    pool = KVPoolManager(4)
    [pg] = pool.alloc(1)
    pool.share_pages([pg], writable=True)
    assert pool.cow_debt == 1
    assert not pool.can_admit(3) and pool.can_admit(2)
    new, copied = pool.cow_write(pg)
    assert copied and new != pg
    assert pool.refcount_of(pg) == 1 and pool.refcount_of(new) == 1
    assert pool.cow_debt == 0 and pool.cow_copies == 1
    assert pool.cow_write(new) == (new, False)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(5)
    pool.check_conservation()

    pool = KVPoolManager(1)
    [pg] = pool.alloc(1)
    pool.share_pages([pg], writable=True)
    with pytest.raises(RuntimeError, match="fork"):
        pool.cow_write(pg)


def test_kv_pool_manager_random_ops_match_reference():
    """A random op sequence (alloc, share read-only and writable, fork,
    release, residency moves) leaves both pools in the same state."""
    rng = np.random.RandomState(3)
    port, ref = KVPoolManager(12, host_pages=6), JKVPoolManager(12, 6)
    held: list[int] = []                        # one entry per reference
    for _ in range(200):
        op = rng.randint(0, 6)
        pages = sorted(set(int(x) for x in rng.choice(held, 2))) \
            if held else []
        if op == 0 and port.can_admit(2):
            got = port.alloc(2)
            assert got == ref.alloc(2)
            held += got
        elif op in (1, 2) and pages:
            w = op == 2
            price = port.share_price(pages, writable=w)
            assert price == ref.share_price(pages, writable=w)
            if not port.can_admit(0, price):     # admission prices shares
                continue
            port.share_pages(pages, writable=w)
            ref.share_pages(pages, writable=w)
            held += pages
        elif op == 3 and pages and port.n_free > port.cow_debt:
            new = port.cow_write(pages[0])
            assert new == ref.cow_write(pages[0])
            held.remove(pages[0])               # one reference moved
            held.append(new[0])
        elif op == 4 and held:
            pg = held.pop(int(rng.randint(0, len(held))))
            assert port.release([pg]) == ref.release([pg])
        elif op == 5 and port.host.n_free:
            slots = port.alloc_cold(1)
            assert slots == ref.alloc_cold(1)
            for pool in (port, ref):
                pool.queue_promote(slots)
                pool.drain_promotes()
                pool.free_cold(slots)
        port.check_conservation()
        assert port.stats() == ref.stats()
        assert port._ref == ref._ref and port._free == ref._free
    assert port.cow_copies > 0 and port.shared_maps > 0


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_launcher_serves_on_the_cpu(capsys):
    done = serve_main(["--arch", "qwen3-4b", "--tiny", "--device", "cpu",
                       "--disagg", "--prefix-share", "--requests", "4",
                       "--max-seq", "64", "--prompt-len", "20",
                       "--shared-prefix-len", "16", "--max-new", "3"])
    assert sorted(c.rid for c in done) == [0, 1, 2, 3]
    assert all(c.finished and len(c.tokens) == 3 for c in done)
    out = capsys.readouterr().out
    assert "[disagg]   pages_landed: OK" in out and "'pages_shared': " in out


@pytest.mark.parametrize("extra", [["--disagg", "--dry-run"],
                                   ["--inject", "dead:1@4"]],
                         ids=["disagg-dry-run", "inject"])
def test_launcher_disagg_and_inject_modes_on_the_cpu(capsys, extra):
    """``--disagg --dry-run`` runs the round trip alone (the reference's
    seven checks and the port's ``no_stalls``, all OK); ``--inject`` drains
    every request through the elastic runtime with worker 1 evicted and its
    slots offline."""
    got = serve_main(["--arch", "qwen3-4b", "--device", "cpu",
                      "--requests", "4", "--max-new", "6", *extra])
    out = capsys.readouterr().out
    if "--dry-run" in extra:
        assert len(got) == 8 and all(got.values())
        assert out.count(": OK") == 8 and "FAIL" not in out
        assert "[serve]" not in out
    else:
        assert sorted(c.rid for c in got) == [0, 1, 2, 3]
        assert all(c.finished and len(c.tokens) == 6 for c in got)
        assert ("[serve] elastic: workers={0: 'healthy', 1: 'evicted'}"
                in out and "offline_slots=2" in out)


def test_serve_entry_points_raise_on_cuda_without_a_card(models,
                                                         monkeypatch):
    *_, m, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", "qwen3-4b", "--requests", "1"])
