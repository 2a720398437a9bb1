"""Parity of the port's hybrid stack with the JAX package: tiny
``jamba-v0.1-52b`` (one period of 8 layers — 7 Mamba2, 1 attention at
offset 4, MoE on every other FFN — d 64, 4 experts, d_state 16, chunk 8)
with the reference's parameters carried over by ``params_from_jax``.  The
layer plan against the reference's for every arch the port builds; the
forward logits; prefill then decode against the reference and the port's
own forward; greedy tokens of the engine (dense, paged, paged with
copy-on-write prefix sharing) against the JAX engine's; ``paginate_cache``
paging only the attention layer's KV.  Inputs are numpy arrays from a seed,
handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.tiny import tiny_config as j_tiny_config
from repro.models import build_model as j_build_model
from repro.models.transformer import layer_plan as j_layer_plan
from repro.models.transformer import stage_plan as j_stage_plan
from repro.serve import disagg as jdis
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_config, list_archs, tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.models.transformer import layer_plan, stage_plan
from repro_torch.serve import disagg as tdis
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import leaves_with_paths

ARCH = "jamba-v0.1-52b"
CPU = "cpu"
#: float32 logits: summation order only
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
#: prefill/decode against the full forward (tests/test_smoke_archs.py)
MODEL_TOL = dict(atol=2e-3, rtol=2e-3)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _spec_rows(plan):
    return [(s.mixer, s.ffn, s.cross) for s in plan]


@pytest.mark.parametrize("arch", list_archs())
def test_layer_plan_equals_reference_for_every_ported_arch(arch):
    for port_cfg, ref_cfg in ((get_config(arch), j_get_config(arch)),
                              (tiny_config(arch), j_tiny_config(arch))):
        plan, jplan = layer_plan(port_cfg), j_layer_plan(ref_cfg)
        assert _spec_rows(plan) == _spec_rows(jplan)
        assert stage_plan(plan) == j_stage_plan(jplan)


def test_jamba_plan_is_one_attention_layer_a_period():
    plan = layer_plan(get_config(ARCH))
    assert len(plan) == 32 and stage_plan(plan) == (0, 8)
    assert [s.mixer for s in plan[:8]] == ["mamba"] * 4 + ["gqa"] + \
        ["mamba"] * 3
    assert [s.ffn for s in plan[:8]] == ["dense", "moe"] * 4
    assert tiny_config(ARCH).n_layers == j_tiny_config(ARCH).n_layers == 8


@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny_config(ARCH)
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = tiny_config(ARCH)
    m = build_model(cfg)
    p = params_from_jax(jax.device_get(jp), cfg, device=CPU)
    return jcfg, jm, jp, cfg, m, p


def test_params_from_jax_carries_the_jamba_tree(models):
    jcfg, jm, jp, cfg, m, p = models
    got = dict(leaves_with_paths(p))
    want = dict(leaves_with_paths(jax.device_get(jp)))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert np.array_equal(_np(got[path]), np.asarray(leaf)), path
    fresh = dict(leaves_with_paths(m.init(0, device=CPU)))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    assert {path[3] for path in got if path[:2] == ("stack", "scan")} == \
        {"mamba", "attn", "mlp", "moe", "norm_mixer", "norm_ffn"}


def test_forward_prefill_and_decode_match_reference(models):
    """Forward logits within 1e-4 of the reference's; prefill (13 tokens:
    a ragged last chunk) and three decode steps against the reference's
    logits and caches, and against the port's own forward."""
    jcfg, jm, jp, cfg, m, p = models
    B, S, steps = 2, 13, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S + steps))
    full, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    jfull, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)})
    np.testing.assert_allclose(_np(full), _np(jfull), **LOGIT_TOL)
    jl, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
        jm.init_cache(B, 32))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :S])},
                       m.init_cache(B, 32, device=CPU))
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    np.testing.assert_allclose(_np(tl[:, -1]), _np(full[:, S - 1]),
                               **MODEL_TOL)
    jdecode = jax.jit(jm.decode_step)
    for t in range(S, S + steps):
        nxt = toks[:, t:t + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt, jnp.int32))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
        np.testing.assert_allclose(_np(tl[:, -1]), _np(full[:, t]),
                                   **MODEL_TOL)
    got, want = leaves_with_paths(tc), leaves_with_paths(
        jax.device_get(jc))
    assert [path for path, _ in got] == [path for path, _ in want]
    assert {path[3] for path, _ in got if path[0] == "scan"} == \
        {"conv", "ssm", "k", "v", "pos"}
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **LOGIT_TOL,
                                   err_msg=str(path))


def _requests(vocab):
    """Two prompts sharing a 2-page prefix, two identical prompts (a COW
    fork on their first decode write), one unrelated."""
    rng = np.random.RandomState(24)
    pre = rng.randint(0, vocab, size=8)
    same = rng.randint(0, vocab, size=11)
    prompts = [np.concatenate([pre, rng.randint(0, vocab, size=3)]),
               np.concatenate([pre, rng.randint(0, vocab, size=3)]),
               same, same.copy(), rng.randint(0, vocab, size=11)]
    return [(i, pr, 3 + i % 3) for i, pr in enumerate(prompts)]


MODES = {"dense": {}, "paged": dict(paged_kv=True, page_tokens=4),
         "prefix_share": dict(paged_kv=True, page_tokens=4,
                              prefix_share=True)}


@pytest.fixture(scope="module")
def reference_tokens(models):
    """The JAX engine's greedy tokens with copy-on-write prefix sharing
    (every prompt is 11 tokens: one prefill compile)."""
    jcfg, jm, jp, cfg, m, p = models
    eng = JServeEngine(jm, jp, n_slots=3, max_seq=32,
                       **MODES["prefix_share"])
    for rid, prompt, n in _requests(cfg.vocab):
        eng.submit(JRequest(rid, prompt, n))
    return {c.rid: c.tokens for c in eng.run()}, eng.stats()


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_matches_reference(models, reference_tokens, mode):
    """Multi-token greedy decode: the port's dense, paged and paged + COW
    engines give the JAX engine's tokens, bit for bit; with prefix sharing
    pages are shared, a COW fork happens and the pool is conserved."""
    jcfg, jm, jp, cfg, m, p = models
    eng = ServeEngine(m, p, n_slots=3, max_seq=32, **MODES[mode])
    for rid, prompt, n in _requests(cfg.vocab):
        eng.submit(Request(rid, prompt, n))
    want, jstats = reference_tokens
    assert {c.rid: c.tokens for c in eng.run(strict=True)} == want
    if mode == "prefix_share":
        st = eng.stats()
        for key in ("pages_shared", "cow_copies", "pages_allocated"):
            assert st[key] == jstats[key], key
        assert st["pages_shared"] > 0 and st["cow_copies"] >= 1
        eng.pool.check_conservation()
        assert eng.pool.n_free == eng.pool.n_pages
    if mode != "dense":         # one page payload: the attention layer's KV
        n_attn = sum(s.mixer == "gqa" for s in m.plan)
        assert eng.executor.page_payload_elems == \
            4 * cfg.n_kv_heads * cfg.head_dim * 2 * n_attn


def test_paginate_cache_pages_only_the_attention_kv(models):
    """The SSM leaves pass through ``paginate_cache`` untouched (the same
    tensors); the attention layer's ``{k, v, pos}`` becomes the page pool;
    the paged tree has the reference's paths and shapes."""
    jcfg, jm, jp, cfg, m, p = models
    cache = m.init_cache(2, 16, device=CPU)
    for path, leaf in leaves_with_paths(cache):
        leaf.copy_(torch.randn(leaf.shape).to(leaf.dtype))
    paged = tdis.paginate_cache(cache, 4)
    scan, pscan = cache["scan"], paged["scan"]
    n_mamba = 0
    for j, spec in enumerate(m.plan):
        if spec.mixer == "mamba":
            n_mamba += 1
            for leaf in ("conv", "ssm"):
                assert pscan[f"l{j}"]["mamba"][leaf] is \
                    scan[f"l{j}"]["mamba"][leaf]
        else:
            assert set(pscan[f"l{j}"]["attn"]) == {
                "k_pages", "v_pages", "page_table", "page_ro", "page_hot",
                "pos"}
    assert n_mamba == 7
    jpaged = jdis.paginate_cache(jm.init_cache(2, 16), 4)
    got = [(path, tuple(t.shape)) for path, t in leaves_with_paths(paged)]
    want = [(path, tuple(np.shape(t))) for path, t in
            leaves_with_paths(jax.device_get(jpaged))]
    assert got == want


@pytest.mark.parametrize("extra", [[], ["--disagg", "--prefix-share",
                                        "--shared-prefix-len", "8",
                                        "--page-tokens", "4"]],
                         ids=["dense", "paged-cow"])
def test_launcher_serves_jamba_on_the_cpu(extra):
    done = serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--prompt-len", "10", "--max-new", "4",
                       "--max-seq", "32"] + extra)
    assert sorted(c.rid for c in done) == [0, 1, 2]
    assert all(c.finished and len(c.tokens) == 4 for c in done)
