"""Parity of the port's Mamba2 serving path with the JAX package: K8's plain
version (what CPU tensors take) against the Pallas ``ssd_intra_chunk`` run
in interpret mode as ``tests/test_kernels.py`` runs it; the full SSD scan
(K8 + glue) against the JAX glue, the chunked scan and the sequential
oracle; the causal conv, the Mamba2 block, the tiny ``mamba2-370m`` model
and the dense engine against the JAX package with the reference's weights
carried over by ``params_from_jax``.  Inputs are numpy arrays from a seed,
handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.kernels import ref as JR
from repro.kernels.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan import ssd_intra_chunk as j_ssd_intra_chunk
from repro.models import build_model as j_build_model
from repro.models import ssm as j_ssm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import common, ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels.ssd_scan import (COUNTER, ssd_intra_chunk,
                                          ssd_intra_chunk_plain)
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model, ssm
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import leaves_with_paths

ARCH = "mamba2-370m"
CPU = "cpu"
#: K8's raw outputs in float32: the two differ only in summation order
INTRA_TOL = dict(atol=1e-5, rtol=1e-5)
#: the full scan: the JAX kernel test's tolerance (tests/test_kernels.py)
SCAN_TOL = dict(atol=2e-4, rtol=1e-3)
#: bfloat16 scans that both round y_intra before adding y_inter: one bf16
#: step of values of order 1
SCAN_BF16_TOL = dict(atol=3e-2, rtol=2e-2)
#: float32 blocks and logits: summation order only
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)
#: prefill/decode against the full forward (tests/test_smoke_archs.py)
MODEL_TOL = dict(atol=2e-3, rtol=2e-3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ssd_inputs(seed, B, L, H, P, N, *, init=False):
    """xdt (B, L, H, P), a (B, L, H) < 0, Bm/Cm (B, L, N) and an initial
    state, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, L, H, P)).astype(np.float32) * 0.5
    a = -np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, L, N)).astype(np.float32) * 0.5
    s0 = (rng.standard_normal((B, H, P, N)).astype(np.float32) * 0.3
          if init else None)
    return xdt, a, Bm, Cm, s0


# ---------------------------------------------------------------------------
# K8: the intra-chunk kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

KERNEL_SHAPES = [(2, 64, 4, 16, 32, 16), (1, 128, 2, 32, 16, 32),
                 (1, 48, 8, 8, 64, 8)]       # tests/test_kernels.py:148-152


@pytest.mark.parametrize("B,L,H,P,N,chunk", KERNEL_SHAPES)
def test_plain_intra_chunk_matches_pallas_kernel(B, L, H, P, N, chunk):
    xdt, a, Bm, Cm, _ = _ssd_inputs(L, B, L, H, P, N)
    x2 = xdt.reshape(B, L, H * P)
    want = j_ssd_intra_chunk(jnp.asarray(x2), jnp.asarray(a),
                             jnp.asarray(Bm), jnp.asarray(Cm), chunk=chunk,
                             nheads=H, headdim=P)
    before = COUNTER.count
    got = ssd_intra_chunk(_t(x2), _t(a), _t(Bm), _t(Cm), chunk=chunk,
                          nheads=H, headdim=P)
    assert COUNTER.count == before           # CPU tensors launch nothing
    shapes = [(B, L, H * P), (B, L // chunk, H * P, N), (B, L, H)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), **INTRA_TOL)


# ---------------------------------------------------------------------------
# the full scan: K8 + glue against the JAX glue, ssd_chunked and the oracle
# ---------------------------------------------------------------------------

SCAN_CASES = [s + (False,) for s in KERNEL_SHAPES] + [
    (1, 32, 2, 8, 16, 8, True),      # tests/test_kernels.py:163 (initial state)
    (2, 45, 3, 8, 16, 8, False),     # L no multiple of the chunk: padded
    (1, 70, 2, 16, 32, 16, True),
]


@pytest.mark.parametrize("B,L,H,P,N,chunk,init", SCAN_CASES)
def test_ssd_scan_matches_reference(B, L, H, P, N, chunk, init):
    xdt, a, Bm, Cm, s0 = _ssd_inputs(L + 7, B, L, H, P, N, init=init)
    jin = [jnp.asarray(v) for v in (xdt, a, Bm, Cm)]
    tin = [_t(v) for v in (xdt, a, Bm, Cm)]
    js0 = jnp.asarray(s0) if init else None
    ts0 = _t(s0) if init else None
    y, fs = ops.ssd_scan(*tin, chunk=chunk, nheads=H, headdim=P,
                         initial_state=ts0)
    assert tuple(y.shape) == (B, L, H, P) and tuple(fs.shape) == (B, H, P, N)
    wants = [TR.ssd_scan_ref(*tin, initial_state=ts0),
             ssm.ssd_chunked(*tin, chunk=chunk, initial_state=ts0)]
    if L % chunk == 0:                 # the JAX glue assumes whole chunks
        wants.append(j_ssd_scan(*jin, chunk=chunk, nheads=H, headdim=P,
                                initial_state=js0))
    else:
        wants.append(j_ssm.ssd_chunked(*jin, chunk=chunk, initial_state=js0))
    if L <= 32:                        # the JAX oracle steps L eager ops
        wants.append(JR.ssd_scan_ref(*jin, initial_state=js0))
    for wy, wfs in wants:
        np.testing.assert_allclose(_np(y), _np(wy), **SCAN_TOL)
        np.testing.assert_allclose(_np(fs), _np(wfs), **SCAN_TOL)


def test_ssd_scan_bf16_rounds_as_the_jax_glue():
    """At bfloat16 both glues round y_intra to bf16 before adding y_inter
    (ssd_chunked rounds once), so the port's scan matches the JAX glue to
    bf16 rounding."""
    B, L, H, P, N, chunk = 1, 128, 2, 32, 16, 32
    xdt, a, Bm, Cm, _ = _ssd_inputs(3, B, L, H, P, N)
    jin = [jnp.asarray(v, jnp.bfloat16) for v in (xdt, Bm, Cm)]
    tin = [_t(v).to(torch.bfloat16) for v in (xdt, Bm, Cm)]
    wy, wfs = j_ssd_scan(jin[0], jnp.asarray(a), jin[1], jin[2], chunk=chunk,
                         nheads=H, headdim=P)
    y, fs = ops.ssd_scan(tin[0], _t(a), tin[1], tin[2], chunk=chunk,
                         nheads=H, headdim=P)
    assert y.dtype == fs.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(wy), **SCAN_BF16_TOL)
    np.testing.assert_allclose(_np(fs), _np(wfs), **SCAN_BF16_TOL)


@pytest.mark.parametrize("kw,match", [
    (dict(chunk=128), "chunk <= 64"),
    (dict(N=256), "d_state <= 128"),
    (dict(P=128), "headdim <= 64"),
    (dict(L=40), "not a multiple"),
])
def test_wrapper_rejects_shapes_outside_the_kernel(kw, match):
    d = dict(B=1, L=128, H=2, P=16, N=16, chunk=16) | kw
    xdt, a, Bm, Cm, _ = _ssd_inputs(0, d["B"], d["L"], d["H"], d["P"], d["N"])
    with pytest.raises(ValueError, match=match):
        ssd_intra_chunk(_t(xdt.reshape(d["B"], d["L"], -1)), _t(a), _t(Bm),
                        _t(Cm), chunk=d["chunk"], nheads=d["H"],
                        headdim=d["P"])


def test_wrapper_on_card_launches_or_raises(monkeypatch):
    """Card tensors launch K8 or raise: with no library here it raises, and
    an input that requires grad raises before any launch (no backward
    kernel) — never the plain version."""
    xdt, a, Bm, Cm, _ = _ssd_inputs(0, 1, 16, 2, 8, 16)
    args = [_t(xdt.reshape(1, 16, 16)), _t(a), _t(Bm), _t(Cm)]
    kw = dict(chunk=8, nheads=2, headdim=8)
    monkeypatch.setattr(common, "on_device", lambda *ts: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ssd_intra_chunk(*args, **kw)
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ssd_intra_chunk(*args, **kw)
    assert ssd_intra_chunk_plain(*args, **kw)[0].requires_grad


# ---------------------------------------------------------------------------
# the causal conv and the Mamba2 block
# ---------------------------------------------------------------------------

def test_causal_conv1d_matches_reference_and_its_step_form():
    rng = np.random.default_rng(5)
    B, L, C, K = 2, 9, 12, 4
    u = rng.standard_normal((B, L, C)).astype(np.float32)
    w = rng.standard_normal((C, K)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    out = ssm.causal_conv1d(_t(u), _t(w), _t(b))
    want = j_ssm.causal_conv1d(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(_np(out), _np(want), atol=1e-6, rtol=1e-6)
    state = torch.zeros((B, K - 1, C))
    jstate = jnp.zeros((B, K - 1, C))
    for t in range(L):
        step, state = ssm.causal_conv1d_step(_t(u[:, t:t + 1]), state, _t(w),
                                             _t(b))
        jstep, jstate = j_ssm.causal_conv1d_step(
            jnp.asarray(u[:, t:t + 1]), jstate, jnp.asarray(w),
            jnp.asarray(b))
        np.testing.assert_allclose(_np(step[:, 0]), _np(out[:, t]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(step), _np(jstep), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(state), _np(jstate), atol=0, rtol=0)


@pytest.fixture(scope="module")
def models():
    jcfg = j_tiny_config(ARCH)
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = tiny_config(ARCH)
    m = build_model(cfg)
    p = params_from_jax(jax.device_get(jp), cfg, device=CPU)
    return jcfg, jm, jp, cfg, m, p


def test_params_from_jax_carries_the_mamba2_tree(models):
    jcfg, jm, jp, cfg, m, p = models
    got = dict(leaves_with_paths(p))
    want = dict(leaves_with_paths(jax.device_get(jp)))
    assert set(got) == set(want)
    assert any("mamba" in path for path in got)
    assert not any("norm_ffn" in path or "attn" in path for path in got)
    for path, leaf in want.items():
        assert np.array_equal(_np(got[path]), np.asarray(leaf)), path
    fresh = dict(leaves_with_paths(m.init(0, device=CPU)))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}


@pytest.mark.parametrize("mode", ["forward", "prefill_decode"])
def test_mamba2_block_matches_reference(models, mode):
    jcfg, jm, jp, cfg, m, p = models
    jparams = jax.tree.map(lambda t: t[0], jp["stack"]["scan"]["l0"]["mamba"])
    params = {k: (v[0] if not isinstance(v, dict) else
                  {kk: vv[0] for kk, vv in v.items()})
              for k, v in p["stack"]["scan"]["l0"]["mamba"].items()}
    rng = np.random.default_rng(9)
    B, S = 2, 13                               # 13: no multiple of chunk 8
    x = rng.standard_normal((B, S + 2, cfg.d_model)).astype(np.float32)
    japply = jax.jit(j_ssm.mamba2_apply, static_argnames=("cfg",))
    if mode == "forward":
        got = ssm.mamba2_apply(params, _t(x), cfg)
        want, _ = japply(jparams, jnp.asarray(x), jcfg)
        np.testing.assert_allclose(_np(got), _np(want), **BLOCK_TOL)
        return
    cache = ssm.init_mamba2_cache(cfg, B, torch.float32, CPU)
    jcache = j_ssm.init_mamba2_cache(jcfg, B, jnp.float32)
    got = ssm.mamba2_apply(params, _t(x[:, :S]), cfg, cache=cache)
    want, jcache = japply(jparams, jnp.asarray(x[:, :S]), jcfg, cache=jcache)
    np.testing.assert_allclose(_np(got), _np(want), **BLOCK_TOL)
    for t in (S, S + 1):                        # two decode steps
        got = ssm.mamba2_apply(params, _t(x[:, t:t + 1]), cfg, cache=cache)
        want, jcache = japply(jparams, jnp.asarray(x[:, t:t + 1]), jcfg,
                              cache=jcache)
        np.testing.assert_allclose(_np(got), _np(want), **BLOCK_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                       **BLOCK_TOL)


def test_two_token_prefill_raises_where_the_reference_breaks(models):
    """A 2-token prompt leaves a conv tail shorter than the cache's 3 rows:
    the JAX package stores it and its next decode step fails on the shapes;
    the port refuses the prefill."""
    jcfg, jm, jp, cfg, m, p = models
    tokens = np.array([[3, 5]])
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)},
                           jm.init_cache(1, 16))
    with pytest.raises(Exception):
        jm.decode_step(jp, jcache, jnp.asarray([[7]]))
    with pytest.raises(ValueError, match="conv tail"):
        m.prefill(p, {"tokens": torch.from_numpy(tokens)},
                  m.init_cache(1, 16, device=CPU))


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

def test_model_logits_match_reference_and_own_forward(models):
    """Prefill (through K8's plain version) and three decode steps on the
    tiny float32 model: logits and caches agree with the JAX package's, and
    with the port's own full forward at the smoke tests' tolerance."""
    jcfg, jm, jp, cfg, m, p = models
    B, S, steps = 2, 11, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S + steps))
    jl, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
        jm.init_cache(B, 32))
    before = COUNTER.count
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(toks[:, :S])},
                       m.init_cache(B, 32, device=CPU))
    assert COUNTER.count == before
    np.testing.assert_allclose(_np(tl), _np(jl), **BLOCK_TOL)
    full, _ = m.forward(p, {"tokens": torch.from_numpy(toks)})
    jfull, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)})
    np.testing.assert_allclose(_np(full), _np(jfull), **BLOCK_TOL)
    np.testing.assert_allclose(_np(tl[:, -1]), _np(full[:, S - 1]),
                               **MODEL_TOL)
    jdecode = jax.jit(jm.decode_step)
    for t in range(S, S + steps):
        nxt = toks[:, t:t + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt, jnp.int32))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **BLOCK_TOL)
        np.testing.assert_allclose(_np(tl[:, -1]), _np(full[:, t]),
                                   **MODEL_TOL)
    for (path, got), (_, want) in zip(leaves_with_paths(tc),
                                      leaves_with_paths(jax.device_get(jc))):
        np.testing.assert_allclose(_np(got), _np(want), **BLOCK_TOL,
                                   err_msg=str(path))


def test_engine_greedy_matches_reference(models):
    jcfg, jm, jp, cfg, m, p = models
    rng = np.random.RandomState(0)
    reqs = [(i, rng.randint(0, cfg.vocab, size=n), 3 + i % 3)
            for i, n in enumerate((11, 9, 1, 16, 4))]
    jeng = JServeEngine(jm, jp, n_slots=3, max_seq=32)
    eng = ServeEngine(m, p, n_slots=3, max_seq=32)
    for r in reqs:
        jeng.submit(JRequest(*r))
        eng.submit(Request(*r))
    assert {c.rid: c.tokens for c in eng.run(strict=True)} == \
        {c.rid: c.tokens for c in jeng.run()}


def test_paged_engine_rejects_archs_without_gqa_kv(models):
    """paged_kv on a stack with no self-attention KV (pure SSM) refuses
    instead of serving dense while reporting page activity
    (tests/test_serve.py:217-225)."""
    *_, m, p = models
    with pytest.raises(ValueError, match="no self-attention KV"):
        ServeEngine(m, p, n_slots=1, max_seq=32, paged_kv=True,
                    page_tokens=8)


def test_launcher_serves_mamba2_on_the_cpu():
    done = serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--prompt-len", "10", "--max-new", "4"])
    assert sorted(c.rid for c in done) == [0, 1, 2]
    assert all(c.finished and len(c.tokens) == 4 for c in done)
    with pytest.raises(ValueError, match="no self-attention KV"):
        serve_main(["--arch", ARCH, "--device", "cpu", "--disagg"])
