"""Error-feedback gradient compression on the port against the JAX
package's ``repro.train.compress``, the compressed all-reduce on stacked
ranks, the train step's ``compressor=`` refusal, and the deprecated
``rma_all_to_all`` wrapper.

Top-k keeps the k largest magnitudes; where two magnitudes tie the two
packages may keep different indices, so the top-k inputs here have
distinct magnitudes (a permutation of distinct values, random signs).
Inputs come from numpy with a seed."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rma.collectives import plan_all_reduce as j_plan_all_reduce
from repro.train import compress as J

from repro_torch.configs import tiny_config
from repro_torch.core.rma import plan as plan_mod
from repro_torch.core.rma import plan_all_to_all, rma_all_to_all
from repro_torch.models import build_model
from repro_torch.train import compress as T
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainstep import make_train_step

N_RANKS = 4


def _distinct(rng, shape):
    """float32 values of pairwise distinct magnitudes, random signs."""
    n = int(np.prod(shape))
    mags = rng.permutation(np.arange(1, n + 1)).astype(np.float32) / n * 3
    return (mags * rng.choice([-1.0, 1.0], n).astype(np.float32)
            ).reshape(shape)


def _eq(t, j):
    j = np.asarray(j)
    assert t.numpy().dtype == j.dtype and t.numpy().shape == j.shape
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("shape", [(1000,), (37, 29)])
def test_int8_matches_reference_bit_for_bit(shape):
    rng = np.random.default_rng(0)
    g = rng.standard_normal(shape).astype(np.float32) * 3
    g.flat[5] = 0.5 * np.abs(g).max()    # a value on a rounding tie
    q, scale = T.int8_compress(torch.from_numpy(g))
    jq, jscale = J.int8_compress(jnp.asarray(g))
    _eq(q, jq)
    _eq(scale, jscale)
    assert q.dtype == torch.int8
    _eq(T.int8_decompress(q, scale), J.int8_decompress(jq, jscale))
    # all zeros: the scale's floor
    z = np.zeros(shape, np.float32)
    _eq(T.int8_compress(torch.from_numpy(z))[1],
        J.int8_compress(jnp.asarray(z))[1])


@pytest.mark.parametrize("k", [1, 7, 100])
def test_topk_matches_reference_bit_for_bit(k):
    g = _distinct(np.random.default_rng(k), (25, 20))
    kept, idx = T.topk_compress(torch.from_numpy(g), k)
    jkept, jidx = J.topk_compress(jnp.asarray(g), k)
    assert idx.dtype == torch.int32
    _eq(kept, jkept)
    _eq(idx, jidx)
    _eq(T.topk_decompress(kept, idx, g.size),
        J.topk_decompress(jkept, jidx, g.size))


def test_topk_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05])
    kept, idx = T.topk_compress(g, 2)
    r = T.topk_decompress(kept, idx, 5)
    np.testing.assert_allclose(r.numpy(), [0, -5.0, 0, 3.0, 0])


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_error_feedback_loop_matches_reference(scheme):
    """Five steps of compress → residual → next gradient, both packages
    fed the same gradients: payload, residual and restored values equal
    bit for bit at every step.  Each step's gradient is drawn so that
    gradient + residual — what top-k ranks — has distinct magnitudes."""
    cfg = T.CompressionConfig(scheme=scheme, topk_frac=0.05)
    jcfg = J.CompressionConfig(scheme=scheme, topk_frac=0.05)
    rng = np.random.default_rng(7)
    err = T.init_error_state({"g": torch.zeros(40, 25)})["g"]
    jerr = J.init_error_state({"g": jnp.zeros((40, 25))})["g"]
    _eq(err, jerr)
    for _ in range(5):
        g = _distinct(rng, (40, 25)) - err.numpy()
        mags = np.abs(g + err.numpy())
        assert np.unique(mags).size == mags.size
        payload, err, restored = T.compress_with_feedback(
            torch.from_numpy(g), err, cfg)
        jpayload, jerr, jrestored = J.compress_with_feedback(
            jnp.asarray(g), jerr, jcfg)
        parts = payload if isinstance(payload, tuple) else (payload,)
        jparts = jpayload if isinstance(jpayload, tuple) else (jpayload,)
        for p, jp in zip(parts, jparts):
            _eq(p, jp)
        _eq(err, jerr)
        _eq(restored, jrestored)
        assert T.compression_ratio(torch.from_numpy(g), payload) == \
            J.compression_ratio(jnp.asarray(g), jpayload)


def test_error_feedback_accumulates_small_coords():
    cfg = T.CompressionConfig(scheme="topk", topk_frac=0.34)  # k=1 of 3
    g = torch.tensor([1.0, 0.4, 0.0])
    err = torch.zeros(3)
    sent_small = False
    for _ in range(5):
        (kept, idx), err, restored = T.compress_with_feedback(g, err, cfg)
        if int(idx[0]) == 1:
            sent_small = True
    assert sent_small


@pytest.mark.parametrize("scheme,ratio", [("int8", 0.25), ("topk", 0.02)])
def test_compression_ratio_equals_reference(scheme, ratio):
    """int8 is a quarter of float32 (plus the scale); top-k at 1 % keeps
    k values and k int32 indices, 2 % (int64 indices would read 3 %)."""
    g = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    cfg = T.CompressionConfig(scheme=scheme)
    payload, _, _ = T.compress_with_feedback(torch.from_numpy(g),
                                             torch.zeros(4096), cfg)
    jpayload, _, _ = J.compress_with_feedback(
        jnp.asarray(g), jnp.zeros(4096), J.CompressionConfig(scheme=scheme))
    got = T.compression_ratio(torch.from_numpy(g), payload)
    assert got == J.compression_ratio(jnp.asarray(g), jpayload)
    assert got == pytest.approx(ratio, abs=1e-3)


def test_sgd_with_error_feedback_converges():
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    w_true = torch.arange(1.0, 9.0)
    y = X @ w_true
    cfg = T.CompressionConfig(scheme="int8")
    w = torch.zeros(8)
    err = torch.zeros(8)
    for _ in range(1000):
        g = 2 * X.T @ (X @ w - y) / 64
        _, err, restored = T.compress_with_feedback(g, err, cfg)
        w = w - 0.01 * restored
    assert float(torch.linalg.norm(w - w_true)) < 0.1


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_compressed_all_reduce_matches_per_rank_reference(scheme):
    """Four stacked ranks: each row compressed with its own residual as
    the JAX package compresses rank r's gradient, the restored rows summed
    by the ring — bit for bit the JAX package's meshless interpret ring —
    over n; every row holds the same result."""
    n = N_RANKS
    rng = np.random.default_rng(3)
    g = np.stack([_distinct(rng, (30, 17)) for _ in range(n)])
    err = np.stack([_distinct(rng, (30, 17)) * 0.01 for _ in range(n)])
    cfg = T.CompressionConfig(scheme=scheme, topk_frac=0.1)
    jcfg = J.CompressionConfig(scheme=scheme, topk_frac=0.1)
    red, new_err = T.compressed_all_reduce(
        torch.from_numpy(g), torch.from_numpy(err), cfg, "x", n)
    outs = [J.compress_with_feedback(jnp.asarray(g[r]), jnp.asarray(err[r]),
                                     jcfg) for r in range(n)]
    for r, (_, jerr, _) in enumerate(outs):
        _eq(new_err[r], jerr)
    restored = jnp.stack([o[2].reshape(-1) for o in outs])
    want = np.asarray(j_plan_all_reduce(restored, "x", n,
                                        backend="interpret")) / n
    assert red.shape == g.shape
    for r in range(n):
        np.testing.assert_array_equal(red[r].numpy().reshape(-1), want[r])
        np.testing.assert_array_equal(red[r].numpy(), red[0].numpy())
    np.testing.assert_allclose(
        red[0].numpy(), np.asarray(restored).sum(0).reshape(g.shape[1:]) / n,
        rtol=1e-5, atol=1e-6)


def test_compressor_with_the_ring_is_refused():
    """The reference's step skips the gradient sync when a compressor is
    given with the ring, so every rank would apply its own gradients; the
    stacked layout has one parameter tree, so the port refuses.  Without
    the ring the argument is ignored, as in the reference."""
    model = build_model(tiny_config("qwen3-4b"))
    cfg = T.CompressionConfig()
    with pytest.raises(NotImplementedError, match="unsynced gradients"):
        make_train_step(model, OptimizerConfig(), grad_sync="rma_ring",
                        data_axis_size=4, compressor=cfg)
    make_train_step(model, OptimizerConfig(), compressor=cfg)
    make_train_step(model, OptimizerConfig(), grad_sync="rma_ring",
                    data_axis_size=1, compressor=cfg)


@pytest.mark.parametrize("op", [None, "sum"])
def test_rma_all_to_all_warns_once_and_equals_the_plan(op):
    n, m, w = 4, 3, 5
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((n, n * m, w)).astype(
        np.float32))
    counts = torch.from_numpy(rng.integers(0, m + 1, (n, n)).astype(
        np.int32))
    plan_mod._LEGACY_WARNED.discard("repro_torch.core.rma.rma_all_to_all")
    with pytest.warns(DeprecationWarning, match="rma_all_to_all"):
        got = rma_all_to_all(x, "x", n, counts=counts, op=op)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        again = rma_all_to_all(x, "x", n, counts=counts, op=op)
    want = plan_all_to_all(x, "x", n, counts=counts, op=op)
    for res in (got, again):
        for a, b in ((res.data, want.data), (res.counts, want.counts),
                     (res.bells, want.bells)):
            assert torch.equal(a, b)
