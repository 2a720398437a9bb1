"""Parity of the port's K7 (flash attention, forward) with the JAX package:
the plain PyTorch version — what CPU tensors take — against the Pallas
kernel run in interpret mode as ``tests/test_kernels.py`` runs it and
against ``flash_attention_ref``, at that test's shapes and tolerances; GQA
inside the call; and the end-padding prefill wrapper against the JAX
``full_attention``.  Inputs are numpy arrays from a seed, handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_flash_attention
from repro.kernels import ref as JR
from repro.models.attention import full_attention as j_full_attention

from repro_torch.kernels import common
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_attention import (COUNTER, flash_attention,
                                                 flash_attention_plain)
from repro_torch.models.attention import PREFILL_BLOCK, flash_prefill

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype):
    """The same values in both frameworks (float32 numpy, rounded once to
    the working dtype by each)."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,hd,causal,bq,bkv", [
    (2, 4, 256, 64, True, 64, 64),
    (1, 2, 128, 32, False, 64, 32),
    (1, 1, 512, 128, True, 128, 128),
    (3, 2, 192, 64, True, 64, 64),   # grid not a power of two
])
def test_plain_flash_matches_reference_kernel(b, h, s, hd, causal, bq, bkv,
                                              dtype):
    atol = DTYPES[dtype][2]
    (jq, jk, jv), (q, k, v) = _inputs(b * 1000 + s, [(b, h, s, hd)] * 3,
                                      dtype)
    before = COUNTER.count
    out = flash_attention(q, k, v, causal=causal, block_q=bq, block_kv=bkv)
    assert COUNTER.count == before          # CPU tensors launch nothing
    assert out.dtype == q.dtype and out.shape == q.shape
    want_kernel = j_flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                    block_kv=bkv)
    want_ref = JR.flash_attention_ref(jq, jk, jv, causal=causal)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(out), _np(want), atol=atol, rtol=1e-2)
    np.testing.assert_allclose(
        _np(TR.flash_attention_ref(q, k, v, causal=causal)), _np(want_ref),
        atol=atol, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_is_the_expanded_call(dtype):
    """kv heads fewer than query heads: query head h reads kv head
    h // (H // KV) — the JAX contract's expanded call, without the copy."""
    atol = DTYPES[dtype][2]
    H, KV = 8, 2
    (jq, jk, jv), (q, k, v) = _inputs(
        5, [(2, H, 128, 32), (2, KV, 128, 32), (2, KV, 128, 32)], dtype)
    out = flash_attention(q, k, v, block_q=64, block_kv=64)
    expanded = flash_attention(q, k.repeat_interleave(H // KV, 1),
                               v.repeat_interleave(H // KV, 1), block_q=64,
                               block_kv=64)
    assert torch.equal(out, expanded)
    want = j_flash_attention(jq, jnp.repeat(jk, H // KV, axis=1),
                             jnp.repeat(jv, H // KV, axis=1), block_q=64,
                             block_kv=64)
    np.testing.assert_allclose(_np(out), _np(want), atol=atol, rtol=1e-2)


@pytest.mark.parametrize("S", [1, 37, PREFILL_BLOCK, PREFILL_BLOCK + 5])
def test_flash_prefill_matches_reference_full_attention(S):
    """The prefill route: (B, S, H, hd) queries over the prompt's own
    unexpanded keys, padded at the end to K7's block and sliced back —
    equal to the JAX package's causal ``full_attention`` over expanded
    heads (float32: only the summation order differs)."""
    H, KV = 4, 2
    (jq, jk, jv), (q, k, v) = _inputs(
        S, [(2, S, H, 16), (2, S, KV, 16), (2, S, KV, 16)], "float32")
    out = flash_prefill(q, k, v)
    assert out.shape == q.shape
    want = j_full_attention(jq, jnp.repeat(jk, H // KV, axis=2),
                            jnp.repeat(jv, H // KV, axis=2), causal=True)
    np.testing.assert_allclose(_np(out), _np(want), atol=1e-5, rtol=1e-5)


def test_flash_rejects_what_the_reference_rejects():
    q = torch.zeros(1, 2, 100, 16)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention_plain(q, q, q, block_q=64, block_kv=64)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(torch.zeros(1, 3, 128, 16),
                        torch.zeros(1, 2, 128, 16),
                        torch.zeros(1, 2, 128, 16))


def test_wrapper_on_card_raises_without_its_library(monkeypatch):
    """Handed card tensors, K7's wrapper launches its kernel or raises —
    here the library cannot be built, and it must not answer with the
    plain version."""
    monkeypatch.setattr(common, "on_device", lambda *ts: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(RuntimeError, match="CUDA device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(torch.zeros(1, 2, 128, 8), torch.zeros(1, 2, 128, 8),
                        torch.zeros(1, 2, 128, 8))
