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

from repro_torch import _build
from repro_torch.kernels import common
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_attention import (COUNTER, VARIANTS,
                                                 flash_attention,
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


def _bf16(x):
    """Round float32 to bfloat16 (nearest, ties to even), kept in float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _emulate_bf16_kernel(q, k, v, causal, block_kv=128):
    """The bfloat16 variant's arithmetic in numpy: float32 scores of bf16
    inputs scaled in float32, NEG_INF on the causal mask, the online max and
    denominator in float32 over its 128-key tiles, P rounded to bfloat16
    before P V, out = acc / max(l, 1e-30) rounded to bfloat16."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    k = np.repeat(k, h // kvh, axis=1)
    v = np.repeat(v, h // kvh, axis=1)
    m = np.full((b, h, sq), -2.0**30, np.float32)
    l = np.zeros((b, h, sq), np.float32)
    acc = np.zeros((b, h, sq, hd), np.float32)
    qpos = np.arange(sq)[:, None]
    for k0 in range(0, sk, block_kv):
        s = np.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + block_kv])
        s = s.astype(np.float32) * np.float32(hd ** -0.5)
        if causal:
            kpos = np.arange(k0, k0 + s.shape[-1])[None, :]
            s = np.where(qpos >= kpos, s, np.float32(-2.0**30))
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new[..., None]).astype(np.float32)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + np.einsum(
            "bhqk,bhkd->bhqd", _bf16(p), v[:, :, k0:k0 + block_kv])
        m = m_new
    return _bf16(acc / np.maximum(l, np.float32(1e-30))[..., None])


@pytest.mark.parametrize("b,h,kvh,s,hd,causal,bq,bkv", [
    (2, 4, 4, 256, 64, True, 64, 64),
    (1, 2, 2, 128, 32, False, 64, 32),
    (1, 1, 1, 512, 128, True, 128, 128),
    (3, 2, 2, 192, 64, True, 64, 64),
    (1, 8, 2, 256, 128, True, 128, 128),   # a GQA prefill: 8 query heads / 2
])
def test_bf16_variant_arithmetic_within_tolerance_of_reference_kernel(
        b, h, kvh, s, hd, causal, bq, bkv):
    """The bfloat16 variant rounds P to bfloat16 before P V (the JAX
    serving path's rounding of its weights) where the JAX kernel keeps P in
    float32: an error of about 2^-9 of |v| per output, inside the JAX
    kernel test's bfloat16 tolerance."""
    atol = DTYPES["bfloat16"][2]
    (jq, jk, jv), _ = _inputs(b * 1000 + s + h,
                              [(b, h, s, hd), (b, kvh, s, hd),
                               (b, kvh, s, hd)], "bfloat16")
    q, k, v = (np.asarray(x, np.float32) for x in (jq, jk, jv))
    got = _emulate_bf16_kernel(q, k, v, causal)
    want = j_flash_attention(jq, jnp.repeat(jk, h // kvh, axis=1),
                             jnp.repeat(jv, h // kvh, axis=1), causal=causal,
                             block_q=bq, block_kv=bkv)
    np.testing.assert_allclose(got, _np(want), atol=atol, rtol=1e-2)
    assert np.abs(got - _np(want)).max() > 0   # the rounding is really there


class _FakeLibrary:
    """Stands in for the CUDA library: records the entry point each launch
    reached and its arguments, and reports success."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, symbol=None):
        def launch(*args):
            self.calls.append((symbol, args))
            return 0
        return launch


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(common, "on_device", lambda *ts: True)
    monkeypatch.setattr(common, "stream_ptr", lambda device: 0)
    fake = _FakeLibrary()
    monkeypatch.setattr(_build, "lib", fake)
    return fake


def test_wrapper_routes_each_dtype_to_its_variant(fake_card):
    """float32 launches the SIMT kernel on contiguous copies; bfloat16 the
    wgmma/TMA kernel on the operands' own strides, its output in q's
    layout; the counter names the variant."""
    COUNTER.reset()
    q = torch.zeros(1, 4, 128, 32)
    flash_attention(q, q[:, :2], q[:, :2])
    assert fake_card.calls[-1][0] is None        # the library's main entry
    assert COUNTER.by_variant == {VARIANTS[torch.float32]: 1}
    qs = torch.zeros(1, 96, 4, 32, dtype=torch.bfloat16)   # (B, S, H, D)
    ks = torch.zeros(1, 96, 2, 32, dtype=torch.bfloat16)
    out = flash_attention(qs.transpose(1, 2), ks.transpose(1, 2),
                          ks.transpose(1, 2), block_q=96, block_kv=96)
    symbol, args = fake_card.calls[-1]
    assert symbol == "rt_flash_attention_bf16"
    assert list(args[4]) == [96 * 4 * 32, 32, 4 * 32, 96 * 2 * 32, 32, 2 * 32,
                             96 * 2 * 32, 32, 2 * 32, 96 * 4 * 32, 32, 4 * 32]
    assert out.shape == (1, 4, 96, 32) and out.transpose(1, 2).is_contiguous()
    assert COUNTER.count == 2 and COUNTER.by_variant == {
        VARIANTS[torch.float32]: 1, VARIANTS[torch.bfloat16]: 1}
    COUNTER.reset()


def test_bf16_operand_breaking_tma_alignment_raises(fake_card):
    """A bfloat16 base or stride off TMA's 16-byte grid, or a strided last
    dim, raises before any launch, and nothing falls back."""
    good = torch.zeros(1, 2, 128, 16, dtype=torch.bfloat16)
    flat = torch.zeros(2 * 128 * 16 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 2, 128, 16)              # base 2 bytes off
    wide = torch.zeros(1, 2, 128, 20, dtype=torch.bfloat16)[..., :16]
    strided = torch.zeros(1, 2, 128, 32, dtype=torch.bfloat16)[..., ::2]
    before = COUNTER.count
    for bad, what in ((shifted, "16 bytes"), (wide, "16 bytes"),
                      (strided, "last dim")):
        for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
            with pytest.raises(ValueError, match=what):
                flash_attention(*args)
    assert fake_card.calls == [] and COUNTER.count == before
