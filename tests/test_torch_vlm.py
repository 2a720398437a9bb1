"""Parity of the port's VLM family with the JAX package: tiny
``internvl2-1b`` (GQA 4/2, a 4-position patch prefix) with the reference's
parameters carried over by ``params_from_jax`` and the same numpy patch
embeddings (the frontend is a stub in both): forward logits, loss and
gradients, prefill, four decode steps and the cache against the
reference's; the prefill's attention on K7's entry point once a layer,
causal; the engine (which feeds prompt tokens only, as the reference's
does) dense, paged and paged + COW, greedy tokens against the JAX
engine's."""
import numpy as np
import pytest
import torch

import torch_family_parity as P
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import attention

ARCH = "internvl2-1b"


@pytest.fixture(scope="module")
def fam():
    return P.reference(ARCH)


def test_forward_matches_reference(fam):
    P.check_forward(fam)


def test_loss_and_gradients_match_reference(fam):
    P.check_loss_and_grads(fam)


def test_prefill_matches_reference(fam):
    P.check_prefill(fam)


def test_four_decode_steps_match_reference_and_forward(fam):
    P.check_decode(fam)


def test_cache_tree_matches_reference(fam):
    P.check_cache_tree(fam)


def test_patches_replace_the_prefix_positions(fam):
    """The patch embeddings take the first ``vlm_prefix`` positions: the
    tokens there no longer matter, and the patches do."""
    n = fam.cfg.vlm_prefix
    toks = fam.tokens.copy()
    toks[:, :n] = (toks[:, :n] + 1) % fam.cfg.vocab
    with torch.no_grad():
        base, _ = fam.model.forward(fam.params,
                                    P.torch_batch(fam.tokens, fam.extra))
        other, _ = fam.model.forward(fam.params,
                                     P.torch_batch(toks, fam.extra))
        text, _ = fam.model.forward(fam.params, P.torch_batch(toks, {}))
    assert torch.equal(base, other)
    assert not torch.allclose(base, text, atol=1e-3)


def test_prefill_attention_runs_on_k7_once_a_layer(fam, monkeypatch):
    """Each prefill attention layer calls K7's entry point once, causal, at
    the prompt's length; the forward calls it never."""
    calls = []
    fn = attention.flash_attention

    def rec(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return fn(q, k, v, **kw)
    monkeypatch.setattr(attention, "flash_attention", rec)
    P.forward(fam)
    assert calls == []
    P.prefill(fam)
    H, KV, hd = fam.cfg.n_heads, fam.cfg.n_kv_heads, fam.cfg.head_dim
    assert calls == [((P.B, H, P.S, hd), (P.B, KV, P.S, hd), True)] * \
        fam.cfg.n_layers


@pytest.fixture(scope="module")
def reference_tokens(fam):
    """The JAX engine's greedy tokens with copy-on-write prefix sharing."""
    return P.jax_engine_tokens(fam, "prefix_share")


@pytest.mark.parametrize("mode", list(P.MODES))
def test_engine_greedy_matches_reference(fam, reference_tokens, mode):
    eng, got = P.port_engine(fam, mode)
    assert got == reference_tokens
    if mode == "prefix_share":
        st = eng.stats()
        assert st["pages_shared"] > 0 and st["cow_copies"] >= 1
        eng.pool.check_conservation()
        assert eng.pool.n_free == eng.pool.n_pages


def test_launcher_serves_internvl2_paged_on_the_cpu():
    done = serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--prompt-len", "10", "--max-new", "4",
                       "--max-seq", "32", "--disagg", "--prefix-share",
                       "--shared-prefix-len", "8", "--page-tokens", "4"])
    assert sorted(c.rid for c in done) == [0, 1, 2]
    assert all(c.finished and len(c.tokens) == 4 for c in done)
    assert np.all([0 <= t < 256 for c in done for t in c.tokens])
