"""Parity of the port's enc-dec family with the JAX package: tiny
``whisper-base`` (2 encoder and 2 decoder layers, LayerNorm, GeLU, biases,
learned positions, cross-attention over 24 encoder frames) with the
reference's parameters carried over by ``params_from_jax`` and the same
numpy frame embeddings (the conv frontend is a stub in both): forward
logits, loss and gradients, prefill (the cross k/v memoized in the
cache), four decode steps (decoder positions gathered per row, cross k/v
read from the cache) and the cache against the reference's; the prefill's
three kinds of attention on K7's entry point, the forward on none; the
engine and the launcher refuse the family, whose prefill needs frames."""
import pytest
import torch

import torch_family_parity as P
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import attention
from repro_torch.serve.engine import ServeEngine

ARCH = "whisper-base"


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


def test_prefill_runs_encoder_self_and_cross_attention_on_k7(fam,
                                                            monkeypatch):
    """A prefill calls K7's entry point for the encoder's self-attention
    (non-causal, frames × frames), then per decoder layer for its causal
    self-attention and its cross-attention (non-causal, prompt × frames);
    the forward, which trains, calls it never."""
    calls = []
    fn = attention.flash_attention

    def rec(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return fn(q, k, v, **kw)
    monkeypatch.setattr(attention, "flash_attention", rec)
    P.forward(fam)
    assert calls == []
    P.prefill(fam)
    F, S = P.FRAMES, P.S
    assert calls == [(F, F, False)] * fam.cfg.enc_layers + \
        [(S, S, True), (S, F, False)] * fam.cfg.n_layers


def test_cross_cache_must_hold_the_encoder_rows(fam):
    cache = fam.model.init_cache(P.B, P.MAX_SEQ, enc_len=P.FRAMES - 1,
                                 device=P.CPU)
    with pytest.raises(ValueError, match=f"enc_len={P.FRAMES}"):
        with torch.no_grad():
            fam.model.prefill(
                fam.params, P.torch_batch(fam.tokens[:, :P.S], fam.extra),
                cache)


def test_engine_and_launcher_refuse_the_family(fam, capsys):
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServeEngine(fam.model, fam.params, n_slots=2, max_seq=P.MAX_SEQ)
    with pytest.raises(SystemExit):
        serve_main(["--arch", ARCH, "--device", "cpu"])
    assert "encoder-decoder" in capsys.readouterr().err
