"""Parity of the port's MLA family with the JAX package: tiny
``deepseek-v2-236b`` (multi-head latent attention, q_lora 32, kv_lora 32,
qk 16 + 8, v 16, 4 heads; layer 0 dense, layer 1 MoE of 4 experts with 2
shared) with the reference's parameters carried over by
``params_from_jax``: forward logits and aux, loss and gradients, prefill,
four decode steps and the compressed cache against the reference's; the
dense engine's greedy tokens against the JAX engine's; the paged engine
refused with the reference's message; the full config's parameter tree
against the reference's shapes; the registry against the reference's."""
import jax
import numpy as np
import pytest
import torch

import torch_family_parity as P
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import build_model as j_build_model
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import leaves_with_paths

ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module")
def fam():
    return P.reference(ARCH)


def test_list_archs_equals_reference():
    assert list_archs() == j_list_archs()
    assert len(list_archs()) == 10


def test_forward_matches_reference(fam):
    P.check_forward(fam)


def test_loss_and_gradients_match_reference(fam):
    P.check_loss_and_grads(fam)


def test_prefill_matches_reference(fam):
    P.check_prefill(fam)


def test_four_decode_steps_match_reference_and_forward(fam):
    P.check_decode(fam)


def test_cache_is_the_compressed_pair(fam):
    """The MLA cache holds (c_kv, k_rope) a token — kv_lora + qk_rope
    values, not 2 × heads × head_dim — with the reference's tree."""
    P.check_cache_tree(fam)
    m = fam.cfg.mla
    cache = fam.model.init_cache(1, 8, device=P.CPU)
    per_token = sum(t.numel() for path, t in leaves_with_paths(cache)
                    if path[-1] in ("c_kv", "k_rope")) // 8
    assert per_token == len(fam.model.plan) * (m.kv_lora + m.qk_rope)
    assert {path[-1] for path, _ in leaves_with_paths(cache)} == \
        {"c_kv", "k_rope", "pos", "step"}


def test_full_config_parameter_tree_equals_reference_at_four_layers():
    """At published widths, cut to 4 of 60 layers (one dense layer and 3 MoE
    layers of all 160 experts), the port's parameter tree has the
    reference's paths and shapes: 13,302,912,000 parameters.  Shapes only:
    the port on the meta device, the reference through ``eval_shape``."""
    cfg = get_config(ARCH).replace(n_layers=4)
    got = {p: tuple(t.shape) for p, t in leaves_with_paths(
        build_model(cfg).init(0, device="meta"))}
    jm = j_build_model(j_get_config(ARCH).replace(n_layers=4))
    want = {p: tuple(t.shape) for p, t in leaves_with_paths(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))}
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == 13_302_912_000
    # one scanned period of 4 layers; every dense FFN of a config with
    # first_dense takes d_ff_first_dense
    assert got[("stack", "scan", "l0", "mlp", "wo")] == (1, 12288, 5120)


def test_dense_engine_greedy_matches_reference(fam):
    want = P.jax_engine_tokens(fam, "dense")
    _, got = P.port_engine(fam, "dense")
    assert got == want


def test_paged_engine_is_refused_as_the_reference_refuses_it(fam):
    with pytest.raises(ValueError) as jerr:
        JServeEngine(fam.jm, fam.jp, n_slots=2, max_seq=P.MAX_SEQ,
                     paged_kv=True, page_tokens=4)
    with pytest.raises(ValueError) as err:
        ServeEngine(fam.model, fam.params, n_slots=2, max_seq=P.MAX_SEQ,
                    paged_kv=True, page_tokens=4)
    assert str(err.value) == str(jerr.value)
    assert "MLA/SSM caches stay dense" in str(err.value)


def test_launcher_serves_deepseek_dense_on_the_cpu():
    done = serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--prompt-len", "10", "--max-new", "4",
                       "--max-seq", "32"])
    assert sorted(c.rid for c in done) == [0, 1, 2]
    assert all(c.finished and len(c.tokens) == 4 for c in done)
    assert all(0 <= t < 256 for c in done for t in c.tokens)


def test_decode_writes_only_each_rows_position(fam):
    """Rows at different positions: a decode step writes each row's latent
    pair at its own ``pos`` and leaves every other cache row as it was."""
    _, cache = P.prefill(fam)
    # the first layer's slice of the scanned cache (views, written in place)
    blk = {k: t[0] for k, t in cache["scan"]["l0"]["attn"].items()}
    blk["pos"][1] -= 3                         # row 1 three tokens behind
    before = {k: blk[k].clone() for k in ("c_kv", "k_rope")}
    with torch.no_grad():
        fam.model.decode_step(fam.params, cache,
                              torch.from_numpy(fam.tokens[:, P.S:P.S + 1]))
    for key, old in before.items():
        changed = (blk[key] != old).any(-1)
        assert changed[0].nonzero().flatten().tolist() == [P.S]
        assert changed[1].nonzero().flatten().tolist() == [P.S - 3]
    assert blk["pos"].tolist() == [P.S + 1, P.S - 2]
