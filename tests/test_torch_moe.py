"""Parity of the port's MoE layer and expert-parallel train step with the
JAX package.  The port's ``ep_mode="rma"`` runs over ``ep_ranks`` stacked
ranks through its planned all-to-all (plain K4/K6 here); the JAX side is
``moe_ref``, the single-program gspmd path and ``jax.grad`` of it, with the
JAX package's own tolerances (``tests/test_moe_ep.py``,
``tests/mdev/moe_ep_rma.py``).  Weights come from the reference's init,
activations and tokens from numpy with a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.tiny import tiny_config as j_tiny_config
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models.transformer import layer_plan as j_layer_plan
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.trainstep import make_train_step as j_make_train_step

from repro_torch.configs import MoEConfig, ModelConfig, tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.models.transformer import layer_plan
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainstep import make_train_step
from repro_torch.tree import leaves

D = 32
ORACLE = dict(atol=2e-5, rtol=1e-3)      # tests/test_moe_ep.py:33-44
GRADS = dict(atol=3e-4, rtol=2e-2)       # tests/mdev/moe_ep_rma.py:74-75
TIGHT = dict(atol=1e-5, rtol=1e-5)

j_moe_ref = jax.jit(j_moe.moe_ref, static_argnums=2)
j_moe_gspmd = jax.jit(lambda p, x, cfg: j_moe.moe_apply(p, x, cfg,
                                                        ep_mode="gspmd"),
                      static_argnums=2)


def _cfgs(E, k, cf=8.0, dtype="float32"):
    kw = dict(name="t", family="moe", n_layers=1, d_model=D, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab=64, dtype=dtype,
              param_dtype="float32")
    moe = dict(num_experts=E, top_k=k, d_ff_expert=32, capacity_factor=cf)
    return (JModelConfig(**kw, moe=JMoEConfig(**moe)),
            ModelConfig(**kw, moe=MoEConfig(**moe)))


def _layer(E, k, T, seed, dtype="float32"):
    jcfg, tcfg = _cfgs(E, k, dtype=dtype)
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = {name: torch.from_numpy(np.array(v)) for name, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal((1, T, D)).astype(
        np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jcfg, tcfg, jp, tp, jx, tx


# (E, k, T, ep_ranks): padding (T % ep_ranks), top-1/2/3, one and two
# experts per rank
RMA_CASES = [(4, 1, 3, 2), (8, 2, 17, 4), (4, 3, 40, 4), (8, 1, 24, 2)]


@pytest.mark.parametrize("E,k,T,ep", RMA_CASES)
def test_moe_rma_ep_matches_reference(E, k, T, ep):
    jcfg, tcfg, jp, tp, jx, tx = _layer(E, k, T, E * k + T)
    out, aux = t_moe.moe_apply(tp, tx, tcfg, ep_mode="rma", ep_ranks=ep)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_moe_ref(jp, jx, jcfg)),
                               **ORACLE)
    _, aux_g = j_moe_gspmd(jp, jx, jcfg)
    np.testing.assert_allclose(float(aux), float(aux_g), rtol=1e-5)


@pytest.mark.parametrize("E,k,T", [(4, 1, 3), (8, 2, 17)])
def test_moe_gspmd_matches_jax_gspmd(E, k, T):
    jcfg, tcfg, jp, tp, jx, tx = _layer(E, k, T, E + T)
    out, aux = t_moe.moe_apply(tp, tx, tcfg)          # cfg.moe.ep_mode
    jout, jaux = j_moe_gspmd(jp, jx, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **ORACLE)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    rcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, ep_mode="rma"))
    out_r, _ = t_moe.moe_apply(tp, tx, rcfg)          # ep_ranks = 1
    np.testing.assert_allclose(out_r.numpy(), np.asarray(jout), **ORACLE)


def test_moe_rma_ep_bf16_wire_matches_gspmd():
    """bf16 models exchange bf16 wire payloads; outputs track the gspmd path
    within the dtype's tolerance (tests/test_moe_ep.py:62-75) and the id
    column survives the round trip exactly."""
    jcfg, tcfg, jp, tp, jx, tx = _layer(8, 2, 24, 3, dtype="bfloat16")
    out, aux = t_moe.moe_apply(tp, tx, tcfg, ep_mode="rma", ep_ranks=4)
    jout, jaux = j_moe_gspmd(jp, jx, jcfg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), atol=0.08,
                               rtol=0.1)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)


def test_moe_rma_ep_grads_match_jax_gspmd():
    """Gradients flow back through both exchanges (their backward is the
    same declared all-to-all) and match ``jax.grad`` of the gspmd path."""
    jcfg, tcfg, jp, tp, jx, tx = _layer(8, 2, 20, 5)
    w = np.random.default_rng(6).standard_normal((1, 20, D)).astype(
        np.float32)

    def jloss(p, x):
        out, aux = j_moe.moe_apply(p, x, jcfg, ep_mode="gspmd")
        return jnp.sum(out * w) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    ps = {name: v.clone().requires_grad_(True) for name, v in tp.items()}
    x = tx.clone().requires_grad_(True)
    out, aux = t_moe.moe_apply(ps, x, tcfg, ep_mode="rma", ep_ranks=4)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [*ps.values(), x])
    for (name, _), g in zip(ps.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   err_msg=name, **GRADS)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **GRADS)


def test_moe_config_and_family_guards():
    cfg = tiny_config("llama4-maverick-400b-a17b")
    jcfg = j_tiny_config("llama4-maverick-400b-a17b")
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    assert cfg.moe.capacity(100) == jcfg.moe.capacity(100) == 200
    assert [s.ffn for s in build_model(cfg).plan] == ["dense", "moe"]
    with pytest.raises(ValueError, match="divide"):
        build_model(cfg, ep_ranks=3)
    with pytest.raises(ValueError, match="divisible"):
        t_moe.moe_apply({}, torch.zeros(1, 4, 64), cfg, ep_mode="rma",
                        ep_ranks=3)
    with pytest.raises(ValueError, match="ep_mode"):
        t_moe.moe_apply({}, torch.zeros(1, 4, 64), cfg, ep_mode="ring")
    # every ep_backend the reference takes runs, and lands the rma
    # exchange's output bit for bit ("auto" with no table: rma)
    params = build_model(cfg).init(0, device="cpu")["stack"]["scan"]
    blk = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
               else v[0]) for k, v in params["l1"]["moe"].items()}
    xin = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 4, 64)).astype(np.float32))
    outs = {}
    for backend in ("rma", "auto", "gspmd"):
        bcfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   ep_backend=backend))
        outs[backend] = t_moe.moe_apply(blk, xin, bcfg, ep_mode="rma",
                                        ep_ranks=2)
    for backend in ("auto", "gspmd"):
        for a, b in zip(outs[backend], outs["rma"]):
            assert torch.equal(a, b), backend
    bad = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              ep_backend="interpret"))
    with pytest.raises(ValueError, match="ep_backend"):
        t_moe.moe_apply(blk, xin, bad, ep_mode="rma", ep_ranks=2)
    for family in ("hybrid", "ssm"):
        # the reference builds both (attention mixers: no ssm config; no
        # FFN under "ssm"), and so does the port, with its plan
        plan = build_model(cfg.replace(family=family)).plan
        jplan = j_layer_plan(jcfg.replace(family=family))
        assert [(s.mixer, s.ffn, s.cross) for s in plan] == \
            [(s.mixer, s.ffn, s.cross) for s in jplan]
    # an MoE config with multi-head latent attention (deepseek-v2): the
    # port builds it, with the reference's plan (one dense layer, then MoE)
    mla_plan = layer_plan(tiny_config("deepseek-v2-236b"))
    assert [(s.mixer, s.ffn, s.cross) for s in mla_plan] == \
        [(s.mixer, s.ffn, s.cross)
         for s in j_layer_plan(j_tiny_config("deepseek-v2-236b"))] == \
        [("mla", "dense", False), ("mla", "moe", False)]
    dense = build_model(tiny_config("qwen3-4b"))
    with pytest.raises(ValueError, match="no MoE config"):
        make_train_step(dense, OptimizerConfig(total_steps=1), moe_ep="rma")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(build_model(cfg), OptimizerConfig(total_steps=1),
                        moe_ep="rma", ep_ranks=4, grad_sync="rma_ring",
                        data_axis_size=2)


@pytest.fixture(scope="module")
def step_ref():
    cfg = j_tiny_config("llama4-maverick-400b-a17b")
    model = j_build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    # AdamW's first step moves each weight by about lr · g / |g|, so a
    # gradient near zero amplifies summation-order differences by lr / |g|;
    # lr 1e-3 keeps that under the tolerance for this initialization
    opt = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    step = jax.jit(j_make_train_step(model, JOptimizerConfig(**opt),
                                     moe_ep="gspmd"))
    new, _, metrics = step(params, j_init_opt_state(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(params=jax.device_get(params), batch=batch, opt=opt,
                new=[np.asarray(x) for x in jax.tree.leaves(new)],
                metrics={k: float(v) for k, v in metrics.items()})


def test_moe_rma_train_step_matches_jax(step_ref):
    """One ``tiny_config("llama4-maverick-400b-a17b")`` step with the
    expert layer over 4 stacked ranks (``moe_ep="rma"``): loss, its parts
    and the post-AdamW parameters equal the JAX gspmd step's."""
    cfg = tiny_config("llama4-maverick-400b-a17b")
    params = params_from_jax(step_ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in step_ref["batch"].items()}
    step = make_train_step(build_model(cfg), OptimizerConfig(**step_ref["opt"]),
                           moe_ep="rma", ep_ranks=4)
    params, _, metrics = step(params, init_opt_state(params), batch)
    for name in ("loss", "xent", "aux"):
        np.testing.assert_allclose(float(metrics[name]),
                                   step_ref["metrics"][name], **TIGHT)
    got = leaves(params)
    assert len(got) == len(step_ref["new"])
    for g, w in zip(got, step_ref["new"]):
        np.testing.assert_allclose(g.numpy(), w, **TIGHT)
