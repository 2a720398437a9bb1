"""``remat="block"`` on the port against ``"none"`` and the JAX package.

The reference rematerializes every scanned period under ``jax.checkpoint``
(its default); the port wraps each period in a non-reentrant
``torch.utils.checkpoint``.  On the CPU the two port settings must agree
bit for bit (the backward walks the same graph; the recompute reproduces
the saved values exactly), and both must agree with the JAX package at the
train tests' tolerances.  The recompute re-runs a period's side effects: an
expert-parallel MoE period's exchanges run once more, so K4 and K6 (their
plain versions here) run 3(n-1) times a step instead of 2(n-1).  Serving
never rematerializes.  Parameters come from the reference's init, tokens
from numpy with a seed."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.models import build_model as j_build_model
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.trainstep import make_train_step as j_make_train_step

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import attention, build_model, ssm, transformer
from repro_torch.models.transformer import layer_plan, stage_plan
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainstep import make_train_step
from repro_torch.tree import leaves

ARCHS = ["qwen3-4b", "mamba2-370m", "jamba-v0.1-52b"]
B, S = 2, 13           # 13: a ragged last chunk at the tiny SSM chunk of 8
#: float32 on both sides: the dense train tests' tolerance
#: (tests/test_torch_train.py), and for the SSM stacks their gradients'
#: (tests/test_torch_ssm_train.py: summation order through the chunked
#: scan and, in jamba, the MoE gates)
TOL = {"qwen3-4b": dict(atol=1e-5, rtol=1e-5),
       "mamba2-370m": dict(atol=2e-5, rtol=1e-4),
       "jamba-v0.1-52b": dict(atol=2e-5, rtol=1e-4)}
MOE_ARCH = "llama4-maverick-400b-a17b"
EP = 4


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    arch = request.param
    jcfg = j_tiny_config(arch)
    assert jcfg.remat == "block"          # the reference's default
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb)[0]))(jp)
    return dict(arch=arch, params=jax.device_get(jp), batch=batch,
                loss=float(loss),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])


def _loss_and_grads(ref, remat, monkeypatch=None):
    """The port's loss and gradients under ``remat``; with
    ``monkeypatch``, also the number of ``apply_block`` calls."""
    cfg = tiny_config(ref["arch"]).replace(remat=remat)
    model = build_model(cfg)
    params = params_from_jax(ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in ref["batch"].items()}
    calls = []
    if monkeypatch is not None:
        real = transformer.apply_block

        def rec(*a, **kw):
            calls.append(torch.is_grad_enabled())
            return real(*a, **kw)
        monkeypatch.setattr(transformer, "apply_block", rec)
    ps = [p.requires_grad_(True) for p in leaves(params)]
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, ps)
    return model, loss.detach(), grads, calls


def test_config_defaults_to_block():
    for arch in ARCHS + [MOE_ARCH]:
        assert tiny_config(arch).remat == j_tiny_config(arch).remat == "block"


def test_block_equals_none_bit_for_bit_and_matches_jax(ref, monkeypatch):
    model, loss_b, grads_b, calls = _loss_and_grads(ref, "block",
                                                    monkeypatch)
    # every scanned period's blocks run twice (forward, recompute), each
    # prefix block once
    prefix, period = stage_plan(model.plan)
    n = len(model.plan)
    assert len(calls) == prefix + 2 * (n - prefix)
    monkeypatch.undo()
    _, loss_n, grads_n, _ = _loss_and_grads(ref, "none")
    assert torch.equal(loss_b, loss_n)
    assert len(grads_b) == len(grads_n) == len(ref["grads"])
    for gb, gn in zip(grads_b, grads_n):
        assert torch.equal(gb, gn)
    tol = TOL[ref["arch"]]
    np.testing.assert_allclose(loss_b.item(), ref["loss"], **tol)
    for g, w in zip(grads_b, ref["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **tol)


def test_recompute_reaches_ssd_chunked_never_the_scan(monkeypatch):
    """A Mamba2 block trains through ``ssd_chunked`` in the first forward
    and in the recompute (the checkpoint is non-reentrant: the first
    forward records grad); ``ops.ssd_scan`` (K8 and the pass on the card)
    is never called in a step."""
    cfg = tiny_config("mamba2-370m")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    calls = []
    for mod, name in ((ssm, "ssd_chunked"), (ops, "ssd_scan")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
             for k in ("tokens", "labels")}
    step = make_train_step(model, OptimizerConfig(total_steps=2))
    step(params, init_opt_state(params), batch)
    assert calls == ["ssd_chunked"] * (2 * cfg.n_layers)


def _moe_k46_per_step(cfg, n):
    """K4 (dispatch) and K6 (combine) launches of one expert-parallel step,
    each: forward and backward 2(n-1) a MoE layer, and under remat the
    recompute's forward (n-1) for each MoE layer inside a scanned
    period."""
    plan = layer_plan(cfg)
    prefix, _ = stage_plan(plan)
    n_moe = sum(sp.ffn == "moe" for sp in plan)
    in_period = sum(sp.ffn == "moe" for sp in plan[prefix:])
    remat = in_period if cfg.remat == "block" else 0
    return (2 * n_moe + remat) * (n - 1)


@pytest.fixture(scope="module")
def moe_ref():
    cfg = j_tiny_config(MOE_ARCH)
    model = j_build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    opt = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    step = jax.jit(j_make_train_step(model, JOptimizerConfig(**opt),
                                     moe_ep="gspmd"))
    new, _, metrics = step(params, j_init_opt_state(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(params=jax.device_get(params), batch=batch, opt=opt,
                new=[np.asarray(x) for x in jax.tree.leaves(new)],
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("remat", ["block", "none"])
def test_moe_rma_step_remat_counts_and_matches_jax(moe_ref, remat,
                                                   monkeypatch):
    """``tiny_config(MOE_ARCH)`` (plan dense, MoE: prefix 0, period 2, the
    MoE layer inside the period) with the expert layer over 4 stacked
    ranks: K4 and K6 run 3(n-1) = 9 times each a step under remat, 6
    without, and the step lands where the JAX step lands (the test_torch_moe
    tolerance)."""
    k46 = sys.modules["repro_torch.kernels.ordered_put_signal"]
    seen = {"put": 0, "acc": 0}
    for name, key in (("put_signal_rows_plain", "put"),
                      ("accumulate_signal_rows_plain", "acc")):
        fn = getattr(k46, name)

        def rec(*a, _fn=fn, _key=key, **kw):
            seen[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(k46, name, rec)
    cfg = tiny_config(MOE_ARCH).replace(remat=remat)
    params = params_from_jax(moe_ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in moe_ref["batch"].items()}
    step = make_train_step(build_model(cfg),
                           OptimizerConfig(**moe_ref["opt"]), moe_ep="rma",
                           ep_ranks=EP)
    params, _, metrics = step(params, init_opt_state(params), batch)
    want = _moe_k46_per_step(cfg, EP)
    assert want == (9 if remat == "block" else 6)
    assert seen == {"put": want, "acc": want}
    tight = dict(atol=1e-5, rtol=1e-5)
    for name in ("loss", "xent", "aux"):
        np.testing.assert_allclose(float(metrics[name]),
                                   moe_ref["metrics"][name], **tight)
    got = leaves(params)
    assert len(got) == len(moe_ref["new"])
    for g, w in zip(got, moe_ref["new"]):
        np.testing.assert_allclose(g.numpy(), w, **tight)


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m"])
def test_serving_never_rematerializes(arch, monkeypatch):
    """A prefill, a decode step and a no-grad forward make the same
    entry-point calls under ``"block"`` as under ``"none"``, and none of
    them reaches the checkpoint."""
    ckpt_calls = []
    real_ckpt = transformer.checkpoint

    def rec_ckpt(*a, **kw):
        ckpt_calls.append(1)
        return real_ckpt(*a, **kw)
    monkeypatch.setattr(transformer, "checkpoint", rec_ckpt)
    entry = []
    for mod, name in ((attention, "flash_attention"), (ops, "ssd_scan"),
                      (ssm, "ssd_chunked")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            entry.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    rng = np.random.default_rng(2)
    seen = {}
    for remat in ("block", "none"):
        cfg = tiny_config(arch).replace(remat=remat)
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 16)))
        entry.clear()
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": tok},
                                          model.init_cache(B, 32,
                                                           device="cpu"))
            model.decode_step(params, cache, logits[:, -1].argmax(
                -1, keepdim=True))
            model.forward(params, {"tokens": tok})
        model.forward(params, {"tokens": tok})    # grad on, no leaf needs it
        seen[remat] = list(entry)
    assert ckpt_calls == []
    assert seen["block"] == seen["none"] and seen["block"]


def test_training_under_block_reaches_the_checkpoint(monkeypatch):
    """The counterpart: a train step checkpoints each scanned period once
    (tiny qwen3-4b: 2 periods of one layer)."""
    calls = []
    real_ckpt = transformer.checkpoint

    def rec_ckpt(fn, *a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real_ckpt(fn, *a, **kw)
    monkeypatch.setattr(transformer, "checkpoint", rec_ckpt)
    cfg = tiny_config("qwen3-4b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
             for k in ("tokens", "labels")}
    step = make_train_step(model, OptimizerConfig(total_steps=2))
    _, _, metrics = step(params, init_opt_state(params), batch)
    prefix, period = stage_plan(model.plan)
    assert calls == [False] * ((cfg.n_layers - prefix) // period)
    assert np.isfinite(float(metrics["loss"]))
    # with remat off, the same step never reaches it
    calls.clear()
    model = build_model(dataclasses.replace(cfg, remat="none"))
    params = model.init(0, device="cpu")
    step = make_train_step(model, OptimizerConfig(total_steps=2))
    step(params, init_opt_state(params), batch)
    assert calls == []
