"""SSM training on the port against the JAX package: tiny ``mamba2-370m``
and tiny ``jamba-v0.1-52b`` take one train step from the reference's
parameters (carried by ``params_from_jax``) on the same numpy batch — loss,
gradients and the updated parameters at the train tests' tolerances.

The reference trains a Mamba2 block through its pure-JAX ``ssd_chunked``,
never through its Pallas kernel, which has no backward.  The port routes
the same way: a call whose inputs require grad goes through its own
``models.ssm.ssd_chunked``, and a call without grad through
``kernels.ops.ssd_scan`` (K8 and the SSD pass on the card).  A recorder
shows which one each call reached."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.models import build_model as j_build_model
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import init_opt_state as j_init_opt_state

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.train import train
from repro_torch.models import build_model, ssm
from repro_torch.models.transformer import stage_plan
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainstep import make_train_step
from repro_torch.tree import leaves

ARCHS = ["mamba2-370m", "jamba-v0.1-52b"]
B, S = 4, 13           # 13: a ragged last chunk at the tiny chunk of 8
OPT = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10)
#: float32 on both sides; the two differ in summation order only (the
#: train tests' tolerance, tests/test_torch_train.py)
TIGHT = dict(atol=1e-5, rtol=1e-5)
#: gradients pass through every layer's chunked scan and, in jamba, the
#: MoE's gates: summation order, compounded over the stack
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
OPT_EPS = 1e-8     # OptimizerConfig.eps


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    arch = request.param
    jcfg = j_tiny_config(arch)
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the JAX train step's parts (trainstep.py: value_and_grad, then
    # adamw_update), compiled once each
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb)[0]))(jp)
    new, _, _ = jax.jit(lambda g, o, p: j_adamw_update(
        g, o, p, JOptimizerConfig(**OPT)))(grads, j_init_opt_state(jp), jp)
    get = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    return dict(arch=arch, params=jax.device_get(jp), batch=batch,
                loss=float(loss), grads=get(grads), new=get(new))


def _port(ref):
    cfg = tiny_config(ref["arch"])
    params = params_from_jax(ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in ref["batch"].items()}
    return build_model(cfg), params, batch


def test_loss_and_gradients_match_reference(ref):
    model, params, batch = _port(ref)
    ps = [p.requires_grad_(True) for p in leaves(params)]
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(loss.item(), ref["loss"], **TIGHT)
    assert len(grads) == len(ref["grads"])
    for g, w in zip(grads, ref["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_train_step_matches_reference(ref):
    """One step of the port's ``make_train_step`` lands where the JAX step
    lands.  At step 1 AdamW moves each coordinate by lr·g/(|g|+eps) (+
    decay), with g the gradient after clipping to the global norm
    ``grad_clip``; ill-conditioned where |g| is within a few eps of zero:
    the gradient tolerance wherever |g| > 100·eps, and
    tests/mdev/rma_grad_sync.py's everywhere (tests/test_torch_train.py's
    rule)."""
    model, params, batch = _port(ref)
    opt = OptimizerConfig(**OPT)
    step = make_train_step(model, opt)
    params, _, metrics = step(params, init_opt_state(params), batch)
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], **TIGHT)
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in ref["grads"]))
    clip = min(1.0, opt.grad_clip / norm)
    for p, w, g in zip(leaves(params), ref["new"], ref["grads"]):
        ok = np.abs(g) * clip > 100 * OPT_EPS
        np.testing.assert_allclose(p.numpy()[ok], w[ok], **GRAD_TOL)
        np.testing.assert_allclose(p.numpy(), w, atol=3e-3, rtol=1e-2)


def test_grad_calls_reach_ssd_chunked_and_no_grad_calls_the_scan(
        ref, monkeypatch):
    """A train step's Mamba2 blocks call ``ssd_chunked`` (one call a
    layer, and under ``remat="block"`` one more in the recompute of each
    layer inside a scanned period; never the kernels' scan); a prefill
    without grad calls ``ops.ssd_scan`` (one a layer, never
    ``ssd_chunked``)."""
    model, params, batch = _port(ref)
    calls = []
    for mod, name in ((ssm, "ssd_chunked"), (ops, "ssd_scan")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    n_mamba = sum(s.mixer == "mamba" for s in model.plan)
    prefix, _ = stage_plan(model.plan)
    recomputed = (sum(s.mixer == "mamba" for s in model.plan[prefix:])
                  if model.cfg.remat == "block" else 0)
    step = make_train_step(model, OptimizerConfig(**OPT))
    params, _, _ = step(params, init_opt_state(params), batch)
    assert calls == ["ssd_chunked"] * (n_mamba + recomputed)
    calls.clear()
    with torch.no_grad():
        model.prefill(params, {"tokens": batch["tokens"]},
                      model.init_cache(B, 32, device="cpu"))
    assert calls == ["ssd_scan"] * n_mamba
    calls.clear()
    model.forward(params, {"tokens": batch["tokens"]})   # no leaf needs grad
    assert calls == ["ssd_scan"] * n_mamba


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_ssm_families_with_the_ring(arch):
    run = train(arch, steps=3, global_batch=4, seq_len=16,
                grad_sync="rma_ring", dp_ranks=2, device="cpu",
                log_every=10)
    assert run.steps_run == 3 and all(np.isfinite(run.losses))
    assert run.losses[-1] < run.losses[0] and run.phases == 4
