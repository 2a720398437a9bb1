"""Parity of the port's data-parallel train step with the JAX package, as
``tests/mdev/rma_grad_sync.py`` sets it up: ``tiny_config("qwen3-4b")``,
n = 8 ranks, global batch 16 × 16.  The reference side is the meshless
composition — per-rank ``jax.grad`` → ``plan_all_reduce(...,
backend="interpret")`` → ``/ n`` → ``adamw_update`` — and the
single-program update on the whole batch.  Parameters come from the
reference's init (``params_from_jax``); tokens from numpy with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.core.rma.collectives import plan_all_reduce as j_plan_all_reduce
from repro.models import build_model as j_build_model
from repro.models.attention import blockwise_attention as j_blockwise
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro.train.trainstep import make_train_step as j_make_train_step

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models.attention import blockwise_attention, full_attention
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainstep import make_train_step
from repro_torch.tree import leaves, leaves_with_paths

N, B, S = 8, 16, 16
OPT = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10)
TIGHT = dict(atol=1e-5, rtol=1e-5)
OPT_EPS = 1e-8     # OptimizerConfig.eps


@pytest.fixture(scope="module")
def ref():
    cfg = j_tiny_config("qwen3-4b")
    model = j_build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    opt_cfg = JOptimizerConfig(**OPT)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    adamw = jax.jit(lambda g, o, p: j_adamw_update(g, o, p, opt_cfg))
    per = B // N
    losses, vecs, rank_grads = [], [], []
    for r in range(N):
        shard = {k: jnp.asarray(v[r * per:(r + 1) * per])
                 for k, v in batch.items()}
        loss, g = grad_fn(params, shard)
        flat, tdef = jax.tree.flatten(g)
        losses.append(float(loss))
        rank_grads.append([np.asarray(x) for x in flat])
        vecs.append(jnp.concatenate([x.reshape(-1) for x in flat]))
    summed = j_plan_all_reduce(jnp.stack(vecs), "x", N, backend="interpret")
    vec = summed[0] / N
    out, off = [], 0
    for x in flat:
        out.append(vec[off:off + x.size].reshape(x.shape))
        off += x.size
    grads = jax.tree.unflatten(tdef, out)
    grads_rma = [np.asarray(x) for x in out]
    params_rma, _, _ = adamw(grads, j_init_opt_state(params), params)
    full = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_ref, g_ref = grad_fn(params, full)
    params_ref, _, _ = adamw(g_ref, j_init_opt_state(params), params)
    micro = [{k: v[a * (B // 2):(a + 1) * (B // 2)] for k, v in full.items()}
             for a in range(2)]
    g_acc = [sum(np.asarray(x, np.float64) for x in xs) / 2 for xs in zip(
        *(jax.tree.leaves(grad_fn(params, mb)[1]) for mb in micro))]
    acc_step = jax.jit(j_make_train_step(model, opt_cfg, accum_steps=2))
    params_acc, _, m_acc = acc_step(params, j_init_opt_state(params), full)
    get = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    return dict(params=jax.device_get(params), batch=batch, losses=losses,
                rank_grads=rank_grads, grads_rma=grads_rma,
                params_rma=get(params_rma), loss_ref=float(loss_ref),
                grads_ref=get(g_ref), params_ref=get(params_ref),
                grads_acc=g_acc, params_acc=get(params_acc),
                loss_acc=float(m_acc["loss"]))


def _port(ref):
    cfg = tiny_config("qwen3-4b")
    params = params_from_jax(ref["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in ref["batch"].items()}
    return build_model(cfg), params, batch


def _close(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **tol)


def test_params_from_jax_is_leafwise(ref):
    tree = ref["params"]
    params = params_from_jax(tree, tiny_config("qwen3-4b"), device="cpu")
    want = [np.asarray(x) for x in jax.tree.leaves(tree)]
    got = leaves_with_paths(params)
    assert [p for p, _ in got] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    for (_, g), w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="differ"):
        params_from_jax({"embed": tree["embed"]}, tiny_config("qwen3-4b"),
                        device="cpu")


def test_per_rank_loss_and_grads(ref):
    model, params, batch = _port(ref)
    ps = [p.requires_grad_(True) for p in leaves(params)]
    per = B // N
    for r in range(N):
        shard = {k: v[r * per:(r + 1) * per] for k, v in batch.items()}
        loss, _ = model.loss(params, shard)
        grads = torch.autograd.grad(loss, ps)
        np.testing.assert_allclose(loss.item(), ref["losses"][r], **TIGHT)
        _close(grads, ref["rank_grads"][r], **TIGHT)


def _step_and_capture(ref, monkeypatch, **kw):
    """Run the port's step; capture the (synced) gradients it hands AdamW."""
    from repro_torch.train import trainstep

    seen = {}
    real = trainstep.adamw_update

    def capture(grads, opt_state, params, cfg):
        seen["grads"] = [g.clone() for g in leaves(grads)]
        return real(grads, opt_state, params, cfg)

    monkeypatch.setattr(trainstep, "adamw_update", capture)
    model, params, batch = _port(ref)
    step = make_train_step(model, OptimizerConfig(**OPT), **kw)
    params, opt, metrics = step(params, init_opt_state(params), batch)
    return params, opt, metrics, seen["grads"]


def _check_update(params, want, want_grads):
    """Post-AdamW parameters.  At step 1 AdamW moves each coordinate by
    lr·g/(|g|+eps) (+ decay): where |g| is within a few eps of zero the
    update is ill-conditioned in g, and float32 matmuls summed in another
    order than XLA's move it visibly.  So: the reference tolerance wherever
    |g| > 100·eps, and tests/mdev/rma_grad_sync.py's everywhere."""
    for p, w, g in zip(leaves(params), want, want_grads):
        p = p.numpy()
        ok = np.abs(np.asarray(g)) > 100 * OPT_EPS
        np.testing.assert_allclose(p[ok], w[ok], **TIGHT)
        np.testing.assert_allclose(p, w, atol=3e-3, rtol=1e-2)


def test_rma_ring_step_matches_meshless_reference(ref, monkeypatch):
    params, opt, metrics, grads = _step_and_capture(
        ref, monkeypatch, grad_sync="rma_ring", data_axis="x",
        data_axis_size=N)
    np.testing.assert_allclose(float(metrics["loss"]),
                               np.mean(ref["losses"]), **TIGHT)
    assert metrics["phases"] == 2 * N     # 2(n-1) ring + the exit flush epoch
    assert int(opt["step"]) == 1
    _close(grads, ref["grads_rma"], **TIGHT)
    _check_update(params, ref["params_rma"], ref["grads_rma"])
    # the single-program update, at tests/mdev/rma_grad_sync.py's tolerance
    _close(leaves(params), ref["params_ref"], atol=3e-3, rtol=1e-2)


def test_adamw_matches_reference_on_the_same_grads(ref):
    from repro_torch.train.optimizer import adamw_update

    _, params, _ = _port(ref)
    grads = [torch.from_numpy(g.copy()) for g in ref["grads_rma"]]
    from repro_torch.tree import unflatten

    params, opt, metrics = adamw_update(unflatten(params, grads),
                                        init_opt_state(params), params,
                                        OptimizerConfig(**OPT))
    _close(leaves(params), ref["params_rma"], **TIGHT)
    assert int(opt["step"]) == 1
    from repro.train.optimizer import lr_at as j_lr_at

    np.testing.assert_allclose(
        float(metrics["lr"]),
        float(j_lr_at(JOptimizerConfig(**OPT), jnp.asarray(1))), rtol=1e-6)


def test_single_program_step_matches_reference(ref, monkeypatch):
    params, _, metrics, grads = _step_and_capture(ref, monkeypatch)
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss_ref"], **TIGHT)
    _close(grads, ref["grads_ref"], **TIGHT)
    _check_update(params, ref["params_ref"], ref["grads_ref"])


def test_accum_steps_matches_reference(ref, monkeypatch):
    params, _, metrics, grads = _step_and_capture(ref, monkeypatch,
                                                  accum_steps=2)
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss_acc"], **TIGHT)
    _close(grads, ref["grads_acc"], **TIGHT)
    _check_update(params, ref["params_acc"], ref["grads_acc"])


def test_blockwise_attention_matches_reference():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(j_blockwise(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, block_kv=8))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = blockwise_attention(tq, tk, tv, causal=True, block_kv=8)
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    np.testing.assert_allclose(full_attention(tq, tk, tv, causal=True).numpy(),
                               want, atol=1e-5, rtol=1e-4)


def test_launcher_trains_on_the_cpu():
    from repro_torch.launch.train import train

    run = train("qwen3-4b", steps=3, global_batch=8, seq_len=16,
                grad_sync="rma_ring", dp_ranks=4, device="cpu", log_every=10)
    assert run.steps_run == 3 and len(run.losses) == 3
    assert all(np.isfinite(run.losses)) and run.phases == 8
    assert run.part_ms == []               # CUDA-event timing is card-only


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "starcoder2-3b",
                                  "llama3-405b"])
def test_other_dense_archs_match_reference(arch):
    """The rest of the dense family (layernorm, GeLU MLP, attention biases,
    MHA) at tiny width: loss and gradients from converted reference
    parameters."""
    cfg = j_tiny_config(arch)
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, batch)[0]))(params)
    tparams = params_from_jax(jax.device_get(params), tiny_config(arch),
                              device="cpu")
    ps = [p.requires_grad_(True) for p in leaves(tparams)]
    tloss, _ = build_model(tiny_config(arch)).loss(
        tparams, {k: torch.from_numpy(v.astype(np.int64))
                  for k, v in batch.items()})
    np.testing.assert_allclose(tloss.item(), float(loss), **TIGHT)
    _close(torch.autograd.grad(tloss, ps),
           [np.asarray(g) for g in jax.tree.leaves(grads)], **TIGHT)
