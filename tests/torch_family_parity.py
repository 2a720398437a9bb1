"""The parity harness of ``tests/test_torch_{mla,vlm,encdec}.py``: one of
the JAX package's tiny architectures and the port's, the reference's
parameters carried over by ``params_from_jax``, the same numpy inputs
(tokens, labels, and ``frames`` or ``patches`` where the family reads them)
handed to both.

``reference(arch)`` runs the JAX side once — forward over the prompt and its
continuation, loss and ``jax.grad``, prefill, four decode steps — in four
compiles; the ``check_*`` functions run the port on the same inputs and
hold it to those results at the reference's tolerances
(``tests/test_smoke_archs.py``: 2e-3, 3e-3 for multi-token decode).  The
engine helpers serve one request set through both packages' engines."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.models import build_model as j_build_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import leaves, leaves_with_paths

CPU = "cpu"
B, S, STEPS, MAX_SEQ = 2, 16, 4, 32
#: encoder frames of an enc-dec batch: not the decoder's length, so the
#: cross-attention is never square
FRAMES = 24
#: tests/test_smoke_archs.py's tolerances
TOL = dict(atol=2e-3, rtol=2e-3)
DECODE_TOL = dict(atol=3e-3, rtol=3e-3)


def np32(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@dataclasses.dataclass
class Family:
    arch: str
    jm: object
    jp: dict
    cfg: object
    model: object
    params: dict
    tokens: np.ndarray           # (B, S + STEPS)
    labels: np.ndarray           # (B, S)
    extra: dict                  # frames / patches, numpy float32
    want: dict                   # the JAX package's results
    enc_len: int


def _jax_batch(tokens, extra, **kw):
    return {"tokens": jnp.asarray(tokens, jnp.int32),
            **{k: jnp.asarray(v) for k, v in extra.items()},
            **{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()}}


def torch_batch(tokens, extra, **kw):
    return {"tokens": torch.from_numpy(np.asarray(tokens, np.int64)),
            **{k: torch.from_numpy(v) for k, v in extra.items()},
            **{k: torch.from_numpy(np.asarray(v, np.int64))
               for k, v in kw.items()}}


def reference(arch: str, seed: int = 0) -> Family:
    """Both packages' tiny ``arch`` and the JAX package's results."""
    jcfg = j_tiny_config(arch)
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = tiny_config(arch)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S + STEPS))
    labels = rng.integers(0, cfg.vocab, (B, S))
    extra = {}
    if cfg.enc_layers:
        extra["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.vlm_prefix:
        extra["patches"] = rng.standard_normal(
            (B, cfg.vlm_prefix, cfg.d_model)).astype(np.float32)
    enc_len = FRAMES if cfg.enc_layers else 0
    want: dict = {}
    want["forward"], want["aux"] = jax.jit(jm.forward)(
        jp, _jax_batch(tokens, extra))
    jb = _jax_batch(tokens[:, :S], extra, labels=labels)
    want["loss"], grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb)[0]))(jp)
    want["grads"] = [np.asarray(g) for g in jax.tree.leaves(grads)]
    logits, cache = jax.jit(jm.prefill)(
        jp, _jax_batch(tokens[:, :S], extra),
        jm.init_cache(B, MAX_SEQ, enc_len=enc_len))
    want["prefill"], want["prefill_cache"] = logits, jax.device_get(cache)
    decode = jax.jit(jm.decode_step)
    want["decode"] = []
    for t in range(S, S + STEPS):
        logits, cache = decode(jp, cache,
                               jnp.asarray(tokens[:, t:t + 1], jnp.int32))
        want["decode"].append(logits)
    want["decode_cache"] = jax.device_get(cache)
    model = build_model(cfg)
    params = params_from_jax(jax.device_get(jp), cfg, device=CPU)
    return Family(arch, jm, jp, cfg, model, params, tokens, labels, extra,
                  want, enc_len)


def forward(f: Family) -> tuple[torch.Tensor, torch.Tensor]:
    """The port's forward over the prompt and its continuation."""
    with torch.no_grad():
        return f.model.forward(f.params, torch_batch(f.tokens, f.extra))


def check_forward(f: Family) -> None:
    logits, aux = forward(f)
    np.testing.assert_allclose(np32(logits), np32(f.want["forward"]), **TOL)
    np.testing.assert_allclose(float(aux), float(f.want["aux"]), **TOL)


def check_loss_and_grads(f: Family) -> None:
    ps = [p.requires_grad_(True) for p in leaves(f.params)]
    try:
        loss, _ = f.model.loss(f.params, torch_batch(f.tokens[:, :S], f.extra,
                                                     labels=f.labels))
        grads = torch.autograd.grad(loss, ps)
    finally:
        for p in ps:
            p.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(f.want["loss"]), **TOL)
    assert len(grads) == len(f.want["grads"])
    for (path, _), g, w in zip(leaves_with_paths(f.params), grads,
                               f.want["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=str(path))


def _assert_caches_equal(got, want) -> None:
    got, want = leaves_with_paths(got), leaves_with_paths(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(w), **TOL,
                                   err_msg=str(path))


def prefill(f: Family):
    cache = f.model.init_cache(B, MAX_SEQ, enc_len=f.enc_len, device=CPU)
    with torch.no_grad():
        return f.model.prefill(
            f.params, torch_batch(f.tokens[:, :S], f.extra), cache)


def check_prefill(f: Family) -> None:
    """Prefill logits and cache against the JAX package's, and the last
    logits against the port's own forward at position S - 1."""
    full, _ = forward(f)
    logits, cache = prefill(f)
    np.testing.assert_allclose(np32(logits), np32(f.want["prefill"]), **TOL)
    np.testing.assert_allclose(np32(logits[:, -1]), np32(full[:, S - 1]),
                               **TOL)
    _assert_caches_equal(cache, f.want["prefill_cache"])


def check_decode(f: Family) -> None:
    """Four decode steps after the prefill: each step's logits against the
    JAX package's and against the forward over the extended tokens (the
    multi-token decode tolerance); the cache after them against the JAX
    package's."""
    full, _ = forward(f)
    _, cache = prefill(f)
    for i, t in enumerate(range(S, S + STEPS)):
        with torch.no_grad():
            logits, cache = f.model.decode_step(
                f.params, cache, torch.from_numpy(f.tokens[:, t:t + 1]))
        np.testing.assert_allclose(np32(logits), np32(f.want["decode"][i]),
                                   **TOL)
        np.testing.assert_allclose(np32(logits[:, -1]), np32(full[:, t]),
                                   **DECODE_TOL)
    _assert_caches_equal(cache, f.want["decode_cache"])


def check_cache_tree(f: Family) -> None:
    """A fresh cache has the reference's paths, shapes and dtypes, and the
    same logical-axis spec tree."""
    got = leaves_with_paths(f.model.init_cache(3, MAX_SEQ, enc_len=5,
                                               device=CPU))
    want = leaves_with_paths(jax.device_get(f.jm.init_cache(3, MAX_SEQ,
                                                            enc_len=5)))
    assert [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in got] == \
        [(p, tuple(np.shape(t)), str(np.asarray(t).dtype)) for p, t in want]
    assert f.model.cache_specs() == f.jm.cache_specs()


def requests(vocab):
    """Two prompts sharing a 2-page prefix (pages of 4), two identical
    prompts (a COW fork on their first decode write), one unrelated."""
    rng = np.random.RandomState(24)
    pre = rng.randint(0, vocab, size=8)
    same = rng.randint(0, vocab, size=11)
    prompts = [np.concatenate([pre, rng.randint(0, vocab, size=3)]),
               np.concatenate([pre, rng.randint(0, vocab, size=3)]),
               same, same.copy(), rng.randint(0, vocab, size=11)]
    return [(i, pr, 3 + i % 3) for i, pr in enumerate(prompts)]


MODES = {"dense": {}, "paged": dict(paged_kv=True, page_tokens=4),
         "prefix_share": dict(paged_kv=True, page_tokens=4,
                              prefix_share=True)}


def jax_engine_tokens(f: Family, mode: str) -> dict:
    eng = JServeEngine(f.jm, f.jp, n_slots=3, max_seq=MAX_SEQ, **MODES[mode])
    for rid, prompt, n in requests(f.cfg.vocab):
        eng.submit(JRequest(rid, prompt, n))
    return {c.rid: c.tokens for c in eng.run()}


def port_engine(f: Family, mode: str) -> tuple[ServeEngine, dict]:
    eng = ServeEngine(f.model, f.params, n_slots=3, max_seq=MAX_SEQ,
                      **MODES[mode])
    for rid, prompt, n in requests(f.cfg.vocab):
        eng.submit(Request(rid, prompt, n))
    return eng, {c.rid: c.tokens for c in eng.run(strict=True)}


__all__ = ["CPU", "B", "S", "STEPS", "MAX_SEQ", "FRAMES", "TOL",
           "DECODE_TOL", "Family", "reference", "forward", "check_forward",
           "check_loss_and_grads", "check_prefill", "check_decode",
           "check_cache_tree", "prefill", "requests", "MODES",
           "jax_engine_tokens", "port_engine", "np32", "torch_batch"]
