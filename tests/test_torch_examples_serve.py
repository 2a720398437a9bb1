"""The port's ``examples_torch/serve_decode.py`` and ``train_lm.py`` on the
CPU against the JAX package.

``serve_decode``: part 1's greedy tokens equal the JAX engine's at the
example's own widths with the weights carried over by
``convert.params_from_jax``; part 2's admission and COW lines equal the
reference example's (they depend on token counts only, never on weights)
and its shared and unshared tokens are bit-identical; part 3 ships a page
to every peer through its handle (14.0 there) and drops one stale write a
rank.  ``train_lm``: ``model_100m()`` is the reference's configuration, and
one step at that width (batch 2 x 32, the weights carried over) gives the
JAX step's loss and gradient norm.  Its 300-step learning assert needs the
card (``chip_smoke.py`` ``[examples]``)."""
import dataclasses
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: float32 loss and gradient norm: the two packages differ only in
#: summation order (tests/test_torch_train.py)
TIGHT = dict(atol=1e-5, rtol=1e-5)


def load_example(name: str):
    """The port's example module ``examples_torch/<name>.py``."""
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def serve_ex():
    return load_example("serve_decode")


@pytest.fixture(scope="module")
def reference_serve_output():
    """The reference's ``examples/serve_decode.py``, run as its verify
    recipe runs it, started first so it overlaps the in-process work."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable,
                             str(ROOT / "examples" / "serve_decode.py")],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _reference_text(proc) -> str:
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr
    return stdout


@pytest.fixture(scope="module")
def engine_parity(serve_ex, reference_serve_output):
    """The JAX engine's and the port's tokens at the example's config, on
    the same weights."""
    import jax
    from repro.models import build_model as j_build_model
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine

    from repro_torch.convert import params_from_jax

    cfg = serve_ex.engine_config()
    jm = j_build_model(cfg_jax(cfg))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jeng = JServeEngine(jm, jp, n_slots=4, max_seq=128)
    for r in serve_ex.engine_requests(cfg.vocab):
        jeng.submit(JRequest(r.rid, r.prompt, r.max_new_tokens))
    want = {c.rid: c.tokens for c in jeng.run()}
    got = serve_ex.engine_demo(
        CPU, params=params_from_jax(jax.device_get(jp), cfg, device="cpu"))
    return want, got


def cfg_jax(port_cfg):
    """The reference's configuration with the port's fields."""
    from repro.configs import get_config as j_get_config

    over = dataclasses.asdict(port_cfg)
    ref = j_get_config("qwen3-4b")
    return ref.replace(**{k: v for k, v in over.items()
                          if not dataclasses.is_dataclass(getattr(ref, k))
                          and v != getattr(ref, k)})


def test_engine_config_equals_reference(serve_ex):
    from repro.configs import get_config as j_get_config

    want = j_get_config("qwen3-4b").replace(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=1024, vocab=4096, max_seq=256,
        dtype="float32", param_dtype="float32")
    assert dataclasses.asdict(serve_ex.engine_config()) == \
        dataclasses.asdict(want)


def test_engine_tokens_equal_reference(engine_parity):
    want, got = engine_parity
    assert len(got) == 10
    assert got == want


def test_scheduler_and_cow_lines_equal_reference(serve_ex,
                                                 reference_serve_output,
                                                 capsys):
    outs = serve_ex.scheduler_and_cow_demo(CPU)
    assert outs[True] == outs[False]
    mine = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith(("[sched]", "[cow]"))]
    text = _reference_text(reference_serve_output)
    theirs = [l for l in text.splitlines()
              if l.startswith(("[sched]", "[cow]"))]
    assert mine == theirs
    assert any("pages_shared=" in l and "pages_shared=0" not in l
               for l in mine)


def test_paged_demo(serve_ex, capsys):
    received, dropped = serve_ex.paged_demo(CPU)
    assert received.tolist() == [14.0] * 8
    assert dropped.tolist() == [1] * 8
    out = capsys.readouterr().out
    assert "value at peer: 14.0" in out
    assert out.rstrip().endswith("PAGED OK")


def test_reference_paged_value_matches(reference_serve_output):
    text = _reference_text(reference_serve_output)
    assert re.search(r"value at peer: 14\.0", text)
    assert "PAGED OK" in text and "SERVE_DECODE OK" in text


def test_serve_main_prints_marker(serve_ex, capsys):
    out = serve_ex.main(["--device", "cpu"])
    assert len(out["tokens"]) == 10
    assert capsys.readouterr().out.rstrip().endswith("SERVE_DECODE OK")


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------


def test_model_100m_equals_reference():
    train_lm = load_example("train_lm")
    from repro.configs import get_config as j_get_config

    want = j_get_config("qwen3-4b").replace(
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
        d_ff=2048, vocab=8192, max_seq=512,
        dtype="float32", param_dtype="float32")
    got = train_lm.model_100m()
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


def test_train_lm_step_matches_reference():
    """One step of ``model_100m()`` at batch 2 x 32 with the reference's
    weights: loss, gradient norm and learning rate equal the JAX step's."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as j_build_model
    from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
    from repro.train.optimizer import init_opt_state as j_init_opt_state
    from repro.train.trainstep import make_train_step as j_make_train_step

    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainstep import make_train_step

    train_lm = load_example("train_lm")
    cfg = train_lm.model_100m()
    opt = train_lm.optimizer_config(300)
    jm = j_build_model(cfg_jax(cfg))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    jstep = jax.jit(j_make_train_step(jm, JOptimizerConfig(
        **dataclasses.asdict(opt))))
    _, _, jm_ = jstep(jp, j_init_opt_state(jp),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.device_get(jp), cfg, device="cpu")
    del jp
    step = make_train_step(build_model(cfg), opt)
    _, _, m = step(params, init_opt_state(params),
                   {k: torch.from_numpy(v.astype(np.int64))
                    for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), **TIGHT)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm_["grad_norm"]), **TIGHT)
    np.testing.assert_allclose(float(m["lr"]), float(jm_["lr"]), rtol=1e-6)


def test_serve_and_train_reject_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("serve_decode", "train_lm"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_example(name).main([])
