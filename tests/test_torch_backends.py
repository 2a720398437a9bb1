"""Parity of the port's plan backends with the JAX package
(``tests/test_backends.py``): the walker (``interpret_plan``) against the
port's own substrate (``vmapped_execute``) and the reference's walker on a
fixed corpus, bit for bit; the ring and all-to-all macros on ``rma``,
``gspmd`` and ``interpret`` with their phase tables, phases, backend and
selection records equal to the reference's; the decline of an ``op="max"``
exchange; ``auto`` with a missing, corrupt or calibrated table; handle
plans under the walker; and the backends threaded through the train step,
the MoE exchange, the page push and migration.  Both packages' backend and
accumulate tables point at a nonexistent path unless a test writes one.
Inputs are numpy arrays from a seed."""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rma as J
from repro.core.rma.alltoall import all_to_all_plan as j_a2a_plan
from repro.core.rma.backends import costmodel as j_costmodel
from repro.core.rma.collectives import all_reduce_plan as j_ar_plan
from repro.core.rma.collectives import plan_all_reduce as j_plan_ar
from repro.ft import elastic as j_elastic
from repro.serve import paged as j_paged

from repro_torch.core import rma as T
from repro_torch.core.rma import backends as t_backends
from repro_torch.core.rma.alltoall import all_to_all_plan, plan_all_to_all
from repro_torch.core.rma.backends import costmodel, gspmd
from repro_torch.core.rma.collectives import all_reduce_plan, plan_all_reduce
from repro_torch.ft import elastic as t_elastic
from repro_torch.serve import paged as t_paged

B, D = 16, 4          # window length, op payload length (the reference's)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    for var in ("RMA_ACC_BENCH_JSON", "RMA_TORCH_ACC_BENCH_JSON",
                "RMA_BACKEND_BENCH_JSON", "RMA_TORCH_BACKEND_BENCH_JSON"):
        monkeypatch.setenv(var, "/nonexistent")
    monkeypatch.delenv("RMA_ACC_CROSSOVER", raising=False)
    monkeypatch.delenv("RMA_TOPOLOGY", raising=False)


def _reset_costmodels():
    for cm in (costmodel, j_costmodel):
        cm._cache.clear()
        cm._warned.clear()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the fixed corpus: port walker = port substrate = reference walker
# ---------------------------------------------------------------------------

def _perm(n: int, rev: bool):
    return tuple((i, (i - 1) % n) if rev else (i, (i + 1) % n)
                 for i in range(n))


def _build(mod, n, dtype, scope, ops):
    """One corpus plan (``tests/test_backends.py::_build``) in ``mod``; the
    compute closure reads the rank as each package gives it."""
    jax_side = mod is J
    plan = mod.RmaPlan(f"corpus[{n}]")
    plan.window("w", scope=scope, order=True, max_streams=2, same_op="sum",
                accumulate_ops=("sum",), dtype=dtype, exit_epoch=True)
    plan.bind("x", (D,), dtype)
    outs = []
    for i, (kind, rev, slot) in enumerate(ops):
        perm = _perm(n, rev)
        off = slot * D
        if kind == "put":
            plan.put("w", "x", perm, offset=off, label=f"put{i}")
        elif kind == "acc":
            plan.accumulate("w", "x", perm, op="sum", offset=off,
                            label=f"acc{i}")
        elif kind == "get":
            outs.append((f"get{i}", plan.get("w", perm, offset=off, size=2,
                                             label=f"get{i}")))
        elif kind == "send":
            outs.append((f"send{i}", plan.send("w", "x", perm, shape=(D,),
                                               dtype=dtype,
                                               label=f"send{i}")))
        elif kind == "fetch":
            outs.append((f"fetch{i}", plan.fetch_op("w", "x", perm, op="sum",
                                                    offset=off,
                                                    label=f"fetch{i}")))
        elif kind == "sig":
            plan.signal("w", perm, flag_offset=3 * D + slot, label=f"sig{i}")
        elif kind == "compute":
            if jax_side:
                fn = (lambda env: env["x"] * 2
                      + jax.lax.axis_index("x").astype(env["x"].dtype))
            else:
                fn = (lambda env: env["x"] * 2
                      + env.ranks[:, None].to(env["x"].dtype))
            outs.append((f"cmp{i}", plan.compute(fn, shape=(D,), dtype=dtype,
                                                 label=f"cmp{i}")))
    for name, ref in outs:
        plan.output(name, ref)
    return plan.compile()


FIXED_CASES = [
    (4, "float32", "thread",
     [("put", False, 0), ("acc", False, 1), ("get", True, 0),
      ("fetch", False, 2), ("sig", True, 0), ("compute", False, 0)]),
    (4, "int32", "process",
     [("acc", True, 0), ("put", False, 2), ("send", False, 0),
      ("fetch", True, 1), ("sig", False, 1)]),
    (2, "float32", "process",
     [("send", True, 0), ("get", False, 1), ("put", True, 1),
      ("compute", True, 0), ("acc", False, 0)]),
    (2, "int32", "thread",
     [("fetch", False, 0), ("sig", False, 2), ("get", False, 2),
      ("put", False, 0), ("send", False, 1)]),
    (4, "float32", "thread",
     [("put", False, 1), ("put", True, 1), ("acc", False, 1),
      ("acc", True, 1), ("get", False, 1)]),
]


@pytest.mark.parametrize("case", FIXED_CASES,
                         ids=[f"case{i}" for i in range(len(FIXED_CASES))])
def test_corpus_three_ways_bit_identical(case):
    n, dtype, scope, ops = case
    x = ((np.arange(n * D).reshape(n, D) % 7) + 1).astype(dtype)
    jc, tc = _build(J, n, getattr(jnp, dtype), scope, ops), \
        _build(T, n, dtype, scope, ops)
    assert tc.phase_table() == jc.phase_table() and tc.phases == jc.phases
    want = J.interpret_plan(jc, {"w": jnp.zeros((n, B), dtype)},
                            {"x": jnp.asarray(x)})
    tbuf = {"w": torch.zeros((n, B), dtype=getattr(torch, dtype))}
    tx = {"x": torch.from_numpy(x)}
    for runner in (T.interpret_plan, T.vmapped_execute):
        got = runner(tc, tbuf, tx)
        np.testing.assert_array_equal(_np(got.buffers["w"]),
                                      _np(want.buffers["w"]),
                                      err_msg=runner.__name__)
        assert set(got.outputs) == set(want.outputs)
        for name in want.outputs:
            np.testing.assert_array_equal(_np(got.outputs[name]),
                                          _np(want.outputs[name]),
                                          err_msg=f"{runner.__name__} {name}")
        assert not got.err_count.any()
    assert not tbuf["w"].any(), "the walk must not write its input buffers"


def test_walker_imports_no_substrate_or_kernel():
    import inspect

    from repro_torch.core.rma.backends import interpret

    src = inspect.getsource(interpret)
    imports = [ln for ln in src.splitlines()
               if ln.lstrip().startswith(("import ", "from "))]
    assert not [ln for ln in imports
                if "substrate" in ln or "kernels" in ln], imports


# ---------------------------------------------------------------------------
# the macros on every backend
# ---------------------------------------------------------------------------

def _same_compile(tc, jc):
    assert tc.backend == jc.backend
    assert tc.phases == jc.phases
    assert tc.phase_table() == jc.phase_table()
    assert tc.lowering[:len(jc.lowering)] == jc.lowering


@pytest.mark.parametrize("backend", ["rma", "gspmd", "interpret"])
def test_ring_macro_backend_bit_identical(backend):
    n, r = 4, 8
    x = (np.arange(n * r).reshape(n, r) % 5).astype(np.float32)
    want = np.tile(x.sum(0), (n, 1))
    tc = all_reduce_plan("x", n, (r,), torch.float32, order=True,
                         backend=backend)
    jc = j_ar_plan("x", n, (r,), jnp.float32, order=True, backend=backend)
    _same_compile(tc, jc)
    tx = torch.from_numpy(x)
    for runner in (T.interpret_plan, T.vmapped_execute):
        res = runner(tc, {"ring": torch.zeros_like(tx)}, {"x": tx})
        np.testing.assert_array_equal(_np(res.outputs["out"]), want,
                                      err_msg=runner.__name__)
    got = plan_all_reduce(tx, "x", n, backend=backend)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(j_plan_ar(jnp.asarray(x), "x", n, backend="interpret")),
        want)
    if backend == "gspmd":
        assert tc.phase_table()[0] == ("backend[gspmd]", 0)
        assert tc.phase_table()[1][0] == "gspmd:psum[ring[ring]]"
        assert not tc.kernel_macros, "K5 must not take a collective's range"
        # the sum is computed once and broadcast, not copied per rank
        assert got.stride(0) == 0
    if backend == "rma":
        assert [low[1] for low in tc.lowering] == ["k5"]


@pytest.mark.parametrize("backend", ["rma", "gspmd", "interpret"])
@pytest.mark.parametrize("op", [None, "sum"])
def test_a2a_macro_backend_bit_identical(backend, op):
    n, m, d = 4, 2, 3
    x = (np.arange(n * n * m * d).reshape(n, n * m, d) % 9).astype(
        np.float32)
    want = np.swapaxes(x.reshape(n, n, m, d), 0, 1).reshape(n, n * m, d)
    cnts = np.tile((np.arange(n) % (m + 1))[None], (n, 1)).astype(np.int32)
    tc = all_to_all_plan("x", n, (n * m, d), torch.float32, op=op,
                         backend=backend)
    jc = j_a2a_plan("x", n, (n * m, d), jnp.float32, op=op, backend=backend)
    _same_compile(tc, jc)
    tx, tcnt = torch.from_numpy(x), torch.from_numpy(cnts)
    bufs = {"data": torch.zeros_like(tx),
            "hdr": torch.zeros((n, 2 * n), dtype=torch.int32)}
    results = [runner(tc, bufs, {"x": tx, "counts": tcnt}).outputs
               for runner in (T.interpret_plan, T.vmapped_execute)]
    res = plan_all_to_all(tx, "x", n, counts=tcnt, op=op, backend=backend)
    results.append({"out": res.data, "counts": res.counts,
                    "bells": res.bells})
    bells = np.ones((n, n), np.int32) - np.eye(n, dtype=np.int32)
    for got in results:
        np.testing.assert_array_equal(_np(got["out"]), want)
        np.testing.assert_array_equal(_np(got["counts"]), cnts.T)
        np.testing.assert_array_equal(_np(got["bells"]), bells)
    if backend == "gspmd":
        assert tc.phase_table() == [("backend[gspmd]", 0),
                                    ("gspmd:all_to_all[a2a[data]]", 0)]
        assert tc.signal_pairs == (), "K4/K6 must not pair inside it"


def test_gspmd_declines_unsupported_landing_op():
    tc = all_to_all_plan("x", 4, (8, 2), torch.float32, op="max",
                         backend="gspmd")
    jc = j_a2a_plan("x", 4, (8, 2), jnp.float32, op="max", backend="gspmd")
    assert tc.backend == "rma", "an op='max' exchange has no collective"
    label, target, why = tc.lowering[0]
    assert target == "rma" and "max" in why
    _same_compile(tc, jc)


def test_backend_protocol_surface():
    assert T.BACKEND_NAMES == J.BACKEND_NAMES == (
        "auto", "rma", "gspmd", "interpret")
    assert isinstance(gspmd, T.Backend)
    assert set(t_backends.__all__) == set(
        __import__("repro.core.rma.backends", fromlist=["x"]).__all__)
    with pytest.raises(T.PlanError, match="unknown backend"):
        T.RmaPlan("x").compile(backend="xla")


# ---------------------------------------------------------------------------
# auto: never raises on a bad table, picks the measured minimum
# ---------------------------------------------------------------------------

def test_auto_missing_table_falls_back_with_one_warning(tmp_path,
                                                        monkeypatch):
    missing = str(tmp_path / "never_written.json")
    monkeypatch.setenv("RMA_TORCH_BACKEND_BENCH_JSON", missing)
    monkeypatch.setenv("RMA_BACKEND_BENCH_JSON", missing)
    _reset_costmodels()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c1 = all_reduce_plan("x", 4, (12,), torch.float32, backend="auto")
        c2 = all_to_all_plan("x", 4, (8, 3), torch.float32, backend="auto")
    assert c1.backend == "rma" and c2.backend == "rma" and c1.phases > 0
    hits = [w for w in caught if issubclass(w.category, UserWarning)
            and "BENCH_backends" in str(w.message)]
    assert len(hits) == 1, [str(w.message) for w in caught]
    assert missing in str(hits[0].message)
    assert "item 6" in str(hits[0].message)
    # the compile-level record, both packages
    tplan, jplan = T.RmaPlan("r"), J.RmaPlan("r")
    for mod, plan, dt in ((T, tplan, torch.float32), (J, jplan, jnp.float32)):
        plan.window("ring", order=True, same_op="sum")
        plan.bind("x", (8,), dt)
        plan.output("out", plan.ring_all_reduce("ring", "x", "x", 4,
                                                shape=(8,), dtype=dt))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same_compile(tplan.compile(backend="auto"),
                      jplan.compile(backend="auto"))


@pytest.mark.parametrize("payload", [
    "{ not json at all",
    '{"rows": "not-a-list"}',
    '{"rows": [{"name": "backend_matrix/ring/rma"}]}',
    '{"rows": [{"name": "backend_matrix/ring/rma", "us_per_call": 1.0}]}',
], ids=["garbage", "wrong-type", "no-latency", "incomplete"])
def test_auto_corrupt_table_falls_back(tmp_path, monkeypatch, payload):
    bad = tmp_path / "bad.json"
    bad.write_text(payload)
    monkeypatch.setenv("RMA_TORCH_BACKEND_BENCH_JSON", str(bad))
    _reset_costmodels()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        target, _ = costmodel.choose("ring")
        compiled = all_reduce_plan("x", 4, (20,), torch.float32,
                                   backend="auto")
        again = costmodel.choose("ring")
    assert target == again[0] == "rma" and compiled.backend == "rma"
    assert sum(issubclass(w.category, UserWarning) for w in caught) == 1


def test_auto_picks_the_measured_minimum(tmp_path, monkeypatch):
    table = tmp_path / "BENCH_backends_h100.json"
    rows = [("ring", "rma", 16480.0), ("ring", "gspmd", 15350.5),
            ("ring", "interpret", 9e5), ("a2a", "rma", 40.0),
            ("a2a", "gspmd", 55.25)]
    table.write_text(json.dumps({"rows": [
        {"name": f"backend_matrix/{p}/{b}", "us_per_call": us}
        for p, b, us in rows]}))
    monkeypatch.setenv("RMA_TORCH_BACKEND_BENCH_JSON", str(table))
    monkeypatch.setenv("RMA_BACKEND_BENCH_JSON", str(table))
    _reset_costmodels()
    with warnings.catch_warnings():
        warnings.simplefilter("error")    # a calibrated table never warns
        assert costmodel.choose("ring") == j_costmodel.choose("ring")
        assert costmodel.choose("ring")[0] == "gspmd"
        assert costmodel.choose("a2a") == j_costmodel.choose("a2a")
        assert costmodel.choose("a2a")[0] == "rma"
        ring = all_reduce_plan("x", 4, (24,), torch.float32, backend="auto")
        a2a = all_to_all_plan("x", 4, (8, 3), torch.float32, backend="auto")
    assert ring.backend == "gspmd" and ring.phases == 0
    assert a2a.backend == "rma" and a2a.phases > 0
    tplan = T.RmaPlan("r")
    tplan.window("ring", order=True, same_op="sum")
    tplan.bind("x", (8,), torch.float32)
    tplan.output("out", tplan.ring_all_reduce("ring", "x", "x", 4,
                                              shape=(8,),
                                              dtype=torch.float32))
    compiled = tplan.compile(backend="auto")
    assert compiled.backend == "gspmd"
    assert compiled.lowering[0] == (
        "ring[ring]", "gspmd", "measured 15350.5us on gspmd vs 16480.0us "
        "on rma")
    assert costmodel.load_table() == {
        "ring": {"rma": 16480.0, "gspmd": 15350.5, "interpret": 9e5},
        "a2a": {"rma": 40.0, "gspmd": 55.25}}
    # naive_flush measures the substrate: no selection at all
    assert tplan.compile(backend="auto", naive_flush=True).backend == "rma"


# ---------------------------------------------------------------------------
# handle plans under the walker (tests/test_kv_tier.py:294-360)
# ---------------------------------------------------------------------------

def test_tier_step_interpret_with_regs_matches_reference():
    elems = 8
    jc = j_paged.tier_step_plan(4, (0, 1), (), elems, jnp.float32)
    tc = t_paged.tier_step_plan(4, (0, 1), (), elems, torch.float32)
    assert tc.phase_table() == jc.phase_table()
    buf = np.arange(4 * elems, dtype=np.float32)
    handles = np.zeros((4, 4), np.int32)
    handles[0] = [3, 0, elems, 0]
    handles[1] = [3, elems, elems, 1]
    regs = np.zeros((4, 3), np.int32)
    regs[0] = [3, 0, elems]           # slot 0 live, slot 1 released
    want = jc.interpret({"host": jnp.asarray(buf)[None]},
                        {"handles": jnp.asarray(handles)[None]},
                        regs={"host": jnp.asarray(regs)[None]})
    got = tc.interpret({"host": torch.from_numpy(buf)[None]},
                       {"handles": torch.from_numpy(handles)[None]},
                       regs={"host": torch.from_numpy(regs)[None]})
    np.testing.assert_array_equal(got.outputs["promoted"].numpy(),
                                  np.asarray(want.outputs["promoted"]))
    np.testing.assert_array_equal(got.err_count.numpy(),
                                  np.asarray(want.err_count))
    assert got.err_count.tolist() == [1]
    # a demote through a stale handle is dropped and counted the same way
    jd = j_paged.tier_step_plan(4, (), (0, 1), elems, jnp.float32)
    td = t_paged.tier_step_plan(4, (), (0, 1), elems, torch.float32)
    cold = np.full((1, elems), 5.0, np.float32)
    want = jd.interpret({"host": jnp.zeros((1, 4 * elems))},
                        {"handles": jnp.asarray(handles)[None],
                         "cold0": jnp.asarray(cold),
                         "cold1": jnp.asarray(cold) + 1},
                        regs={"host": jnp.asarray(regs)[None]})
    got = td.interpret({"host": torch.zeros((1, 4 * elems))},
                       {"handles": torch.from_numpy(handles)[None],
                        "cold0": torch.from_numpy(cold),
                        "cold1": torch.from_numpy(cold) + 1},
                       regs={"host": torch.from_numpy(regs)[None]})
    np.testing.assert_array_equal(got.buffers["host"].numpy(),
                                  np.asarray(want.buffers["host"]))
    np.testing.assert_array_equal(got.err_count.numpy(),
                                  np.asarray(want.err_count))


def test_interpret_without_regs_rejects_handle_plans():
    tc = t_paged.tier_step_plan(4, (0,), (), 8, torch.float32)
    with pytest.raises(NotImplementedError, match="memory-handle"):
        tc.interpret({"host": torch.zeros((1, 32))},
                     {"handles": torch.zeros((1, 4, 4), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# the backends threaded through training, the MoE exchange, paging
# ---------------------------------------------------------------------------

N, BATCH, SEQ = 4, 8, 16
OPT = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10)
TIGHT = dict(atol=1e-5, rtol=1e-5)    # tests/test_torch_train.py
OPT_EPS = 1e-8


@pytest.fixture(scope="module")
def qwen():
    """Tiny qwen3-4b: the reference's params and its meshless ring step
    (per-rank ``jax.grad`` → ``plan_all_reduce(backend="interpret")`` → /n
    → AdamW)."""
    from repro.configs.tiny import tiny_config as j_tiny_config
    from repro.models import build_model as j_build_model
    from repro.train.optimizer import OptimizerConfig as JOpt
    from repro.train.optimizer import adamw_update as j_adamw
    from repro.train.optimizer import init_opt_state as j_init_opt

    cfg = j_tiny_config("qwen3-4b")
    model = j_build_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    per = BATCH // N
    vecs, losses = [], []
    for r in range(N):
        loss, g = grad_fn(params, {k: jnp.asarray(v[r * per:(r + 1) * per])
                                   for k, v in batch.items()})
        flat, tdef = jax.tree.flatten(g)
        losses.append(float(loss))
        vecs.append(jnp.concatenate([x.reshape(-1) for x in flat]))
    vec = j_plan_ar(jnp.stack(vecs), "x", N, backend="interpret")[0] / N
    out, off = [], 0
    for x in flat:
        out.append(vec[off:off + x.size].reshape(x.shape))
        off += x.size
    new, _, _ = j_adamw(jax.tree.unflatten(tdef, out),
                        j_init_opt(params), params, JOpt(**OPT))
    return dict(params=jax.device_get(params), batch=batch,
                loss=float(np.mean(losses)),
                grads=[np.asarray(x) for x in out],
                new=[np.asarray(x) for x in jax.tree.leaves(new)])


def _qwen_step(qwen, backend):
    from repro_torch.configs import tiny_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step
    from repro_torch.tree import leaves

    cfg = tiny_config("qwen3-4b")
    params = params_from_jax(qwen["params"], cfg, device="cpu")
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in qwen["batch"].items()}
    step = make_train_step(build_model(cfg), OptimizerConfig(**OPT),
                           grad_sync="rma_ring", data_axis="x",
                           data_axis_size=N, backend=backend)
    params, _, metrics = step(params, init_opt_state(params), batch)
    return [p.detach().numpy() for p in leaves(params)], metrics


@pytest.mark.parametrize("backend", ["gspmd", "auto"])
def test_train_step_backend_matches_rma_and_reference(qwen, backend):
    _reset_costmodels()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, metrics = _qwen_step(qwen, backend)
    rma, rma_metrics = _qwen_step(qwen, "rma")
    np.testing.assert_allclose(float(metrics["loss"]), qwen["loss"], **TIGHT)
    assert float(metrics["loss"]) == float(rma_metrics["loss"])
    # gspmd sums the rows in another order than the ring (floats
    # reassociate): tests/test_torch_train.py's update check, both ways
    for p, r, w, g in zip(got, rma, qwen["new"], qwen["grads"]):
        ok = np.abs(g) > 100 * OPT_EPS
        for want in (r, w):
            np.testing.assert_allclose(p[ok], want[ok], **TIGHT)
            np.testing.assert_allclose(p, want, atol=3e-3, rtol=1e-2)
    if backend == "gspmd":
        assert metrics["phases"] == 0, "a collective bills no ring phase"
    else:      # no table: auto is the substrate, bit for bit
        assert metrics["phases"] == rma_metrics["phases"] == 2 * N
        for p, r in zip(got, rma):
            np.testing.assert_array_equal(p, r)


def test_train_step_rejects_interpret():
    from repro_torch.configs import tiny_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainstep import make_train_step

    with pytest.raises(ValueError, match="invalid for a train step"):
        make_train_step(build_model(tiny_config("qwen3-4b")),
                        OptimizerConfig(total_steps=1), backend="interpret")


def test_moe_step_ep_backend_equals_rma_bit_for_bit():
    """One expert-parallel train step of tiny llama4 per ``ep_backend``:
    the exchange and the sum combine into zeroed slots are exact copies,
    so loss, aux and every updated parameter equal the rma step's."""
    from repro_torch.configs import tiny_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step
    from repro_torch.tree import leaves

    base = tiny_config("llama4-maverick-400b-a17b")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, base.vocab, (4, 16)))
             for k in ("tokens", "labels")}
    runs = {}
    _reset_costmodels()
    for ep_backend in ("rma", "gspmd", "auto"):
        cfg = base.replace(moe=dataclasses.replace(base.moe,
                                                   ep_backend=ep_backend))
        model = build_model(cfg, ep_ranks=4)
        params = model.init(0, device="cpu")
        step = make_train_step(model, OptimizerConfig(**OPT), moe_ep="rma",
                               ep_ranks=4)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            params, _, metrics = step(params, init_opt_state(params), batch)
        runs[ep_backend] = (metrics, [p.clone() for p in leaves(params)])
    m0, p0 = runs["rma"]
    for ep_backend in ("gspmd", "auto"):
        m, p = runs[ep_backend]
        for key in ("loss", "xent", "aux", "grad_norm"):
            assert torch.equal(m[key], m0[key]), (ep_backend, key)
        for a, b in zip(p, p0):
            assert torch.equal(a, b), ep_backend


def test_page_push_and_migration_under_gspmd():
    """Macro-free plans compile under ``gspmd`` and ``interpret`` as the
    reference's do (the substrate schedule; ``interpret`` tagged), and a
    migration under ``gspmd`` moves the pages exactly as under ``rma``."""
    for backend, want in (("gspmd", "rma"), ("interpret", "interpret"),
                          ("auto", "rma")):
        jc = j_paged.transfer_plan(5, (2, 3), 8, jnp.float32, ((0, 0),),
                                   backend=backend)
        tc = t_paged.transfer_plan(5, (2, 3), 8, torch.float32, ((0, 0),),
                                   backend=backend)
        assert tc.backend == jc.backend == want
        assert tc.phase_table() == jc.phase_table()
        assert tc.phases == jc.phases == 2 * 2 + 2
        jt = j_paged.tier_step_plan(4, (0,), (1,), 8, jnp.float32,
                                    backend=backend)
        tt = t_paged.tier_step_plan(4, (0,), (1,), 8, torch.float32,
                                    backend=backend)
        assert tt.backend == jt.backend and \
            tt.phase_table() == jt.phase_table()
    spec = dict(page_tokens=2, kv_heads=1, head_dim=2, n_pages=5)
    pools = {}
    for backend in ("rma", "gspmd"):
        pool = t_paged.PagedKVWindow.create(t_paged.PageSpec(**spec), "x", 1,
                                            torch.float32, device="cpu")
        for p in (0, 1, 2, 3):
            pool.alloc_page(p)
        pool.write_page_local(0, torch.full((1, 2, 2, 1, 2), 3.0))
        pool.write_page_local(1, torch.full((1, 2, 2, 1, 2), 7.0))
        pool, n = t_elastic.migrate_pages(pool, [(0, 2), (1, 3)], ((0, 0),),
                                          backend=backend)
        assert n == 2 and pool.err_count.tolist() == [0]
        pools[backend] = pool
    assert torch.equal(pools["gspmd"].window.buffer,
                       pools["rma"].window.buffer)
    assert pools["gspmd"].window.ledger.total == \
        pools["rma"].window.ledger.total == 2 * 2 + 2
    assert j_elastic.MIGRATION_STREAM == t_elastic.MIGRATION_STREAM
