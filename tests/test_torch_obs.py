"""The port's span recorder (``repro_torch.obs``) and the spans the serving
engine, the model stack and the RMA window record: off it keeps nothing,
on (``recording()`` or a profiler) it nests, and a profiler's events hold
no span."""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import tiny_config
from repro_torch.models import build_model


@pytest.fixture(autouse=True)
def fresh():
    obs.clear()
    yield
    obs.clear()


def test_off_records_nothing_and_shares_the_noop():
    a, b = obs.span("x"), obs.span("y", rid=3)
    assert a is b and not a
    with a:
        with b:
            pass
    assert obs.spans() == []


def _profiled():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_recording_and_a_profiler_record(how):
    ctx = obs.recording() if how == "recording" else _profiled()
    with ctx:
        with obs.span("outer", rows=2) as sp:
            assert sp
            sp.attrs["late"] = 1
    with obs.span("after"):
        pass
    (s,) = obs.spans()
    assert s.name == "outer" and s.parent is None
    assert s.attrs == {"rows": 2, "late": 1} and s.t1 >= s.t0


def test_parents_nest():
    with obs.recording():
        with obs.span("a"):
            with obs.span("b"):
                with obs.span("c"):
                    pass
            with obs.span("d"):
                pass
        with obs.span("e"):
            pass
    got = [(s.name, s.parent) for s in obs.spans()]
    assert got == [("a", None), ("b", 0), ("c", 1), ("d", 0), ("e", None)]
    sp = obs.spans()
    assert sp[0].t0 <= sp[1].t0 <= sp[2].t0 <= sp[2].t1 <= sp[1].t1 \
        <= sp[3].t0 <= sp[3].t1 <= sp[0].t1 <= sp[4].t0


def test_a_profiled_run_holds_no_span_event():
    with _profiled() as prof:
        with obs.span("serve.decode"):
            torch.ones(4).add_(1)
    assert [s.name for s in obs.spans()] == ["serve.decode"]
    names = {e.name for e in prof.events()}
    assert "aten::add_" in names and "serve.decode" not in names


def _tree(spans):
    """name → the set of its parents' names."""
    out = {}
    for s in spans:
        parent = spans[s.parent].name if s.parent is not None else None
        out.setdefault(s.name, set()).add(parent)
    return out


def test_serve_engine_span_tree():
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = tiny_config("jamba-v0.1-52b")
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(0, device="cpu"), n_slots=2,
                      max_seq=64, paged_kv=True, page_tokens=16)
    rng = np.random.default_rng(0)
    for rid in range(3):
        eng.submit(Request(rid, rng.integers(0, cfg.vocab, 20), 3))
    with obs.recording():
        done = eng.run(strict=True)
    assert sorted(c.rid for c in done) == [0, 1, 2]
    spans = obs.spans()
    tree = _tree(spans)
    assert tree["serve.tick"] == {None}
    assert tree["serve.admit"] == {"serve.tick"}
    assert tree["sched.select"] == tree["serve.prefill"] == {"serve.admit"}
    assert tree["serve.decode"] == {"serve.tick"}
    for part in ("decode.h2d", "decode.model", "decode.read"):
        assert tree[part] == {"serve.decode"}
    for layer in ("layer.mamba", "layer.gqa", "layer.dense", "layer.moe"):
        assert tree[layer] == {"serve.prefill", "decode.model"}
    assert tree["stack.slice"] == tree["model.head"] == \
        {"serve.prefill", "decode.model"}
    ticks = [s for s in spans if s.name == "serve.tick"]
    assert [s.attrs["tick"] for s in ticks] == list(range(len(ticks)))
    pre = [s for s in spans if s.name == "serve.prefill"]
    assert [s.attrs["rid"] for s in pre] == [0, 1, 2]
    assert all(s.attrs["tokens"] == 20 for s in pre)
    # the submit time is the scheduler's entry's: before the span's start
    assert all(s.attrs["submitted"] < s.t0 for s in pre)
    picked = [r for s in spans if s.name == "sched.select"
              for r in s.attrs["picked"]]
    assert picked == [0, 1, 2]
    rows = [s.attrs["rows"] for s in spans if s.name == "serve.decode"]
    assert rows and all(1 <= r <= 2 for r in rows)


def test_ring_train_step_records_window_ops():
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step

    cfg = tiny_config("qwen3-4b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    step = make_train_step(model, OptimizerConfig(warmup_steps=0,
                                                  total_steps=2),
                           grad_sync="rma_ring", data_axis_size=4)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, 8)))
             for k in ("tokens", "labels")}
    with obs.recording():
        params, _, metrics = step(params, init_opt_state(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    spans = obs.spans()
    names = [s.name for s in spans]
    for op in ("rma.allocate", "rma.dup", "rma.execute"):
        assert names.count(op) == 1, op
    (ex,) = [s for s in spans if s.name == "rma.execute"]
    assert ex.attrs["plan"] and ex.parent is None
    assert names.count("model.head") == 4          # one forward a rank
