"""The metrics read from the program's own spans and CUDA-event parts, held
to hand-worked numbers on synthetic spans beside a synthetic device trace;
and a program without spans reads nothing."""
import sys
import types
from typing import NamedTuple

import pytest

from rmabench import harness, program_spans
from rmabench.trace import Trace


class Span(NamedTuple):      # the fields of repro_torch.obs.Span
    name: str
    t0: float
    t1: float
    parent: int | None
    attrs: dict


def S(name, t0, t1, **attrs):
    return Span(name, t0, t1, None, attrs)


# the card: busy [1.0, 2.0] (two overlapping kernels), [3.0, 3.4], [5.0, 5.5]
DEVICE = [(1.0, 1.5, "k1"), (1.2, 2.0, "k2"), (3.0, 3.4, "k1"),
          (5.0, 5.5, "k3")]

SERVE = [
    # request 9 picked first, handed back (pool pressure), picked again
    S("sched.select", 0.0, 0.02, picked=[9]),
    S("sched.select", 0.05, 0.1, picked=[7, 8]),
    S("serve.prefill", 0.15, 0.25, rid=7, tokens=10, submitted=0.01),
    S("serve.prefill", 0.25, 0.45, rid=8, tokens=10, submitted=0.03),
    S("sched.select", 4.0, 4.05, picked=[9]),
    S("serve.prefill", 4.3, 4.9, rid=9, tokens=10, submitted=0.1),
    S("serve.decode", 0.5, 2.5, rows=2),
    S("decode.model", 0.6, 2.2),
    S("serve.decode", 2.8, 3.6, rows=2),
    # outside the traced stretch [0, 10]: not read
    S("serve.decode", 9.5, 10.5, rows=2),
    S("serve.prefill", 9.6, 10.2, rid=11, tokens=10, submitted=9.0),
    S("sched.select", 9.5, 9.55, picked=[11]),
]

TRAIN = [
    S("rma.allocate", 1.1, 1.2), S("rma.dup", 1.2, 1.25),
    S("rma.execute", 1.5, 1.8, plan="ring"), S("rma.flush", 1.6, 1.7),
    S("layer.gqa", 1.0, 2.0), S("rma.execute", 3.5, 3.6, plan="ring"),
]

STEPS = [{"t0": 1.0, "t1": 3.0, "grads_ms": 85.0, "fwd.0.0_ms": 10.0,
          "fwd.1.0_ms": 12.0, "bwd.0.0_ms": 30.0, "bwd.1.0_ms": 31.0},
         {"t0": 3.0, "t1": 5.0, "grads_ms": 86.0, "fwd.0.0_ms": 11.0,
          "fwd.1.0_ms": 13.0, "bwd.0.0_ms": 29.0, "bwd.1.0_ms": 33.0}]


def _run(spans, monkeypatch, steps=(), traced=True):
    monkeypatch.setattr(program_spans, "_recorded", lambda: list(spans))
    tr = Trace(list(DEVICE), [], 0.0, 10.0) if traced else None
    return types.SimpleNamespace(tr=tr, records={"steps": list(steps)})


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.mark.parametrize("cell", ["chat", "batch"])
def test_decode_idle_hand_worked(cell, monkeypatch):
    # tick 1 [0.5, 2.5]: busy [1.0, 2.0], idle 1.0; tick 2 [2.8, 3.6]:
    # busy [3.0, 3.4], idle 0.4; the mean 0.7 s
    run = _run(SERVE, monkeypatch)
    assert _read(f"decode_idle_ms.{cell}", run) == pytest.approx(700.0)


def test_idle_split_by_innermost_span(monkeypatch):
    # [0.5, 1.0] inside decode.model; [2.0, 2.5] after it closed, and
    # [2.8, 3.0], [3.4, 3.6] in the second tick: the decode span itself
    run = _run(SERVE, monkeypatch)
    split = program_spans.idle_by_innermost(run, "serve.decode")
    assert split == pytest.approx({"serve.decode": 0.9, "decode.model": 0.5})
    # over the whole stretch [0, 10], by each gap's midpoint: [0, 1] and
    # [2, 3] in a decode span, [3.4, 5] and [5.5, 10] in none
    whole = program_spans.idle_by_innermost(run)
    assert whole == pytest.approx({"-": 1.6 + 4.5, "serve.decode": 2.0})


def test_admit_wait_hand_worked(monkeypatch):
    # 7: 0.15 - 0.1; 8: 0.25 - 0.1; 9: 4.3 - 4.05 (its latest selection);
    # the 90th percentile of three: 0.15 + 0.8 * (0.25 - 0.15)
    run = _run(SERVE, monkeypatch)
    assert _read("admit_wait_p90_ms.chat", run) == pytest.approx(230.0)


def test_rma_host_hand_worked(monkeypatch):
    # step 1: 0.1 + 0.05 + 0.3 (the flush inside the replay counted once);
    # step 2: 0.1; the mean 0.275 s
    run = _run(TRAIN, monkeypatch, STEPS)
    assert _read("rma_host_ms.train", run) == pytest.approx(275.0)


@pytest.mark.parametrize("name,want", [("fwd_ms.train", (22 + 24) / 2),
                                       ("bwd_ms.train", (61 + 62) / 2)])
def test_forward_and_backward_parts_hand_worked(name, want, monkeypatch):
    run = _run([], monkeypatch, STEPS)
    assert _read(name, run) == pytest.approx(want)


NAMES = ["fwd_ms.train", "bwd_ms.train", "rma_host_ms.train",
         "admit_wait_p90_ms.chat", "decode_idle_ms.chat",
         "decode_idle_ms.batch"]


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    # the step records of a program without the forward/backward events
    old = [{k: v for k, v in s.items() if k[:4] not in ("fwd.", "bwd.")}
           for s in STEPS]
    assert _read(name, _run([], monkeypatch, old)) is None
    assert _read(name, _run(SERVE + TRAIN, monkeypatch, old,
                            traced=False)) is None


def test_no_recorder_means_no_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    if "repro_torch" in sys.modules:
        monkeypatch.delattr(sys.modules["repro_torch"], "obs", raising=False)
    assert program_spans._recorded() == []


@pytest.mark.parametrize("name", NAMES)
def test_each_metric_names_the_one_cell_it_reads(name):
    (m,) = [m for m in harness.benchmark()["per_layer"] if m["name"] == name]
    cell = {"train": "sc2-train-dp4", "chat": "jamba-chat",
            "batch": "jamba-batch"}[name.rsplit(".", 1)[1]]
    assert m["workloads"] == [cell]
