"""The metric arithmetic: tails over every sample, rates over the whole
window, idle as a union of intervals, and the FLOP and byte counts held to
hand-worked numbers."""
import collections
import math
import types

import numpy as np
import pytest

from rmabench import flops, harness, peaks, stats
from rmabench.trace import Trace, _innermost


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys(q):
    xs = np.random.default_rng(q).exponential(size=137)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_counts_failures_as_infinite():
    xs = [1.0] * 8 + [math.inf] * 2
    assert stats.percentile(xs, 50) == 1.0
    assert stats.percentile(xs, 90) == math.inf


def test_union_and_gaps():
    iv = [(3.0, 4.0), (0.0, 1.0), (0.5, 2.0), (1.5, 1.8)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.rate(300, 1.5) == 200


def test_trace_busy_idle_and_labels():
    dev = [(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 4.0, "k1")]
    host = [(1.9, 3.2, "bench:decode", True), (2.1, 2.9, "aten::copy_", False)]
    tr = Trace(dev, host, 0.0, 5.0)
    assert tr.busy_s() == pytest.approx(3.0)
    assert tr.kernel_seconds(["k1"]) == pytest.approx(2.0)
    assert tr.kernel_count(["k1"]) == 2
    assert tr.top_ops()[0] == ["k1", 2.0]
    idle = dict(map(tuple, tr.idle_by_host()))
    assert idle["bench:decode/aten::copy_"] == pytest.approx(1.0)
    assert idle["-/-"] == pytest.approx(1.0)
    run = types.SimpleNamespace(tr=tr)
    mod = harness.load_module("metrics", "device_idle.chat")
    assert mod.read(run) == pytest.approx(40.0)


def test_innermost_nested():
    ranges = [(0.0, 10.0, "outer"), (2.0, 3.0, "inner"), (5.0, 6.0, "b")]
    assert _innermost(ranges, [1.0, 2.5, 4.0, 5.5, 11.0]) == \
        ["outer", "inner", "outer", "b", "-"]


def _serve_run(trace=None):
    tt = collections.defaultdict(list)
    tt.update({0: [1.2, 1.3, 1.5], 1: [2.0, 2.1], 2: []})
    rec = {"due": {0: 1.0, 1: 1.9, 2: 2.5}, "tok_times": tt, "t_end": 9.5,
           "prefills": [(0, 1.05, 1.2, 100), (1, 1.95, 2.0, 50)],
           "decodes": [(1.25, 1.3, 1), (1.4, 1.5, 2)],
           "prompts": {0: np.zeros(100), 1: np.zeros(50)}}
    return types.SimpleNamespace(records=rec, tr=trace,
                                 model=None, workload={})


def test_tails_over_every_request():
    run = _serve_run()
    ttft = harness.load_module("metrics", "ttft_p90_ms").read(run)
    # request 2 was never served: late by at least the run's end - its due
    assert ttft == pytest.approx(1e3 * np.percentile([0.2, 0.1, 7.0], 90))
    run.records["tok_times"][2] = [3.0]
    assert harness.load_module("metrics", "ttft_p90_ms").read(run) == \
        pytest.approx(1e3 * np.percentile([0.2, 0.1, 0.5], 90))
    tpot = harness.load_module("metrics", "tpot_p95_ms").read(run)
    assert tpot == pytest.approx(1e3 * np.percentile([0.1, 0.2, 0.1], 95))
    wait = harness.load_module("metrics", "queue_wait_p90_ms.chat").read(run)
    assert wait == pytest.approx(1e3 * np.percentile([0.05, 0.05], 90))
    assert harness.load_module("metrics", "prefill_ms.chat").read(run) == \
        pytest.approx(100.0)
    assert harness.load_module("metrics", "decode_tick_ms.chat").read(run) \
        == pytest.approx(75.0)


def test_rates_are_work_over_the_window():
    steps = [{"t0": 10.0, "t1": 11.0, "tokens": 1000},
             {"t0": 11.0, "t1": 12.5, "tokens": 1000}]
    run = types.SimpleNamespace(records={"steps": steps})
    mod = harness.load_module("metrics", "train_tokens_per_s")
    assert mod.read(run) == pytest.approx(2000 / 2.5)
    tt = {0: [0.5, 1.5, 2.5], 1: [3.5, 4.5]}
    run = types.SimpleNamespace(records={"t_open": 1.0, "t_close": 4.0,
                                         "tok_times": tt})
    mod = harness.load_module("metrics", "serve_tokens_per_s")
    assert mod.read(run) == pytest.approx(3 / 3.0)


SC2 = harness.load_json("configs", "starcoder2-3b-x15-dp4.json")["model"]
JAMBA = harness.load_json("configs", "jamba-v0.1-52b-x8.json")["model"]


def test_train_step_flops_hand_worked():
    # per token a layer: q,k,v,o 3072*128*(2*24 + 2*2) + GELU MLP
    # 2*3072*12288 = 95,944,704 multiply-adds; 15 layers and the head
    # 3072*49152; causal attention 2*24*128 * 2048*2049/2 keys a layer
    per_seq = 2 * (2048 * (15 * 95_944_704 + 3072 * 49152)
                   + 15 * 2 * 24 * 128 * (2048 * 2049 // 2))
    assert per_seq == 6_900_053_704_704
    assert flops.train_step_flops(SC2, 8, 2048) == 3 * 8 * per_seq
    assert 3 * 8 * per_seq == 165_601_288_912_896


def test_param_count_and_ring_bytes_hand_worked():
    # a layer: 2 LayerNorms 2*2*3072, attention 20,447,232 + biases
    # 128*(24+4) + 3072, MLP 75,497,472 + biases 12288 + 3072
    layer = 12_288 + 20_447_232 + 6_656 + 75_497_472 + 15_360
    total = 15 * layer + 2 * 49152 * 3072 + 2 * 3072
    assert flops.dense_param_count(SC2) == total == 1_741_681_152
    assert flops.ring_width(total, 4) == total      # divides by 16
    assert flops.ring_bytes(total, 4) == 32 * total
    assert peaks.bound_s(flops.ring_bytes(total, 4)) == pytest.approx(
        0.016637, rel=1e-4)


def test_param_count_matches_the_program_layout():
    pytest.importorskip("repro_torch")
    from rmabench import weights
    from repro_torch.models import build_model

    layout = build_model(harness.model_config(SC2)).init(0, device="meta")
    assert weights.count(layout) == flops.dense_param_count(SC2)


def test_ssd_scan_work_hand_worked():
    # x.dt and y bf16 (1024 x 8192 each), decays float32 (1024 x 128),
    # B and C bf16 (1024 x 16 each), final state bf16 (8192 x 16)
    want = 2 * 1024 * 8192 * 2 + 4 * 1024 * 128 + 2 * 2 * 1024 * 16 \
        + 2 * 8192 * 16
    assert flops.ssd_scan_bytes(JAMBA, 1024) == want == 34_406_400
    assert flops.ssd_scan_flops(JAMBA, 1024) == 4 * 1024 * 8192 * 16


def test_jamba_layer_kinds_and_decode_flops():
    kinds = flops.layer_kinds(JAMBA)
    assert [m for m, _ in kinds].count("mamba") == 7
    assert kinds[4][0] == "gqa"
    assert [f for _, f in kinds] == ["dense", "moe"] * 4
    # one decoded token at position 99: every layer's projections once, the
    # attention layer over 100 keys, the head once
    one = flops.forward_flops(JAMBA, 100, start=99)
    whole = flops.forward_flops(JAMBA, 100, logits_rows=1)
    per_tok_proj = (whole - 2 * JAMBA["d_model"] * JAMBA["vocab"]
                    - 2 * 2 * 32 * 128 * (100 * 101 // 2)) / 100
    assert one == pytest.approx(per_tok_proj + 2 * 2 * 32 * 128 * 100
                                + 2 * 4096 * 65536)
