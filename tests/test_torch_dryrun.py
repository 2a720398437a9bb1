"""Parity of the port's dry-run with the JAX package's
(``repro.launch.{dryrun,hlo_analysis}``): the HLO text analysis and the
roofline, the meta-device routing of the kernel wrappers, and
``run_cell`` on tiny configs on
``meta`` — every record ``ok``, its dot FLOPs against the reference's
``hlo_analysis.analyze`` of the same step compiled on one CPU device."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.tiny import tiny_config as j_tiny_config
from repro.launch import hlo_analysis as JH
from repro.launch.mesh import rules_for as j_rules_for
from repro.launch.specs import build_cell as j_build_cell
from repro.sharding import ShardingRules as JRules

from repro_torch.configs import ShapeConfig, tiny_config
from repro_torch.kernels import common, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import dryrun, hlo_analysis as TH
from repro_torch.launch.mesh import make_host_mesh

# ---------------------------------------------------------------------------
# the HLO text analysis, on the same text
# ---------------------------------------------------------------------------

#: a hand-written module: a 6-trip while whose body holds a dot and an
#: all-reduce, a top-level collective-permute and a fused dot
HLO_WHILE = """HloModule m, entry_computation_layout={(f32[8,16]{1,0})->f32[8,16]{1,0}}

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

%body (p: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {
  %p = (s32[], f32[8,16]{1,0}) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[8,16]{1,0}) %p), index=0
  %x = f32[8,16]{1,0} get-tuple-element((s32[], f32[8,16]{1,0}) %p), index=1
  %w = f32[16,16]{1,0} constant({...})
  %d = f32[8,16]{1,0} dot(f32[8,16]{1,0} %x, f32[16,16]{1,0} %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %r = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %d), replica_groups={{0,1,2,3}}, to_apply=%add
  %one = s32[] constant(1)
  %n = s32[] add(s32[] %i, s32[] %one)
  ROOT %t = (s32[], f32[8,16]{1,0}) tuple(s32[] %n, f32[8,16]{1,0} %r)
}

%cond (q: (s32[], f32[8,16])) -> pred[] {
  %q = (s32[], f32[8,16]{1,0}) parameter(0)
  %j = s32[] get-tuple-element((s32[], f32[8,16]{1,0}) %q), index=0
  %six = s32[] constant(6)
  ROOT %lt = pred[] compare(s32[] %j, s32[] %six), direction=LT
}

%fused (f0: f32[8,16], f1: f32[16,16]) -> f32[8,16] {
  %f0 = f32[8,16]{1,0} parameter(0)
  %f1 = f32[16,16]{1,0} parameter(1)
  ROOT %fd = f32[8,16]{1,0} dot(f32[8,16]{1,0} %f0, f32[16,16]{1,0} %f1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main (x0: f32[8,16]) -> f32[8,16] {
  %x0 = f32[8,16]{1,0} parameter(0)
  %zero = s32[] constant(0)
  %init = (s32[], f32[8,16]{1,0}) tuple(s32[] %zero, f32[8,16]{1,0} %x0)
  %loop = (s32[], f32[8,16]{1,0}) while((s32[], f32[8,16]{1,0}) %init), condition=%cond, body=%body
  %y = f32[8,16]{1,0} get-tuple-element((s32[], f32[8,16]{1,0}) %loop), index=1
  %cp = f32[8,16]{1,0} collective-permute(f32[8,16]{1,0} %y), source_target_pairs={{0,1},{1,0},{2,3},{3,2}}
  %w2 = f32[16,16]{1,0} constant({...})
  ROOT %out = f32[8,16]{1,0} fusion(f32[8,16]{1,0} %cp, f32[16,16]{1,0} %w2), kind=kOutput, calls=%fused
}
"""


def _jax_hlo() -> str:
    """A module compiled by JAX on one CPU device: a 10-trip scan of dots."""
    def g(a, b):
        def body(c, _):
            return jnp.tanh(c @ b), None
        out, _ = jax.lax.scan(body, a, None, length=10)
        return out
    a = jnp.zeros((64, 64))
    return jax.jit(g).lower(a, a).compile().as_text()


def _stats_dict(st):
    return {"flops": st.flops, "hbm_bytes": st.hbm_bytes,
            "coll_bytes": dict(st.coll_bytes),
            "coll_count": dict(st.coll_count), "dots": st.dots,
            "convs": st.convs, "whiles": list(st.whiles)}


@pytest.mark.parametrize("source", ["jax", "hand"])
def test_hlo_analysis_equals_reference(source):
    text = _jax_hlo() if source == "jax" else HLO_WHILE
    assert _stats_dict(TH.analyze(text)) == _stats_dict(JH.analyze(text))
    tc, jc = TH.collective_bytes(text), JH.collective_bytes(text)
    assert (tc.bytes_by_kind, tc.count_by_kind, tc.total_bytes) == \
        (jc.bytes_by_kind, jc.count_by_kind, jc.total_bytes)
    assert TH.parse_module(text).keys() == JH.parse_module(text).keys()
    for t in ("(f32[2,3], bf16[4])", "pred[7]", "f32[]", "s8[3,5]"):
        assert TH._shape_bytes(t) == JH._shape_bytes(t)


def test_hand_module_trip_counts_and_collectives():
    st = TH.analyze(HLO_WHILE)
    assert st.whiles == [("body", 6)]
    assert st.flops == 6 * 2 * 8 * 16 * 16 + 2 * 8 * 16 * 16
    assert st.coll_count["all-reduce"] == 6
    assert st.coll_bytes["all-reduce"] == 6 * 8 * 16 * 4
    assert st.coll_bytes["collective-permute"] == 8 * 16 * 4
    assert TH.COLLECTIVE_KINDS == JH.COLLECTIVE_KINDS


def test_roofline_on_the_cards_constants():
    assert (TH.PEAK_FLOPS, TH.HBM_BW, TH.NVLINK_BW) == (989e12, 3.35e12,
                                                         450e9)
    assert not hasattr(TH, "ICI_BW")
    r = TH.Roofline(flops=989e12, hbm_bytes=3.35e12 * 2, coll_bytes=450e9 / 2,
                    chips=256)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.dominant == "memory" and r.bound_s == pytest.approx(2.0)
    assert r.compute_fraction == pytest.approx(0.5)
    # no partitioner: the collective term is unknown and never dominates
    r = TH.Roofline(flops=989e12 * 3, hbm_bytes=3.35e12, coll_bytes=None,
                    chips=1)
    d = r.as_dict()
    assert d["collective_s"] is None and d["dominant"] == "compute"
    assert d["compute_fraction"] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# meta tensors in the kernel wrappers
# ---------------------------------------------------------------------------

def test_on_device_routes_meta_to_the_plain_version():
    meta = torch.empty(2, 3, device="meta")
    assert common.on_device(meta) is False
    assert common.on_device(torch.zeros(2)) is False
    with pytest.raises(ValueError, match="mixed devices"):
        common.on_device(meta, torch.zeros(2))
    counters = [sys.modules[f"repro_torch.kernels.{m}"].COUNTER
                for m in ("flash_attention", "ssd_scan", "ssd_pass")]
    for c in counters:
        c.reset()
    q = torch.empty(1, 4, 256, 64, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, 2, 256, 64, device="meta", dtype=torch.bfloat16)
    out = flash_attention(q, kv, kv, block_q=256, block_kv=256)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    y, final = ops.ssd_scan(
        torch.empty(1, 100, 2, 8, device="meta"),
        torch.empty(1, 100, 2, device="meta"),
        torch.empty(1, 100, 4, device="meta"),
        torch.empty(1, 100, 4, device="meta"), chunk=16, nheads=2,
        headdim=8)
    assert y.shape == (1, 100, 2, 8) and final.shape == (1, 2, 8, 4)
    assert [c.count for c in counters] == [0, 0, 0]


def test_traffic_mode_counts_a_kernel_as_the_card_runs_it():
    q = torch.empty(2, 4, 512, 64, device="meta", dtype=torch.bfloat16)
    with dryrun.TrafficMode() as tm:
        flash_attention(q, q, q, block_q=512, block_kv=512)
    # q, k, v read once and the output written once; the plain version's
    # (B, H, S, S) scores are none of it
    assert tm.kernels == 1 and tm.ops == 0
    assert tm.traffic == 4 * q.numel() * 2
    assert tm.high == q.numel() * 2
    with dryrun.TrafficMode() as tm:
        a = torch.empty(64, 32, device="meta")
        b = a.t()                                  # a view: nothing moves
        c = a * 2.0
    assert tm.traffic == 2 * a.numel() * 4 and tm.ops == 3
    del b, c


# ---------------------------------------------------------------------------
# run_cell on tiny configs against the reference's compiled HLO
# ---------------------------------------------------------------------------

#: one stack of each family kind: dense, MoE, Mamba2, enc-dec
CELL_ARCHS = ["qwen3-4b", "deepseek-v2-236b", "mamba2-370m", "whisper-base"]
CELL_SHAPES = {"train": ShapeConfig("t_train", 32, 4, "train"),
               "prefill": ShapeConfig("t_prefill", 32, 2, "prefill"),
               "decode": ShapeConfig("t_decode", 64, 2, "decode")}
#: dot FLOPs of the port's meta step against the reference's compiled HLO
#: are equal but for two Mamba2 ops (PERF.md names them).  Training: XLA
#: transposes ``ssd_chunked``'s einsums (the chunk scan's three-operand
#: y_inter and state updates among them) into other dots than autograd's
#: backward of torch's pairwise contractions — 3 dots of 131,072 and 8 of
#: 8,192 FLOPs more a layer in XLA's, 1.5 % of the tiny step: a relative
#: tolerance of 2 %
FLOP_RTOL = {("mamba2-370m", "train"): 2e-2}


def _flop_extra(cfg, shape, kind):
    """Dots the reference has where the port multiplies: decoding, its
    one-token conv is an einsum (``causal_conv1d_step``, 2·B·K·C a layer),
    the port's a multiply and a sum — added exactly."""
    if kind != "decode" or cfg.ssm is None:
        return 0
    conv_dim = cfg.ssm.expand * cfg.d_model + 2 * cfg.ssm.d_state
    return cfg.n_layers * 2 * shape.global_batch * cfg.ssm.d_conv * conv_dim


def _jax_flops(arch, shape):
    """The reference's step on one CPU device: its stand-ins without their
    shardings (on one device they change no dot)."""
    cfg = j_tiny_config(arch).replace(remat="none")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step, args, _ = j_build_cell(cfg, shape, JRules(mesh, j_rules_for(cfg,
                                                                      shape)))
    args = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype), args)
    text = jax.jit(step).lower(*args).compile().as_text()
    return JH.analyze(text).flops


@pytest.mark.parametrize("kind", sorted(CELL_SHAPES))
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_run_cell_tiny_flops_equal_reference(arch, kind):
    shape = CELL_SHAPES[kind]
    tiny = tiny_config(arch).replace(remat="none")
    over = {f.name: getattr(tiny, f.name) for f in dataclasses.fields(tiny)}
    rec = dryrun.run_cell(arch, shape, cfg_overrides=over,
                          mesh=make_host_mesh())
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 1 and rec["mesh"] == "1x1"
    assert rec["collectives"] is None and rec["collectives_why"]
    assert rec["xla_cost_flops_per_dev"] is None
    assert rec["bytes_per_device"]["arguments"] > 0
    want = _jax_flops(arch, _j_shape(shape))
    got = rec["hlo_flops"] + _flop_extra(tiny, shape, kind)
    rtol = FLOP_RTOL.get((arch, kind), 0.0)
    assert got == pytest.approx(want, rel=rtol, abs=0), (got, want)


def _j_shape(shape):
    from repro.configs.base import ShapeConfig as JShape
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


def test_run_cell_ties_to_a_real_step_on_the_cpu():
    """What ``chip_smoke.py`` ``[dryrun-card]`` holds on the card, at a tiny
    size on the CPU: the dry-run's argument bytes are the bytes of the same
    parameters, AdamW state and batch made for real; its meta FLOPs the
    counter's of a real step; its ring's predicted phases each ring step's
    ledger."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step
    from repro_torch.tree import leaves

    tiny = tiny_config("qwen3-4b")
    over = {f.name: getattr(tiny, f.name) for f in dataclasses.fields(tiny)}
    shape = ShapeConfig("t", 64, 8, "train")
    rec1 = dryrun.run_cell("qwen3-4b", shape, cfg_overrides=over,
                           mesh=make_host_mesh())
    rec4 = dryrun.run_cell("qwen3-4b", shape, cfg_overrides=over,
                           grad_sync="rma_ring", mesh=make_host_mesh(data=4))
    model = build_model(tiny.replace(dtype="bfloat16", param_dtype="bfloat16"))
    params = model.init(0, device="cpu")
    opt_state = init_opt_state(params)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, tiny.vocab, (8, 64), generator=gen)
             .to(torch.int32) for k in ("tokens", "labels")}
    made = leaves(params) + leaves(opt_state) + list(batch.values())
    assert rec1["bytes_per_device"]["arguments"] == sum(
        t.numel() * t.element_size() for t in made)
    with FlopCounterMode(display=False) as fc:
        make_train_step(model, OptimizerConfig())(params, opt_state, batch)
    assert fc.get_total_flops() == rec1["hlo_flops"] * rec1["chips"]
    assert rec4["chips"] == 4 and rec4["hlo_flops"] == rec1["hlo_flops"] / 4
    coll = rec4["collectives"]
    assert coll["ranks"] == 4 and coll["phases"] == 2 * 4
    ring = make_train_step(model, OptimizerConfig(), grad_sync="rma_ring",
                           data_axis="data", data_axis_size=4)
    for _ in range(2):
        _, _, metrics = ring(params, opt_state, batch)
        assert metrics["phases"] == coll["phases"]
    assert rec4["roofline"]["collective_s"] == pytest.approx(
        coll["total_bytes"] / TH.NVLINK_BW)


def test_cli_skips_refuses_and_counts_failures(capsys):
    assert dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                        "--both-meshes"]) == 0
    out = capsys.readouterr().out
    assert out.count("SKIP (pure full-attention architecture") == 2
    assert "2 cells, 0 failures" in out
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen3-4b", "--save-hlo", "x.hlo"])
    assert exc.value.code == 2
    assert "compiles no HLO" in capsys.readouterr().err
    # a cell the port cannot build is a FAILED record and a non-zero exit
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--set", "n_layers=2", "--set",
                        "n_kv_heads=3"]) == 1
    assert "FAILED" in capsys.readouterr().out
