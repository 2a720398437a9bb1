"""Parity of the port's kernels (their plain PyTorch versions, which CPU
tensors take) with the JAX package: the Pallas kernels run in interpret mode
as tests/test_kernels.py runs them, or the ``kernels/ref.py`` oracles where
a kernel needs a device mesh.  Plus the port's invariants: no JAX or
reference imports, entry points and wrappers that raise instead of falling
back to the CPU.  Inputs are numpy arrays from a seed, handed to both."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rma import WindowConfig as JWindowConfig
from repro.core.rma.collectives import plan_all_reduce as j_plan_all_reduce
from repro.kernels import accumulate as j_accumulate
from repro.kernels import op_identity as j_op_identity
from repro.core.rma.accumulate import default_flag_value as j_flag_value
from repro.kernels import ref as JR
from repro.kernels.ordered_put_signal import \
    accumulate_signal as j_accumulate_signal

from repro_torch.core.rma import WindowConfig
from repro_torch.kernels import common, ref as TR
from repro_torch.kernels.accumulate import (accumulate, accumulate_rows,
                                            op_identity)
from repro_torch.kernels.intrinsic import (accumulate_rows_atomic,
                                           ring_accumulate)
from repro_torch.kernels.ordered_put_signal import (_scratch,
                                                    accumulate_signal,
                                                    accumulate_signal_rows,
                                                    copy_unit, put_signal,
                                                    put_signal_rows)
from repro_torch.kernels.rma_put import (WAIT_COUNTER, put_rows, ring_put,
                                         wait_counters)
from repro_torch.kernels.ring_allreduce import (ring_all_reduce,
                                                ring_all_reduce_plain)

SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")


@pytest.fixture(autouse=True)
def _hermetic_crossover(monkeypatch):
    monkeypatch.setenv("RMA_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.setenv("RMA_TORCH_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.delenv("RMA_ACC_CROSSOVER", raising=False)


def _pair(rng, shape, dtype):
    if np.dtype(dtype).kind == "i":
        return (rng.integers(-(2**20), 2**20, shape).astype(dtype),
                rng.integers(-(2**20), 2**20, shape).astype(dtype))
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


# ---------------------------------------------------------------------------
# K1 — tiled accumulate
# ---------------------------------------------------------------------------

K1_CASES = [(op, dt) for dt in ("float32", "int32")
            for op in common.ACC_OPS
            if not (op in common.BITWISE_OPS and dt == "float32")]


@pytest.mark.parametrize("n", [7, 1500])
@pytest.mark.parametrize("op,dtype", K1_CASES)
def test_k1_matches_pallas_interpret(op, dtype, n):
    """Exact equality with the Pallas kernel (interpret mode, ragged tail
    padded with the op's identity there, masked here): one partial block,
    and three blocks of which the last is partial."""
    buf, upd = _pair(np.random.default_rng(n), (n,), dtype)
    want = np.asarray(j_accumulate(jnp.asarray(buf), jnp.asarray(upd), op=op,
                                   block=64 if n < 64 else 512))
    tb = torch.from_numpy(buf.copy())
    out = accumulate(tb, torch.from_numpy(upd), op=op)
    assert out is tb                                  # in place
    np.testing.assert_array_equal(out.numpy(), want)


def test_k1_rows_and_cast():
    """The row form folds a column slice of a wider window, and the update
    is cast to the buffer dtype, as the oracle does."""
    rng = np.random.default_rng(1)
    win = rng.standard_normal((4, 10)).astype(np.float32)
    upd = rng.integers(-5, 5, (4, 6)).astype(np.int32)
    tw = torch.from_numpy(win.copy())
    accumulate_rows(tw[:, 2:8], torch.from_numpy(upd), op="max")
    want = win.copy()
    want[:, 2:8] = np.asarray(JR.accumulate_ref(jnp.asarray(win[:, 2:8]),
                                                jnp.asarray(upd), op="max"))
    np.testing.assert_array_equal(tw.numpy(), want)


def test_k1_rejects_bitwise_float_and_shape():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="integer"):
        accumulate(x, x.clone(), op="bxor")
    with pytest.raises(ValueError, match="shape mismatch"):
        accumulate(x, torch.zeros(5))


def test_op_identity_table():
    assert op_identity("sum", torch.float32) == 0.0
    assert op_identity("prod", torch.int32) == 1
    assert op_identity("min", torch.int32) == np.iinfo(np.int32).max
    assert op_identity("max", torch.float32) == np.finfo(np.float32).min
    assert op_identity("band", "uint32") == 0xFFFFFFFF
    assert op_identity("replace", torch.float32) is None
    for op in ("sum", "min", "max", "prod", "band", "bor", "bxor", "replace"):
        for dt in ("float32", "int32"):
            if op in common.BITWISE_OPS and dt == "float32":
                continue
            want = j_op_identity(op, jnp.dtype(dt))
            got = op_identity(op, dt)
            assert (got is None) == (want is None)
            if want is not None:
                assert got == want, (op, dt)


# ---------------------------------------------------------------------------
# K2 — atomic ring accumulate
# ---------------------------------------------------------------------------

K2_CASES = [(op, dt) for dt in ("float32", "int32")
            for op in common.ATOMIC_KERNEL_OPS
            if not (op in common.BITWISE_OPS and dt == "float32")]


@pytest.mark.parametrize("op,dtype", K2_CASES)
def test_k2_matches_oracle(op, dtype):
    n = 8
    rng = np.random.default_rng(2)
    buf, _ = _pair(rng, (n, 16), dtype)
    upd, _ = _pair(rng, (n, 4), dtype)
    want = np.asarray(JR.ring_accumulate_ref(jnp.asarray(buf), jnp.asarray(upd),
                                             axis_size=n, op=op, offset=2))
    tb = torch.from_numpy(buf.copy())
    out = ring_accumulate(torch.from_numpy(upd), tb, axis_size=n, op=op,
                          offset=2)
    assert out is tb
    np.testing.assert_array_equal(out.numpy(), want)
    # and the port's own oracle says the same
    np.testing.assert_array_equal(
        TR.ring_accumulate_ref(torch.from_numpy(buf), torch.from_numpy(upd),
                               axis_size=n, op=op, offset=2).numpy(), want)


def test_k2_checks():
    n = 4
    buf, upd = torch.zeros(n, 16), torch.ones(n, 4)
    with pytest.raises(ValueError, match="NIC"):
        ring_accumulate(upd, buf, axis_size=n, op="prod")
    with pytest.raises(ValueError, match="integer"):
        ring_accumulate(upd, buf, axis_size=n, op="band")
    with pytest.raises(ValueError, match="overruns"):
        ring_accumulate(upd, buf, axis_size=n, offset=13)
    # one declaration drives both layers: a config that routes tiled is
    # refused, one that routes intrinsic lowers (mdev/kernels_mdev.py)
    ring_accumulate(upd, buf, axis_size=n,
                    config=WindowConfig(same_op="sum", max_atomic_elems=8))
    with pytest.raises(ValueError, match="tiled"):
        ring_accumulate(upd, buf, axis_size=n,
                        config=WindowConfig(same_op="sum", max_atomic_elems=1))


def test_k2_partial_perm_leaves_other_rows():
    buf = torch.arange(12.0).view(3, 4)
    upd = torch.full((3, 2), 10.0)
    accumulate_rows_atomic(upd, buf, [2, -1, -1], op="sum", offset=1)
    want = torch.arange(12.0).view(3, 4)
    want[2, 1:3] += 10.0
    assert torch.equal(buf, want)


# ---------------------------------------------------------------------------
# K3 — put with thread-scope completion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((8, 32), "float32"),
                                         ((4, 5, 3), "int32")])
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_k3_matches_oracle(shape, dtype, shift):
    x, _ = _pair(np.random.default_rng(3), shape, dtype)
    want = np.asarray(JR.ring_put_ref(jnp.asarray(x), axis_size=shape[0],
                                      shift=shift))
    got = ring_put(torch.from_numpy(x), axis_size=shape[0], shift=shift)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k3_counters_are_per_rank_and_stream():
    src = torch.arange(8.0).view(4, 2)
    dst = torch.zeros(4, 5)
    cnt = torch.zeros((4, 2), dtype=torch.int32)
    ticks = put_rows(src, dst, [1, -1, 3, 0], offset=3, counters=cnt,
                     stream=1)
    assert ticks == 1
    assert cnt[:, 0].tolist() == [0, 0, 0, 0]
    assert cnt[:, 1].tolist() == [1, 0, 1, 1]      # senders only
    assert dst[1, 3:].tolist() == [0.0, 1.0]
    assert dst[3, 3:].tolist() == [4.0, 5.0]
    assert dst[0, 3:].tolist() == [6.0, 7.0]
    assert dst[2].abs().sum() == 0
    with pytest.raises(ValueError, match="overruns"):
        put_rows(src, dst, [1, -1, 3, 0], offset=4)


@pytest.mark.parametrize("owed,short", [
    ([1, 0, 1, 1], 0),            # what the puts above owe: met
    ([1, 1, 1, 1], 1),            # rank 1 sent nothing: one rank short
    ([2, 0, 2, 2], 3),
    ([2**32 + 1, 0, 1, 1], 0),    # compared modulo 2^32, as on the card
])
def test_k3_wait_counts_the_ranks_short(owed, short):
    """The flush half of K3 reads one stream's column of counters and
    reports (never hides) a rank whose puts have not all completed."""
    cnt = torch.zeros((4, 2), dtype=torch.int32)
    put_rows(torch.ones(4, 2), torch.zeros(4, 2), [1, -1, 3, 0],
             counters=cnt, stream=1)
    stalls = torch.zeros(1, dtype=torch.int32)
    before = WAIT_COUNTER.count
    wait_counters(cnt, owed, stream=1, stalls=stalls)
    assert int(stalls) == short
    wait_counters(cnt, [0, 0, 0, 0], stream=0, stalls=stalls)
    assert int(stalls) == short                     # stream 0 owes nothing
    assert WAIT_COUNTER.count == before             # CPU: no launch counted
    with pytest.raises(ValueError, match="outside"):
        wait_counters(cnt, owed, stream=2, stalls=stalls)
    with pytest.raises(ValueError, match="one owed count per rank"):
        wait_counters(cnt, owed[:3], stream=1, stalls=stalls)


# ---------------------------------------------------------------------------
# K5 — ring all-reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,length", [(2, 6), (4, 52), (8, 104), (4, 13)])
def test_k5_bit_identical_to_planned_ring(n, length):
    """Same sum order as the JAX plan's flat ring (interpret backend): at
    hop k rank r adds the incoming partial of chunk (r-k-1) to its own."""
    x = np.random.default_rng(n * 1000 + length).standard_normal(
        (n, length)).astype(np.float32)
    want = np.asarray(j_plan_all_reduce(jnp.asarray(x), "x", n,
                                        backend="interpret"))
    got = ring_all_reduce(torch.from_numpy(x), axis_size=n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JR.ring_all_reduce_ref(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_k5_inplace_and_order_rejection():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 8)).astype(np.float32))
    want = ring_all_reduce_plain(x.clone())
    y = x.clone()
    assert ring_all_reduce(y, axis_size=4, inplace=True) is y
    assert torch.equal(y, want)
    z = x.clone()
    ring_all_reduce(z, axis_size=4)
    assert torch.equal(z, x)                         # not in place by default
    with pytest.raises(ValueError, match="order=False"):
        ring_all_reduce(x, axis_size=4, config=WindowConfig(order=False))
    ring_all_reduce(x, axis_size=4, config=WindowConfig(order=True))
    with pytest.raises(ValueError, match="order=False"):
        # the reference kernel refuses the same declaration
        from repro.kernels.ring_allreduce import ring_all_reduce as j_k5
        j_k5(jnp.zeros((8,)), axis="x", axis_size=4,
             config=JWindowConfig(order=False))


# ---------------------------------------------------------------------------
# K4 put+signal and K6 accumulate+signal
# ---------------------------------------------------------------------------

K46_CASES = [(op, dt) for dt in ("float32", "int32", "bfloat16")
             for op in common.ATOMIC_KERNEL_OPS
             if not (op in common.BITWISE_OPS and dt != "int32")]


def _stacked(rng, shape, dtype):
    """The same values for both packages (bfloat16 rounded once, from
    float32, by each)."""
    if dtype == "int32":
        a = rng.integers(-(2**20), 2**20, shape).astype(np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a).astype(jnp.bfloat16), \
            torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _same(t, j):
    np.testing.assert_array_equal(t.float().numpy() if t.is_floating_point()
                                  else t.numpy(), np.asarray(j, np.float32)
                                  if t.is_floating_point() else np.asarray(j))


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("op,dtype", K46_CASES)
def test_put_and_accumulate_signal_match_reference(op, dtype, ordered):
    """K4: the ring put plus the flag word (the reference's
    ``default_flag_value`` for ``op``); K6: the ring accumulate at an offset
    plus the flag — exact, ordered and in the Listing-1 shape."""
    n = 4
    rng = np.random.default_rng(K46_CASES.index((op, dtype)))
    jx, tx = _stacked(rng, (n, 13), dtype)
    jb, tb = _stacked(rng, (n, 21), dtype)
    jflag = jnp.broadcast_to(j_flag_value(op, jx.dtype), (n, 1))
    tflag = torch.from_numpy(np.array(jflag, np.float32)).to(tx.dtype)
    got, gflag = put_signal(tx, tflag, axis_size=n, ordered=ordered)
    _same(got, JR.ring_put_ref(jx, axis_size=n))
    _same(gflag, JR.ring_put_ref(jflag, axis_size=n))
    got, gflag = accumulate_signal(tx, tb, tflag, axis_size=n, op=op,
                                   offset=5, ordered=ordered)
    _same(got, JR.ring_accumulate_ref(jb, jx, axis_size=n, op=op, offset=5))
    _same(gflag, JR.ring_put_ref(jflag, axis_size=n))


def test_signal_kernels_refuse_what_the_reference_refuses():
    buf, upd, flag = torch.zeros(4, 8), torch.ones(4, 2), torch.ones(4, 1)
    for op in ("prod", "bor"):
        with pytest.raises(ValueError):
            accumulate_signal(upd, buf, flag, axis_size=4, op=op)
        with pytest.raises(ValueError):     # the reference kernel refuses too
            j_accumulate_signal(jnp.ones((2,)), jnp.zeros((8,)),
                                jnp.ones((1,)), axis="x", axis_size=4, op=op)


def test_signal_kernels_raise_on_overrun():
    """On the card an overrun is a stray write, so the wrappers raise where
    the reference kernel has no check (ROADMAP §3)."""
    src, dst = torch.ones(4, 3), torch.zeros(4, 8)
    flag, fdst = torch.ones(4, 1), torch.zeros(4, 4)
    ring = [1, 2, 3, 0]
    for call in (
            lambda: put_signal_rows(src, dst, ring, flag=flag, flag_dst=fdst,
                                    offset=6),
            lambda: put_signal_rows(src, dst, ring, flag=flag, flag_dst=fdst,
                                    offset=[0, 0, 6, 0]),
            lambda: put_signal_rows(src, dst, ring, flag=flag, flag_dst=fdst,
                                    flag_offset=4),
            lambda: accumulate_signal_rows(src, dst, ring, flag=flag,
                                           flag_dst=fdst, offset=-1),
            lambda: accumulate_signal(src, dst, flag, axis_size=4,
                                      offset=6)):
        with pytest.raises(ValueError, match="overrun"):
            call()
    put_signal_rows(src, dst, ring, flag=flag, flag_dst=fdst, offset=5,
                    flag_offset=3)                  # the last in-range place


def test_put_signal_rows_per_rank_offsets_counters_and_check():
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.standard_normal((4, 3, 2)).astype(np.float32))
    dst = torch.zeros(4, 9, 2)
    fdst = torch.zeros(4, 2, dtype=torch.int32)
    counters = torch.zeros(4, 2, dtype=torch.int32)
    check = torch.zeros(1, dtype=torch.int32)
    ticks = put_signal_rows(src, dst, [1, 2, 3, -1],
                            flag=torch.ones(4, 1, dtype=torch.int32),
                            flag_dst=fdst, offset=[0, 2, 4, 6], flag_offset=1,
                            counters=counters, stream=1, check=check)
    for r, t in enumerate([1, 2, 3]):
        torch.testing.assert_close(dst[t, 2 * r:2 * r + 3], src[r],
                                   rtol=0, atol=0)
    assert dst[0].abs().sum() == 0                    # rank 3 sends nothing
    assert fdst[:, 1].tolist() == [0, 1, 1, 1]
    assert counters[:, 1].tolist() == [ticks] * 3 + [0]
    assert check.item() == 0
    with pytest.raises(ValueError, match="two origins"):
        put_signal_rows(src, dst, [1, 1, -1, -1], flag=torch.ones(4, 1),
                        flag_dst=torch.zeros(4, 2))


@pytest.mark.parametrize("shape,dtype,offset,unit", [
    ((4, 8, 5121), torch.bfloat16, 0, 16),   # the a2a block: 16-byte copies
    ((4, 4097), torch.int32, 0, 4),          # a ragged int32 row
    ((4, 8, 4), torch.float32, 1, 16),
    ((4, 8, 4), torch.float32, [0, 1, 2, 3], 16),
    ((4, 8, 3), torch.bfloat16, 1, 2),
])
def test_copy_unit_is_the_widest_that_divides_the_layout(shape, dtype, offset,
                                                        unit):
    src = torch.zeros(shape, dtype=dtype)
    dst = torch.zeros((shape[0], shape[1] + 8) + shape[2:], dtype=dtype)
    assert src.data_ptr() % 16 == dst.data_ptr() % 16 == 0
    assert copy_unit(src, dst, offset) == unit


def test_signal_kernels_check_their_scratch():
    src, dst = torch.ones(4, 3), torch.zeros(4, 8)
    sig = dict(flag=torch.ones(4, 1), flag_dst=torch.zeros(4, 4))
    for bad in (torch.zeros(5, dtype=torch.int32), torch.zeros(6)):
        with pytest.raises(ValueError, match="scratch"):
            _scratch(bad, 4, torch.device("cpu"))
    ok = torch.zeros(6, dtype=torch.int32)
    assert _scratch(ok, 4, torch.device("cpu")) is ok
    put_signal_rows(src, dst, [1, 2, 3, 0], scratch=ok, **sig)
    accumulate_signal_rows(src, dst, [1, 2, 3, 0], scratch=ok, **sig)
    assert not ok.any()


# ---------------------------------------------------------------------------
# invariants of the port
# ---------------------------------------------------------------------------

def _sources():
    for root, _, files in os.walk(SRC):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_imports_neither_jax_nor_reference():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                     re.M)
    offenders = [p for p in _sources() if bad.search(open(p).read())]
    assert not offenders, offenders
    assert len(list(_sources())) > 20


WRAPPERS = [
    ("accumulate", lambda: accumulate(torch.zeros(4), torch.ones(4))),
    ("accumulate_rows", lambda: accumulate_rows(torch.zeros(2, 4),
                                                torch.ones(2, 4))),
    ("ring_accumulate", lambda: ring_accumulate(torch.ones(2, 2),
                                                torch.zeros(2, 4),
                                                axis_size=2)),
    ("ring_put", lambda: ring_put(torch.ones(2, 4), axis_size=2)),
    ("put_rows", lambda: put_rows(torch.ones(2, 4), torch.zeros(2, 4),
                                  [1, 0])),
    ("wait_counters", lambda: wait_counters(
        torch.zeros((2, 1), dtype=torch.int32), [0, 0], stream=0,
        stalls=torch.zeros(1, dtype=torch.int32))),
    ("ring_all_reduce", lambda: ring_all_reduce(torch.ones(2, 4),
                                                axis_size=2)),
    ("put_signal", lambda: put_signal(torch.ones(2, 4), torch.ones(2, 1),
                                      axis_size=2)),
    ("put_signal_rows", lambda: put_signal_rows(
        torch.ones(2, 4), torch.zeros(2, 4), [1, 0], flag=torch.ones(2, 1),
        flag_dst=torch.zeros(2, 1))),
    ("accumulate_signal", lambda: accumulate_signal(
        torch.ones(2, 2), torch.zeros(2, 4), torch.ones(2, 1), axis_size=2)),
    ("accumulate_signal_rows", lambda: accumulate_signal_rows(
        torch.ones(2, 4), torch.zeros(2, 4), [1, 0], flag=torch.ones(2, 1),
        flag_dst=torch.zeros(2, 1))),
]


@pytest.mark.parametrize("name,call", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_wrapper_on_card_raises_without_its_library(name, call, monkeypatch):
    """A wrapper handed card tensors launches its kernel or raises — here
    the library cannot be built, and it must not answer with the plain
    version."""
    monkeypatch.setattr(common, "on_device", lambda *ts: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()


def test_entry_points_raise_on_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import tiny_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.train.trainstep import init_train_state

    model = build_model(tiny_config("qwen3-4b"))
    for call in (lambda: model.init(0),
                 lambda: model.init(0, device="cuda"),
                 lambda: init_train_state(model, 0),
                 lambda: train("qwen3-4b", steps=1),
                 lambda: params_from_jax({}, model.cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model.init(0, device="cpu")          # the CPU only when asked for


# ---------------------------------------------------------------------------
# K3's launch shape (the device path's and the host path's alike)
# ---------------------------------------------------------------------------

#: bytes a sender moves: tiny, around a block's share, a qwen3-4b page and a
#: ragged one, past 2^31
PUT_SIZES = (1, 2, 15, 16, 17, 16383, 16384, 16385, 2_359_296 - 14,
             2_359_296, (1 << 31) - 16, 1 << 31, 1 << 40)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 512, 513, 65535])
def test_k3_launch_blocks_stay_within_the_grid(n):
    """Every sender gets at least one block and no more than its bytes ask
    for; the n senders together stay within MAX_BLOCKS (or one block each
    past it) and gridDim.x's limit; a larger payload never gets fewer."""
    from repro_torch.kernels.rma_put import (BLOCK_BYTES, MAX_BLOCKS,
                                             launch_blocks)

    last = 0
    for nbytes in PUT_SIZES:
        blocks = launch_blocks(nbytes, n)
        assert 1 <= blocks <= -(-nbytes // BLOCK_BYTES)
        assert blocks * n <= max(MAX_BLOCKS, n) and blocks <= 2**31 - 1
        assert blocks >= last
        last = blocks


def test_k3_launch_blocks_at_a_page_and_refusals():
    """A qwen3-4b page (2,359,296 bytes) from one sender takes 144 blocks,
    from 8 senders 64 each; no bytes or no sender is refused."""
    from repro_torch.kernels.rma_put import launch_blocks

    assert launch_blocks(2_359_296) == 144
    assert launch_blocks(2_359_296, 8) == 64
    for bad in ((0, 1), (16, 0)):
        with pytest.raises(ValueError):
            launch_blocks(*bad)
