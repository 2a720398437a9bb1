"""Parity of the port's P5 slice with the JAX package: dynamic windows (the
query and active-message slow paths), memory-handle windows on every
accumulate route, the lifetime guarantees (stale handles dropped or
zero-masked and counted; use-after-release raising), a runtime displacement
clamped where the reference clamps it, the plan's handle ops, and every new
operation's phase count against the collective permutes the reference
issues.  The JAX side runs under ``vmap`` over the stacked rank axis; the
tiled route's Pallas fold does not run under ``vmap``, so there the
reference folds through its plain combine (``apply_op``).  Plus K3's and
K2's plain versions with device displacements and the guard, against a
loop oracle.  Inputs are numpy arrays from a seed; n = 4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rma as J
from repro.core.rma import accumulate as j_acc

from repro_torch.core import rma as T
from repro_torch.kernels.intrinsic import (accumulate_rows_atomic,
                                           accumulate_rows_atomic_plain)
from repro_torch.kernels.rma_put import put_rows

N, P = 4, 32
RING = [(r, (r + 1) % N) for r in range(N)]
SHIFT2 = [(r, (r + 2) % N) for r in range(N)]


@pytest.fixture(autouse=True)
def _hermetic_crossover(monkeypatch):
    monkeypatch.setenv("RMA_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.setenv("RMA_TORCH_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.delenv("RMA_ACC_CROSSOVER", raising=False)
    monkeypatch.delenv("RMA_TOPOLOGY", raising=False)


@pytest.fixture
def plain_tiled_reference(monkeypatch):
    """The reference's tiled route folds through its Pallas kernel, which
    has no batching rule under ``vmap``; fold through its plain combine."""
    monkeypatch.setattr(j_acc, "path_combine",
                        lambda path, op: (lambda c, u: j_acc.apply_op(c, u, op)))


def _jax_vmapped(step, *arrays):
    out = jax.vmap(step, axis_name="x")(*map(jnp.asarray, arrays))
    return jax.tree_util.tree_map(np.asarray, out)


def _ppermutes(step, *arrays):
    """The collective permutes one rank's program issues (the reference's
    phase count for it)."""
    one = [jnp.asarray(a)[0] for a in arrays]
    return str(jax.make_jaxpr(step, axis_env=[("x", N)])(*one)).count(
        "ppermute[")


def _pool(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-50, 50, (N, P)).astype(dtype), rng
    return rng.standard_normal((N, P)).astype(dtype), rng


def _t(a):
    return torch.from_numpy(np.array(a))


KW = dict(max_attach=3, am_slots=3, am_msg=6)


def _jdyn(pool, **cfg):
    return J.DynamicWindow.create_dynamic(pool, "x", N, J.WindowConfig(**cfg),
                                          **KW)


def _tdyn(pool, **cfg):
    return T.DynamicWindow.create_dynamic(_t(pool), "x", N,
                                          T.WindowConfig(**cfg), **KW)


# ---------------------------------------------------------------------------
# dynamic windows: the query and AM slow paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seg,detach", [(1, False), (27, False), (2, True)])
def test_put_query_and_get_query_agree(seg, detach):
    """put_query lands at the queried registration (clamped past the pool,
    dropped on a detached slot); get_query reads there.  Ledger = the
    reference's permutes (5 and 4), and a thread flush 2 more."""
    pool, rng = _pool(1)
    data = rng.standard_normal((N, 5)).astype(np.float32)

    def jstep(b, d):
        w = _jdyn(b, scope="thread").attach(1, 3, 20)
        if detach:
            w = w.detach(1)
        w = w.put_query(d, RING, slot=1, seg_offset=seg)
        w, got = w.get_query(SHIFT2, slot=1, seg_offset=seg, size=4)
        return w.flush(stream=0).buffer, got

    want = _jax_vmapped(jstep, pool, data)
    win = _tdyn(pool, scope="thread").attach(1, 3, 20)
    if detach:
        win.detach(1)
    win.put_query(_t(data), RING, slot=1, seg_offset=seg)
    assert win.ledger.total == 5
    _, got = win.get_query(SHIFT2, slot=1, seg_offset=seg, size=4)
    assert win.ledger.total == 9
    win.flush(stream=0)
    assert win.ledger.total == 11
    np.testing.assert_array_equal(win.buffer.numpy(), want[0])
    np.testing.assert_array_equal(got.numpy(), want[1])
    assert win.substrate.completion_ok()
    assert _ppermutes(lambda b, d: _jdyn(b).attach(1, 3, 20).put_query(
        d, RING, slot=1, seg_offset=seg).buffer, pool, data) == 5
    assert _ppermutes(lambda b: _jdyn(b).attach(1, 3, 20).get_query(
        RING, slot=1, seg_offset=seg, size=4)[1], pool) == 4


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_put_am_and_progress_agree(dtype):
    """Two AM puts queue at device indices; nothing lands before progress;
    progress drains both at their registration's offset (one clamped past
    the pool), and the queue empties.  put_am bills 3, flush_am 2."""
    pool, rng = _pool(2, dtype)
    a = (rng.standard_normal((N, 4)) * 10).astype(dtype)
    b = (rng.standard_normal((N, 6)) * 10).astype(dtype)

    def jstep(buf, x, y):
        w = _jdyn(buf).attach(0, 4, 10).attach(2, 24, 8)
        w = w.put_am(x, RING, slot=0, seg_offset=3)
        w = w.put_am(y, SHIFT2, slot=2, seg_offset=5)
        before = w.buffer
        mid = (w.am_data, w.am_meta, w.am_count)
        w = w.progress()
        w = w.flush_am(RING)
        return before, mid, w.buffer, w.am_count

    want = _jax_vmapped(jstep, pool, a, b)
    win = _tdyn(pool).attach(0, 4, 10).attach(2, 24, 8)
    win.put_am(_t(a), RING, slot=0, seg_offset=3)
    win.put_am(_t(b), SHIFT2, slot=2, seg_offset=5)
    assert win.ledger.total == 6
    np.testing.assert_array_equal(win.buffer.numpy(), want[0])
    for got, w in zip((win.am_data, win.am_meta, win.am_count), want[1]):
        np.testing.assert_array_equal(got.numpy(), w)
    win.progress()
    win.flush_am(RING)
    assert win.ledger.total == 8
    np.testing.assert_array_equal(win.buffer.numpy(), want[2])
    np.testing.assert_array_equal(win.am_count.numpy(), want[3])
    assert _ppermutes(lambda bf, x: _jdyn(bf).attach(0, 4, 10).put_am(
        x, RING, slot=0).am_data, pool, a) == 3
    assert _ppermutes(lambda bf: _jdyn(bf).flush_am(RING).tokens, pool) == 2
    assert _ppermutes(lambda bf: _jdyn(bf).progress().buffer, pool) == 0


def test_full_am_queue_drops_the_overflow():
    """A put_am past a full queue is dropped at progress, as the reference's
    out-of-range scatter drops it."""
    pool, rng = _pool(3)
    msgs = rng.standard_normal((KW["am_slots"] + 1, N, 2)).astype(np.float32)

    def jstep(buf, ms):
        w = _jdyn(buf).attach(0, 0, 30)
        for k in range(ms.shape[0]):
            w = w.put_am(ms[k], RING, slot=0, seg_offset=2 * k)
        return w.progress().buffer

    want = _jax_vmapped(jstep, pool, msgs.transpose(1, 0, 2))
    win = _tdyn(pool).attach(0, 0, 30)
    for k in range(msgs.shape[0]):
        win.put_am(_t(msgs[k]), RING, slot=0, seg_offset=2 * k)
    assert win.am_count.tolist() == [KW["am_slots"] + 1] * N
    win.progress()
    np.testing.assert_array_equal(win.buffer.numpy(), want)


# ---------------------------------------------------------------------------
# memory-handle windows
# ---------------------------------------------------------------------------

def _mh_pair(pool, *, release=False, reattach=False, **cfg):
    """The same handle history on both sides: attach slot 0 (and 1), take
    the handle of slot 0, optionally release and re-attach it."""

    def jwin(b):
        w = _jdyn(b, **cfg).attach(0, 5, 16).attach(1, 0, 4)
        mh = J.memhandle_create(w, 0)
        if release:
            w = J.memhandle_release(w, 0)
        if reattach:
            w = w.attach(0, 5, 16)
        return J.win_from_memhandle(w, mh, disp_unit=2)

    w = _tdyn(pool, **cfg).attach(0, 5, 16).attach(1, 0, 4)
    mh = T.memhandle_create(w, 0)
    if release:
        T.memhandle_release(w, 0)
    if reattach:
        w.attach(0, 5, 16)
    return jwin, T.win_from_memhandle(w, mh, disp_unit=2)


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("offset", [3, "ranks", "overrun"])
def test_memhandle_put_and_get_agree(stale, offset):
    """A handle put and get land and read where the reference's do — at
    handle offset + offset × disp_unit, clamped past the pool — and a stale
    handle (released, slot re-attached) is dropped / zero-masked and counted
    at the target.  2 + 2 phases; one K3 launch each."""
    pool, rng = _pool(4)
    data = rng.standard_normal((N, 3)).astype(np.float32)
    offs = {3: 3, "ranks": np.array([0, 2, 4, 5], np.int32),
            "overrun": np.array([1, 40, -9, 3], np.int32)}[offset]
    jwin, mhw = _mh_pair(pool, release=stale, reattach=stale,
                         scope="thread")

    def jstep(b, d, o):
        m = jwin(b)
        o = 3 if offset == 3 else o
        m = m.put(d, RING, offset=o)
        m, got = m.get(SHIFT2, offset=o, size=4)
        return m.flush(0).parent.buffer, got, m.err_count

    want = _jax_vmapped(jstep, pool, data, np.broadcast_to(offs, (N,)))
    toff = 3 if offset == 3 else _t(offs)
    mhw.put(_t(data), RING, offset=toff)
    _, got = mhw.get(SHIFT2, offset=toff, size=4)
    mhw.flush(0)
    np.testing.assert_array_equal(mhw.parent.buffer.numpy(), want[0])
    np.testing.assert_array_equal(got.numpy(), want[1])
    np.testing.assert_array_equal(mhw.err_count.numpy(), want[2])
    assert mhw.err_count.tolist() == ([2] * N if stale else [0] * N)
    assert dict(mhw.parent.ledger.by_kind) == {"put": 2, "get": 2,
                                               "flush": 2}


ACC_ROUTES = [
    # (op, count, dtype, declared, path)
    ("sum", 4, np.float32, True, "intrinsic"),
    ("min", 4, np.int32, True, "intrinsic"),
    ("sum", 12, np.float32, True, "tiled"),
    ("max", 12, np.int32, True, "tiled"),
    ("sum", 4, np.float32, False, "software"),
]


@pytest.mark.usefixtures("plain_tiled_reference")
@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("op,count,dtype,declared,path", ACC_ROUTES)
def test_memhandle_accumulate_every_route(op, count, dtype, declared, path,
                                          stale):
    """Handle accumulates on the intrinsic, tiled and software routes equal
    the reference bit for bit, a stale one is dropped and counted, and the
    ledger bills 2 (+1 ack on the software route)."""
    pool, rng = _pool(5, dtype)
    data = (rng.standard_normal((N, count)) * 9).astype(dtype)
    offs = np.array([0, 1, 30, -2], np.int32)        # two clamp
    cfg = dict(scope="thread", accumulate_ops=(op,), max_atomic_elems=8)
    if declared:
        cfg["same_op"] = op
    assert T.route_accumulate(op, count, np.dtype(dtype).name,
                              T.WindowConfig(**cfg)) == path
    jwin, mhw = _mh_pair(pool, release=stale, reattach=stale, **cfg)

    def jstep(b, d, o):
        m = jwin(b).accumulate(d, RING, op=op, offset=o)
        return m.flush(0).parent.buffer, m.err_count

    want = _jax_vmapped(jstep, pool, data, offs)
    mhw.accumulate(_t(data), RING, op=op, offset=_t(offs))
    assert mhw.parent.ledger.total == (3 if path == "software" else 2)
    mhw.flush(0)
    np.testing.assert_array_equal(mhw.parent.buffer.numpy(), want[0])
    np.testing.assert_array_equal(mhw.err_count.numpy(), want[1])
    assert mhw.err_count.tolist() == ([1] * N if stale else [0] * N)


def test_handle_phase_counts_equal_the_reference():
    """put 2, get 2, accumulate 2 (intrinsic/tiled) or 3 (software): the
    reference's collective permutes, whatever the displacement."""
    pool, _ = _pool(6)
    d = np.ones((N, 2), np.float32)
    for cfg, acc in ((dict(same_op="sum"), 2), ({}, 3)):
        def mk(b):
            w = _jdyn(b, **cfg).attach(0, 0, 8)
            return J.win_from_memhandle(w, J.memhandle_create(w, 0))
        assert _ppermutes(lambda b, x: mk(b).put(x, RING, offset=1)
                          .parent.buffer, pool, d) == 2
        assert _ppermutes(lambda b: mk(b).get(RING, size=2)[1], pool) == 2
        assert _ppermutes(lambda b, x: mk(b).accumulate(x, RING).parent.buffer,
                          pool, d) == acc
        win = _tdyn(pool, **cfg).attach(0, 0, 8)
        mhw = T.win_from_memhandle(win, T.memhandle_create(win, 0))
        mhw.accumulate(_t(d), RING, offset=_t(np.arange(N, dtype=np.int32)))
        assert win.ledger.total == acc


def test_use_after_release_with_slot_raises():
    pool, _ = _pool(7)
    win = _tdyn(pool).attach(0, 0, 8)
    mhw = T.win_from_memhandle(win, T.memhandle_create(win, 0), slot=0)
    mhw.put(torch.ones(N, 2), RING)
    T.memhandle_release(mhw.free(), 0)
    for call in (lambda: mhw.put(torch.ones(N, 2), RING),
                 lambda: mhw.get(RING, size=1),
                 lambda: mhw.accumulate(torch.ones(N, 1), RING)):
        with pytest.raises(RuntimeError, match="after\\s+memhandle_release"):
            call()
    # a window created after the release (no static knowledge of its
    # history) takes the card's check: dropped and counted
    late = T.win_from_memhandle(win, T.memhandle_create(win, 0), slot=0)
    late.put(torch.full((N, 2), 9.0), RING)
    assert late.err_count.tolist() == [1] * N
    assert not (win.buffer == 9.0).any()


def test_fence_raises_and_flush_inherits_thread_scope():
    pool, _ = _pool(8)
    win = _tdyn(pool, scope="thread").attach(0, 0, 8)
    mhw = T.win_from_memhandle(win, T.memhandle_create(win, 0))
    with pytest.raises(RuntimeError, match="passive-target"):
        mhw.fence()
    mhw.put(torch.ones(N, 2), [(0, 0)])
    with pytest.raises(ValueError, match="thread-scope flush must name"):
        mhw.flush()
    assert mhw.flush(0).parent is win
    assert win.ledger.by_kind["flush"] == 2
    with pytest.raises(ValueError, match="memhandle must be"):
        T.win_from_memhandle(win, torch.zeros(4, dtype=torch.int32))


def test_window_get_info_flush_local_and_fence():
    """The reference's remaining window methods: get_info returns the config
    in effect, flush_local costs nothing and keeps the queue (thread scope
    must name a stream), fence drains every stream with no phase."""
    cfg = T.WindowConfig(scope="thread", max_streams=2)
    win = T.Window.allocate(torch.zeros(N, 8), "x", N, cfg)
    assert win.get_info() is cfg
    win.put(torch.ones(N, 2), RING, stream=1)
    with pytest.raises(ValueError, match="thread-scope flush_local"):
        win.flush_local()
    win.flush_local(stream=1)
    assert set(win.group.pending) == {1} and win.ledger.total == 1
    win.fence()
    assert not win.group.pending and win.ledger.total == 1
    assert win.substrate.completion_ok()


def test_thread_flush_of_another_stream_keeps_stream_order():
    """A thread flush whose stream does not own the put just before it:
    overwriting that put's source right after the flush leaves what landed
    intact (on the card the flush's wait ends only after the put has), and
    the put's own stream stays queued until it is flushed."""
    rng = np.random.default_rng(10)
    cfg = T.WindowConfig(scope="thread", max_streams=2)
    win = T.Window.allocate(torch.zeros(N, 64), "x", N, cfg)
    src = torch.from_numpy(rng.standard_normal((N, 64)).astype(np.float32))
    want = torch.roll(src, 1, 0)
    win.put(src[:, :8], RING, stream=0)
    win.put(src, RING, stream=1)
    win.flush(stream=0)
    src.fill_(-1.0)
    assert torch.equal(win.substrate.buffer, want)
    assert set(win.group.pending) == {1}
    win.flush(stream=1)
    assert win.substrate.completion_ok()


# ---------------------------------------------------------------------------
# runtime displacements on allocated windows: clamped where JAX clamps
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("plain_tiled_reference")
def test_overrunning_rank_displacement_lands_where_jax_clamps():
    buf, rng = _pool(9)
    data = rng.standard_normal((N, 6)).astype(np.float32)
    offs = np.array([30, -4, 7, 26], np.int32)
    cfg = dict(scope="thread", same_op="sum", max_atomic_elems=8)

    def jstep(b, d, o):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(**cfg))
        w = w.put(d, RING, offset=o)
        w = w.accumulate(d[:2], SHIFT2, offset=o)          # intrinsic
        w = w.accumulate(jnp.tile(d, 2), RING, offset=o)   # tiled
        w, got = w.get(SHIFT2, offset=o, size=5)
        return w.flush(stream=0).buffer, got

    want = _jax_vmapped(jstep, buf, data, offs)
    win = T.Window.allocate(_t(buf), "x", N, T.WindowConfig(**cfg))
    o = _t(offs)
    win.put(_t(data), RING, offset=o)
    win.accumulate(_t(data[:, :2]), SHIFT2, offset=o)
    win.accumulate(_t(np.tile(data, 2)), RING, offset=o)
    _, got = win.get(SHIFT2, offset=o, size=5)
    win.flush(stream=0)
    np.testing.assert_array_equal(win.buffer.numpy(), want[0])
    np.testing.assert_array_equal(got.numpy(), want[1])
    assert dict(win.ledger.by_kind) == {"put": 2, "accumulate": 4, "get": 3,
                                        "flush": 2}


def test_fetch_op_at_rank_displacements_agrees():
    """Fetch-and-op at per-rank tensor displacements: the old values come
    back by the one-launch read at each origin's address, bit for bit with
    the reference, billed its address phase."""
    rng = np.random.default_rng(11)
    buf = rng.integers(-50, 50, (N, 12)).astype(np.int32)
    data = rng.integers(-50, 50, (N, 3)).astype(np.int32)
    offs = np.array([0, 5, 9, 2], np.int32)

    def jstep(b, d, o):
        w = J.Window.allocate(b, "x", N, J.WindowConfig(scope="thread"))
        w, old = w.fetch_op(d, SHIFT2, op="sum", offset=o)
        return w.flush(stream=0).buffer, old

    want = _jax_vmapped(jstep, buf, data, offs)
    win = T.Window.allocate(_t(buf.copy()), "x", N,
                            T.WindowConfig(scope="thread"))
    _, old = win.fetch_op(_t(data), SHIFT2, op="sum", offset=_t(offs))
    win.flush(stream=0)
    np.testing.assert_array_equal(win.buffer.numpy(), want[0])
    np.testing.assert_array_equal(old.numpy(), want[1])
    assert dict(win.ledger.by_kind) == {"fetch_op": 3, "flush": 2}
    with pytest.raises(ValueError, match="overruns"):
        win.fetch_op(_t(data), SHIFT2, op="sum",
                     offset=_t(np.array([0, 10, 0, 0], np.int32)))


# ---------------------------------------------------------------------------
# plans: put_handle / get_handle
# ---------------------------------------------------------------------------

def _handle_plans(mod, dt):
    p = mod.RmaPlan("p5")
    p.window("w", scope="thread", max_streams=2, exit_epoch=True)
    p.bind("x", (3,), dt)
    p.bind("h", (4,), "int32")
    a = p.put_handle("w", "x", "h", RING, slot=0, offset=2)
    b = p.get_handle("w", "h", SHIFT2, offset=1, size=4, after=(a,))
    p.put("w", "x", RING, offset=20, stream=1)
    p.output("read", b)
    return p.compile()


def test_plan_handle_ops_agree():
    """Compiled phases equal the reference planner's row for row; replayed,
    the buffer, the read and err_count equal the reference's bit for bit,
    fresh and stale, and the replay's ledger equals the prediction."""
    jc, tc = _handle_plans(J, jnp.float32), _handle_plans(T, "float32")
    assert tc.phase_table() == jc.phase_table()
    assert tc.phases == jc.phases
    pool, rng = _pool(10)
    data = rng.standard_normal((N, 3)).astype(np.float32)
    for stale in (False, True):
        def jstep(b, d):
            w = _jdyn(b, scope="thread", max_streams=2).attach(0, 4, 12)
            h = J.memhandle_create(w, 0)
            if stale:
                w = J.memhandle_release(w, 0).attach(0, 4, 12)
            res = jc.execute({"w": w}, {"x": d, "h": h})
            return res.windows["w"].buffer, res.outputs["read"], res.err_count

        want = _jax_vmapped(jstep, pool, data)
        win = _tdyn(pool, scope="thread", max_streams=2).attach(0, 4, 12)
        h = T.memhandle_create(win, 0)
        if stale:
            T.memhandle_release(win, 0).attach(0, 4, 12)
        res = tc.execute({"w": win}, {"x": _t(data), "h": h})
        np.testing.assert_array_equal(res.windows["w"].buffer.numpy(),
                                      want[0])
        np.testing.assert_array_equal(res.outputs["read"].numpy(), want[1])
        np.testing.assert_array_equal(res.err_count.numpy(), want[2])
        assert win.ledger.total == tc.phases
        assert res.err_count.tolist() == ([2] * N if stale else [0] * N)


def test_plan_handle_ops_need_a_dynamic_window():
    tc = _handle_plans(T, "float32")
    win = T.Window.allocate(torch.zeros(N, P), "x", N,
                            T.WindowConfig(scope="thread", max_streams=2))
    with pytest.raises(T.PlanError, match="dynamic window"):
        tc.execute({"w": win}, {"x": torch.zeros(N, 3),
                                "h": torch.zeros(N, 4, dtype=torch.int32)})


# ---------------------------------------------------------------------------
# K3 and K2 plain versions: device displacements and the guard
# ---------------------------------------------------------------------------

def _guard_case(seed, L=20):
    rng = np.random.default_rng(seed)
    regs = torch.zeros((N, 3, 3), dtype=torch.int32)
    regs[:, 1, 0] = 5
    regs[2, 1, 0] = 6                       # rank 2 re-registered: stale there
    handles = torch.tensor([[5, 2, 0, 1]] * N, dtype=torch.int32)
    disp = torch.tensor([0, 3, L, -5], dtype=torch.int32)
    return rng, regs, handles, disp


def _oracle_rows(o, w, L, m, offset, disp, unit, handles, regs):
    rows = offset + (int(disp[o]) * unit if disp is not None else 0)
    fresh = True
    if handles is not None:
        rows += int(handles[o, 1])
        if regs is not None:
            live = int(regs[w, int(handles[o, 3]), 0])
            fresh = live == int(handles[o, 0]) and live > 0
    if disp is not None or handles is not None:
        rows = max(0, min(rows + L if rows < 0 else rows, L - m))
    return rows, fresh


@pytest.mark.parametrize("read", [False, True])
@pytest.mark.parametrize("parts", ["disp", "handles", "guard"])
def test_k3_plain_address_and_guard_match_a_loop(read, parts):
    L, m, tg = 20, 4, [1, 2, 3, -1]
    rng, regs, handles, disp = _guard_case(11, L)
    big = torch.from_numpy(rng.standard_normal((N, L)).astype(np.float32))
    small = torch.from_numpy(rng.standard_normal((N, m)).astype(np.float32))
    kw = dict(disp=disp, disp_unit=2, offset=1)
    if parts != "disp":
        kw["handles"] = handles
    if parts == "guard":
        kw.update(regs=regs, err=torch.zeros(N, dtype=torch.int32))
    src, dst = (big, small.clone()) if read else (small, big.clone())
    want, werr = dst.clone(), torch.zeros(N, dtype=torch.int32)
    for r, t in enumerate(tg):
        if t < 0:
            continue
        o, w = (t, r) if read else (r, t)
        rows, fresh = _oracle_rows(o, w, L, m, 1, disp, 2, kw.get("handles"),
                                   kw.get("regs"))
        werr[w] += not fresh
        if read:
            want[t] = src[r, rows:rows + m] if fresh else 0
        elif fresh:
            want[t, rows:rows + m] = src[r]
    cnt = torch.zeros((N, 1), dtype=torch.int32)
    put_rows(src, dst, tg, counters=cnt, read=read, **kw)
    assert torch.equal(dst, want)
    assert cnt[:, 0].tolist() == [1, 1, 1, 0]
    if parts == "guard":
        assert torch.equal(kw["err"], werr) and int(werr.sum()) == 1


@pytest.mark.parametrize("op,dtype", [("sum", torch.float32),
                                      ("max", torch.int32),
                                      ("bxor", torch.int64)])
def test_k2_plain_address_and_guard_match_a_loop(op, dtype):
    L, m, tg = 20, 3, [2, 3, 0, 1]
    rng, regs, handles, disp = _guard_case(12, L)
    buf = torch.from_numpy(rng.integers(-9, 9, (N, L))).to(dtype)
    upd = torch.from_numpy(rng.integers(-9, 9, (N, m))).to(dtype)
    err = torch.zeros(N, dtype=torch.int32)
    want, werr = buf.clone(), torch.zeros(N, dtype=torch.int32)
    for r, t in enumerate(tg):
        rows, fresh = _oracle_rows(r, t, L, m, 0, disp, 1, handles, regs)
        if not fresh:
            werr[t] += 1
            continue
        cur = want[t, rows:rows + m]
        want[t, rows:rows + m] = {"sum": torch.add, "max": torch.maximum,
                                  "bxor": torch.bitwise_xor}[op](cur, upd[r])
    accumulate_rows_atomic(upd, buf, tg, op=op, disp=disp, handles=handles,
                           regs=regs, err=err)
    assert torch.equal(buf, want) and torch.equal(err, werr)
    again = accumulate_rows_atomic_plain(upd, want.clone(), tg, op=op,
                                         offset=2)
    assert again.shape == want.shape
    with pytest.raises(ValueError, match="overruns"):
        accumulate_rows_atomic(upd, buf, tg, op=op, offset=L - 2)
    with pytest.raises(ValueError, match="handles too"):
        accumulate_rows_atomic(upd, buf, tg, op=op, disp=disp, regs=regs)
