"""The port's checkpointing and fault-tolerance loop against the JAX
package: every checkpoint and straggler case of
``tests/test_fault_tolerance.py`` on ``repro_torch``, checkpoints that cross
between the two packages (bfloat16 leaves included), the reference's
messages, and the port launcher's preemption and resume.  Tokens and
values come from numpy with a seed."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs.tiny import tiny_config as j_tiny_config
from repro.models import build_model as j_build_model
from repro.train.optimizer import init_opt_state as j_init_opt_state

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs import tiny_config
from repro_torch.convert import params_from_jax
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.launch import train as train_mod
from repro_torch.train.optimizer import init_opt_state
from repro_torch.tree import leaves


def _state(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(
                rng.standard_normal((16, 8)).astype(np.float32) * scale),
            "nested": {"b": torch.from_numpy(
                           rng.standard_normal(8).astype(np.float32)),
                       "step": torch.tensor(3, dtype=torch.int32)}}


def _bits(rng, shape):
    """Random bfloat16 bit patterns (finite: exponent below all-ones)."""
    b = rng.integers(0, 1 << 16, shape, dtype=np.int64).astype(np.uint16)
    b &= np.uint16(0xBFFF)            # clear the exponent's top bit
    return b.view(np.int16)


def _mixed(seed):
    """The same tree for both packages: float32, int32 and bfloat16
    leaves, nested dicts and a list, a key with a '/'."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((4, 3)).astype(np.float32)
    i = rng.integers(-9, 9, (5,)).astype(np.int32)
    h = _bits(rng, (2, 6))
    jt = {"p": {"w": jnp.asarray(f),
                "a/b": [jnp.asarray(i), jnp.asarray(h.view(jnp.bfloat16))]},
          "step": jnp.asarray(7, jnp.int32)}
    tt = {"p": {"w": torch.from_numpy(f.copy()),
                "a/b": [torch.from_numpy(i.copy()),
                        torch.from_numpy(h.copy()).view(torch.bfloat16)]},
          "step": torch.tensor(7, dtype=torch.int32)}
    return jt, tt


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the reference's checkpoint cases
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_bitwise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(0)
    mgr.save(10, state, blocking=True)
    like = {"w": torch.zeros(16, 8),
            "nested": {"b": torch.zeros(8),
                       "step": torch.zeros((), dtype=torch.int32)}}
    restored = mgr.restore(10, like)
    for a, b in zip(leaves(state), leaves(restored)):
        _same(a, b)


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s), blocking=True)
    kept = sorted(int(d) for d in os.listdir(tmp_path))
    assert kept == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_incomplete_save_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state(0), blocking=True)
    os.makedirs(tmp_path / "7.tmp")      # a crashed save
    assert mgr.latest_step() == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4, 4)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"w": torch.zeros(2, 2)})


def test_restore_missing_step_names_step_and_directory(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _state(0), blocking=True)
    mgr.save(20, _state(1), blocking=True)
    with pytest.raises(FileNotFoundError) as ei:
        mgr.restore(99, _state(0))
    msg = str(ei.value)
    assert "step 99" in msg and str(tmp_path) in msg
    assert "[10, 20]" in msg
    empty = CheckpointManager(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="available steps: none"):
        empty.restore(0, _state(0))


def test_errors_are_the_references_word_for_word(tmp_path):
    """The missing-step, leaf-count and shape errors read exactly as the
    JAX package's, directory aside."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jm, tm = JCheckpointManager(jdir), CheckpointManager(tdir)
    jm.save(3, {"w": jnp.zeros((4, 4))}, blocking=True)
    tm.save(3, {"w": torch.zeros(4, 4)}, blocking=True)
    cases = [
        (lambda m: m.restore(9, {"w": 0}), FileNotFoundError),
        (lambda m: m.restore(3, {"w": 0, "v": 0}), ValueError),
    ]
    for call, exc in cases:
        with pytest.raises(exc) as je:
            call(jm)
        with pytest.raises(exc) as te:
            call(tm)
        assert str(te.value).replace(tdir, "D") == \
            str(je.value).replace(jdir, "D")
    with pytest.raises(ValueError) as je:
        jm.restore(3, {"w": jnp.zeros((2, 2))})
    with pytest.raises(ValueError) as te:
        tm.restore(3, {"w": torch.zeros(2, 2)})
    assert str(te.value) == str(je.value)


def test_restore_places_on_the_current_device(tmp_path):
    """The stacked layout's counterpart of the reference's elastic restore
    (tests/mdev/elastic_restore.py): every leaf lands on ``like``'s device
    in ``like``'s dtype, or on the ``device`` asked for."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(64.0).reshape(8, 8)
    mgr.save(1, {"w": w, "b": torch.ones(8)}, blocking=True)
    like = {"w": torch.zeros(8, 8), "b": torch.zeros(8)}
    got = mgr.restore(1, like)
    assert torch.equal(got["w"], w) and got["w"].device.type == "cpu"
    on_meta = mgr.restore(1, like, device="meta")
    assert all(t.is_meta for t in leaves(on_meta))
    assert on_meta["w"].shape == (8, 8)
    as64 = mgr.restore(1, {"w": torch.zeros(8, 8, dtype=torch.float64),
                           "b": torch.zeros(8)})
    assert as64["w"].dtype == torch.float64
    assert torch.equal(as64["w"], w.double())


def test_resave_is_idempotent_and_errors_surface_on_wait(tmp_path,
                                                         monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    a, b = _state(0), _state(1)
    mgr.save(5, a, blocking=True)
    mgr.save(5, b, blocking=True)        # step already committed
    got = mgr.restore(5, _state(2))
    for x, y in zip(leaves(a), leaves(got)):
        _same(x, y)
    assert sorted(os.listdir(tmp_path)) == ["5"]

    def boom(path, leaf):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt_mod, "_save_leaf", boom)
    mgr.save(6, a)                       # asynchronous: returns
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                           # raised once
    assert mgr.latest_step() == 5


def test_host_copy_is_taken_before_save_returns(tmp_path, monkeypatch):
    """Training updates parameters in place right after ``save`` returns:
    the checkpoint holds the values at the call, not later ones."""
    import threading

    gate = threading.Event()
    real = ckpt_mod._save_leaf

    def slow(path, leaf):
        gate.wait(10)
        return real(path, leaf)
    monkeypatch.setattr(ckpt_mod, "_save_leaf", slow)
    mgr = CheckpointManager(str(tmp_path))
    state = _state(0)
    want = [t.clone() for t in leaves(state)]
    mgr.save(1, state)
    for t in leaves(state):
        t.add_(1)                        # the next step's in-place update
    gate.set()
    mgr.wait()
    assert mgr.stats["bytes"] == sum(t.numel() * t.element_size()
                                     for t in want)
    assert mgr.stats["copy_ms"] >= 0 and mgr.stats["write_ms"] >= 0
    got = mgr.restore(1, _state(2))
    for x, y in zip(want, leaves(got)):
        _same(x, y)


# ---------------------------------------------------------------------------
# one on-disk format for both packages
# ---------------------------------------------------------------------------

def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jt, tt = _mixed(1)
    JCheckpointManager(str(tmp_path)).save(4, jt, blocking=True)
    like = {"p": {"w": torch.zeros(4, 3),
                  "a/b": [torch.zeros(5, dtype=torch.int32),
                          torch.zeros(2, 6, dtype=torch.bfloat16)]},
            "step": torch.zeros((), dtype=torch.int32)}
    got = CheckpointManager(str(tmp_path)).restore(4, like)
    for x, y in zip(leaves(tt), leaves(got)):
        _same(x, y)


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    """The port writes the reference's files byte for byte, bfloat16
    included.  The JAX package restores the float32 and int32 leaves; it
    cannot cast its own ``'<V2'`` bfloat16 files back (ROADMAP §3, reference
    caveats), so that leaf is checked through numpy."""
    jt, tt = _mixed(2)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    JCheckpointManager(str(jdir)).save(4, jt, blocking=True)
    CheckpointManager(str(tdir)).save(4, tt, blocking=True)
    files = sorted(os.listdir(jdir / "4"))
    assert files == sorted(os.listdir(tdir / "4"))
    for fn in files:
        assert (jdir / "4" / fn).read_bytes() == (tdir / "4" / fn).read_bytes()
    plain = {"p": {"w": jt["p"]["w"]}, "step": jt["step"]}
    CheckpointManager(str(tmp_path / "t2")).save(
        1, {"p": {"w": tt["p"]["w"]}, "step": tt["step"]}, blocking=True)
    got = JCheckpointManager(str(tmp_path / "t2")).restore(
        1, jax.tree.map(jnp.zeros_like, plain))
    for x, y in zip(jax.tree.leaves(plain), jax.tree.leaves(got)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    manifest = json.loads((tdir / "4" / "manifest.json").read_text())
    (bf,) = [m for m in manifest["leaves"] if m["dtype"] == "bfloat16"]
    arr = np.load(tdir / "4" / bf["file"])
    np.testing.assert_array_equal(
        arr.view(np.int16), tt["p"]["a/b"][1].view(torch.int16).numpy())


def test_manifests_name_leaves_identically(tmp_path):
    """A train state — tiny qwen3-4b's parameters and AdamW state — gives
    the same manifest from either package: names (``keystr``), files,
    shapes, dtypes."""
    cfg = j_tiny_config("qwen3-4b")
    jp = jax.jit(j_build_model(cfg).init)(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), tiny_config("qwen3-4b"),
                         device="cpu")
    JCheckpointManager(str(tmp_path / "j")).save(
        1, {"params": jp, "opt": j_init_opt_state(jp)}, blocking=True)
    CheckpointManager(str(tmp_path / "t")).save(
        1, {"params": tp, "opt": init_opt_state(tp)}, blocking=True)
    jm = json.loads((tmp_path / "j" / "1" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "t" / "1" / "manifest.json").read_text())
    assert tm == jm
    names = [m["name"] for m in tm["leaves"]]
    assert "['opt']['step']" in names
    assert any(n.startswith("['params']['stack']['scan']") for n in names)


# ---------------------------------------------------------------------------
# the launcher: preemption, resume, stragglers
# ---------------------------------------------------------------------------

def test_restart_resumes_bitwise_identical(tmp_path):
    """Train 30 steps with a simulated preemption at 20; the resumed run's
    losses and final parameters equal an uninterrupted run's bit for bit
    (deterministic data and state on the CPU)."""
    kw = dict(steps=30, ckpt_every=10, global_batch=2, seq_len=16,
              log_every=1000, device="cpu")
    ref = train_mod.train("qwen3-4b", ckpt_dir=str(tmp_path / "a"), **kw)
    d2 = str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="simulated preemption at step 20"):
        train_mod.train("qwen3-4b", ckpt_dir=d2, fail_at_step=20, **kw)
    assert CheckpointManager(d2).latest_step() == 20
    resumed = train_mod.train("qwen3-4b", ckpt_dir=d2, resume=True, **kw)
    assert resumed.steps_run == 10 and resumed.final_step == 30
    assert resumed.losses == ref.losses[20:]
    for a, b in zip(leaves(ref.params), leaves(resumed.params)):
        assert torch.equal(a, b)
    assert CheckpointManager(d2).latest_step() == 30


def test_launcher_counts_straggler_events(monkeypatch):
    """``TrainRun.straggler_events`` is the monitor's event count: steps
    timed at 1, and one at 10 after the warmup."""
    slow_at = 8

    class Fake(StragglerMonitor):
        def stop(self, step, source="local"):
            self._t0 = None
            return self.observe(step, 10.0 if step == slow_at else 1.0,
                                source)

    monkeypatch.setattr(train_mod, "StragglerMonitor", Fake)
    run = train_mod.train("qwen3-4b", steps=10, global_batch=2, seq_len=8,
                          log_every=1000, device="cpu")
    assert run.straggler_events == 1


def test_cli_preempts_and_resumes(tmp_path, capsys):
    args = ["--arch", "qwen3-4b", "--steps", "4", "--global-batch", "2",
            "--seq-len", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="simulated preemption at step 2"):
        train_mod.main(args + ["--fail-at-step", "2"])
    train_mod.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out and "stragglers=0" in out
    assert sorted(os.listdir(tmp_path)) == ["2", "4"]


# ---------------------------------------------------------------------------
# the straggler monitor (the reference's cases)
# ---------------------------------------------------------------------------

def test_straggler_detection_and_escalation():
    escalated = []
    mon = StragglerMonitor(threshold=2.0, warmup_steps=2, escalate_after=3,
                           on_escalate=escalated.append)
    for s in range(10):
        mon.observe(s, 1.0)
    assert mon.events == []
    for s in range(10, 14):
        mon.observe(s, 5.0, source="host7")
    assert len(mon.events) == 4
    assert mon.chronic_offenders() == ["host7"]
    assert escalated and escalated[0].source == "host7"
    assert mon.ema < 1.5


def test_straggler_stop_without_start_raises_runtime_error():
    mon = StragglerMonitor()
    with pytest.raises(RuntimeError, match="without a matching start"):
        mon.stop(0)
    mon.start()
    mon.stop(0)


def test_straggler_reset_source_forgets_offender():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=2, escalate_after=2)
    for s in range(6):
        mon.observe(s, 1.0, source="w0")
        mon.observe(s, 1.0, source="w1")
    for s in range(6, 10):
        mon.observe(s, 8.0, source="w1")
    assert mon.chronic_offenders() == ["w1"]
    mon.reset(source="w1")
    assert mon.chronic_offenders() == []
    assert all(e.source != "w1" for e in mon.events)
    assert mon.ema == pytest.approx(1.0)
    mon.reset()
    assert mon.observe(0, 50.0, source="w0") is None


def test_straggler_warmup_tolerant():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=5)
    mon.observe(0, 1.0)
    assert mon.observe(1, 30.0) is None


def test_straggler_warmup_outlier_does_not_mask_detection():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=5)
    for s, dt in enumerate([10.0, 1.0, 1.0, 1.0, 1.0]):
        assert mon.observe(s, dt) is None
    assert mon.ema == 1.0
    for s in range(5, 10):
        assert mon.observe(s, 1.0) is None
    ev = mon.observe(10, 3.0, source="host3")
    assert ev is not None and ev.source == "host3"
    assert ev.ratio == pytest.approx(3.0)
    assert mon.ema == 1.0


def test_straggler_outlier_mid_warmup_rejected_from_baseline():
    mon = StragglerMonitor(threshold=2.0, warmup_steps=4)
    mon.observe(0, 1.0)
    mon.observe(1, 20.0)
    mon.observe(2, 1.0)
    mon.observe(3, 1.0)
    assert mon.ema == 1.0
    assert mon.observe(4, 5.0) is not None
