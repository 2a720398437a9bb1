"""A doorbell never rises over a flush that gave up.

The port's flush wait is bounded: a rank still short after its spin adds
one to the family's stall word instead of hanging the card.  A completion
token carries that word, and a ``put_signal(..., after=token)`` hands it to
K4, which lands the payload but leaves the flag untouched (counting the
withheld flag in the signalling window's own stall word) while it is not 0.
The reference's flush cannot give up, so no consumer of its doorbell ever
sees a raised flag over pages that did not land; these tests hold the
port's plain versions to that on the CPU (``chip_smoke.py`` does the same
with K3's wait and K4 on the card)."""
import numpy as np
import pytest
import torch

from repro_torch.core import rma as T
from repro_torch.kernels import common
from repro_torch.kernels.ordered_put_signal import put_signal_rows
from repro_torch.serve import disagg as tdis
from repro_torch.serve import paged as tpaged

N = 4
RING = [(r, (r + 1) % N) for r in range(N)]
CPU = "cpu"
SPEC = dict(page_tokens=4, kv_heads=2, head_dim=4, n_pages=3)


@pytest.fixture(autouse=True)
def _hermetic_crossover(monkeypatch):
    monkeypatch.setenv("RMA_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.setenv("RMA_TORCH_ACC_BENCH_JSON", "/nonexistent")
    monkeypatch.delenv("RMA_ACC_CROSSOVER", raising=False)
    monkeypatch.delenv("RMA_TOPOLOGY", raising=False)


def _push(stall: bool, lane: int = 1):
    """One sequence of two pages pushed around the ring with its doorbell
    ordered after the pool's completion token; ``stall`` makes every rank
    owe the pool's flush one tick more than its puts deliver, so the plain
    wait gives up on all N ranks."""
    rng = np.random.default_rng(5)
    pool = tpaged.PagedKVWindow.create(tpaged.PageSpec(**SPEC), "x", N,
                                       torch.float32, device=CPU)
    ctrl = tdis.make_control_window(1, "x", N, n_lanes=2, device=CPU)
    for p in (0, 1):
        pool = pool.alloc_page(p)
    kvs = [torch.from_numpy(rng.standard_normal(
        (N, 2, SPEC["page_tokens"], SPEC["kv_heads"], SPEC["head_dim"])
    ).astype(np.float32)) for _ in (0, 1)]
    if stall:
        for owed in pool.window.substrate.expected:
            owed[lane] += 1
    pool, ctrl = tdis.push_sequence(pool, ctrl, 0, [0, 1], kvs, RING,
                                    lane=lane)
    ctrl = ctrl.flush(stream=lane)
    return pool, ctrl, kvs


def test_stalled_flush_withholds_the_doorbell_and_counts_it():
    pool, ctrl, kvs = _push(stall=True)
    flag, meta = tdis.read_doorbell(ctrl, 0)
    assert flag.tolist() == [0] * N              # no bell over the stall
    assert meta.tolist() == [2] * N              # the payload still landed
    stats = tdis.pool_stats(pool, ctrl)
    assert int(stats["stalls"]) == N             # every rank came up short
    assert int(stats["ctrl_stalls"]) == N        # one withheld flag a rank
    for p, kv in enumerate(kvs):                 # the plain puts did land
        assert torch.equal(pool.read_page(p), torch.roll(kv, 1, 0))
    assert not ctrl.substrate.completion_ok()


def test_without_a_stall_pages_and_bells_are_as_before():
    """No stall: the pages, the control words and the ledger equal the
    same push whose doorbell carries no token, bit for bit, and 0 stalls
    are reported."""
    pool, ctrl, kvs = _push(stall=False)
    stats = tdis.pool_stats(pool, ctrl)
    assert int(stats["stalls"]) == int(stats["ctrl_stalls"]) == 0
    assert tdis.read_doorbell(ctrl, 0)[0].tolist() == [1] * N
    plain_ctrl = tdis.make_control_window(1, "x", N, n_lanes=2, device=CPU)
    T.put_signal(plain_ctrl, torch.full((N, 1), 2, dtype=torch.int32), RING,
                 data_offset=tdis.ctrl_meta_offset(0),
                 flag_offset=tdis.ctrl_flag_offset(0), stream=1)
    plain_ctrl.flush(stream=1)
    assert torch.equal(ctrl.buffer, plain_ctrl.buffer)
    assert dict(ctrl.ledger.by_kind) == dict(plain_ctrl.ledger.by_kind)
    for p, kv in enumerate(kvs):
        assert torch.equal(pool.read_page(p), torch.roll(kv, 1, 0))
    assert pool.window.substrate.completion_ok()
    assert ctrl.substrate.completion_ok()


def test_token_carries_its_family_stall_word():
    pool = tpaged.PagedKVWindow.create(tpaged.PageSpec(**SPEC), "x", N,
                                       torch.float32, device=CPU)
    tok = pool.window.completion_token(0)
    assert tok.stalls is pool.window.substrate.stalls
    assert tok == pool.window.completion_token(0)   # the word is no key


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("held", [0, 3])
def test_k4_plain_withholds_flags_while_the_hold_word_is_set(ordered, held):
    """K4's plain version: every payload lands either way; with a non-zero
    hold word no flag word changes and ``stalls`` gains one a sending
    origin; with a zero one the result equals the call without ``hold``."""
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.integers(-9, 9, (N, 5)).astype(np.int32))
    targets = [1, 2, -1, 0]
    outs = []
    for hold in (None, torch.tensor([held], dtype=torch.int32)):
        dst = torch.zeros((N, 8), dtype=torch.int32)
        stalls = torch.zeros(1, dtype=torch.int32)
        put_signal_rows(src, dst, targets, flag=torch.ones((N, 1),
                                                           dtype=torch.int32),
                        flag_dst=dst, offset=1, flag_offset=7,
                        ordered=ordered, stalls=stalls, hold=hold)
        outs.append((dst, int(stalls)))
    (free, no_stall), (dst, stalls) = outs
    assert no_stall == 0
    assert torch.equal(dst[:, :7], free[:, :7])
    if held:
        assert not dst[:, 7].any() and stalls == 3
    else:
        assert torch.equal(dst, free) and stalls == 0


def test_k4_on_card_refuses_a_hold_word_it_cannot_read(monkeypatch):
    """Card tensors launch K4 or raise: a hold word that is no int32 on the
    flag rows' device raises before any launch."""
    monkeypatch.setattr(common, "on_device", lambda *ts: True)
    src = torch.zeros((N, 2), dtype=torch.int32)
    dst = torch.zeros((N, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="hold must be an int32"):
        put_signal_rows(src, dst, [1, 2, 3, 0],
                        flag=torch.ones((N, 1), dtype=torch.int32),
                        flag_dst=dst, flag_offset=3,
                        hold=torch.zeros(1, dtype=torch.int64))
