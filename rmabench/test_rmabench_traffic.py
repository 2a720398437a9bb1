"""The traffic generators: deterministic per seed, the same work for every
seed (stratified sizes and gaps, permuted), and within their bounds."""
import numpy as np
import pytest
import torch

from rmabench.traffic import generate

CHAT = {"rate": 3.0, "strata": 8, "arrangement": 1, "prompt": [512, 4096],
        "output": [32, 256]}
BATCH = {"clients": 4, "per_client": 5, "prompt": [64, 512],
         "output": [64, 512]}
SEEDS = [0, 7, 2**31 + 5, 10**12 + 39]


def _key(reqs):
    return [(r.rid, r.due, r.prompt.tolist(), r.max_new) for r in reqs]


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_deterministic_per_seed(seed):
    a = generate.open_loop(CHAT, seed, 40.0, 65536)
    b = generate.open_loop(CHAT, seed, 40.0, 65536)
    assert _key(a) == _key(b)
    assert len(a) == 120
    assert all(0 < r.due < 40.0 for r in a)
    assert [r.due for r in a] == sorted(r.due for r in a)
    assert all(512 <= len(r.prompt) <= 4096 and 32 <= r.max_new <= 256
               for r in a)
    assert all(0 <= int(r.prompt.min()) and int(r.prompt.max()) < 65536
               for r in a)


def test_open_loop_same_arrangement_every_seed():
    runs = [generate.open_loop(CHAT, s, 40.0, 65536) for s in SEEDS]
    shape = [(r.due, len(r.prompt), r.max_new) for r in runs[0]]
    for reqs in runs[1:]:
        assert [(r.due, len(r.prompt), r.max_new) for r in reqs] == shape
    assert _key(runs[0]) != _key(runs[1])        # the token ids differ
    other = generate.open_loop(dict(CHAT, arrangement=2), 0, 40.0, 65536)
    assert sorted(len(r.prompt) for r in other) == sorted(s[1] for s in
                                                          shape)
    assert [len(r.prompt) for r in other] != [s[1] for s in shape]


def test_log_uniform_quantiles_span_the_range():
    q = generate.log_uniform_quantiles(512, 4096, 1000)
    assert q.min() >= 512 and q.max() <= 4096
    # half the mass lies below the geometric middle
    assert abs(np.median(q) - np.sqrt(512 * 4097)) < 0.01 * np.sqrt(512 * 4097)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_closed_loop_deterministic(seed):
    a = generate.closed_loop(BATCH, seed, 1000)
    b = generate.closed_loop(BATCH, seed, 1000)
    assert [_key(q) for q in a] == [_key(q) for q in b]
    assert [len(q) for q in a] == [5] * 4
    assert all(r.client == c and r.rid % 4 == c
               for c, q in enumerate(a) for r in q)


def test_train_feed_deterministic_and_fresh():
    spec = {"ranks": 4, "rows": 2, "seq_len": 16}
    f1 = generate.TrainFeed(spec, 2**31 + 11, 300, "cpu")
    f2 = generate.TrainFeed(spec, 2**31 + 11, 300, "cpu")
    a1, b1 = f1.next(), f1.next()
    assert torch.equal(a1, f2.next()) and torch.equal(b1, f2.next())
    assert a1.shape == (4, 2, 17) and not torch.equal(a1, b1)
    assert f1.tokens_per_batch == 4 * 2 * 16
    other = generate.TrainFeed(spec, 5, 300, "cpu").next()
    assert not torch.equal(a1, other)
    batch = generate.as_train_batch(a1)
    assert torch.equal(batch["labels"][:, :-1], batch["tokens"][:, 1:])


def test_blocked_order_spreads_every_band():
    vals = np.arange(100)
    out = generate.blocked(vals, 8, np.random.default_rng(3))
    assert sorted(out.tolist()) == vals.tolist()
    band = (np.arange(100) * 8) // 100
    # every run of 8 values (12 whole rounds) holds one of each band
    for r in range(12):
        assert sorted(band[out[8 * r:8 * r + 8]]) == list(range(8))
    other = generate.blocked(vals, 8, np.random.default_rng(4))
    assert other.tolist() != out.tolist()
