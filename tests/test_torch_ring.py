"""K5's ring protocol under arbitrary schedules.

``ring_ar_kernel`` (``src/repro_torch/csrc/ring_allreduce.cu``) reads the
neighbour's row in place, with no landing slot and no credit word.  Its
step program, ``kernels.ring_allreduce.agent_program``, is run here for
every (rank, agent) with the steps of different agents interleaved at
random: each wait blocks until the neighbour's ready word has the value,
and each add or copy is split into its reads and its writes, so another
agent may run between them.  Every read must see the version of its
locations that the lock-step ring (all reads of a step, then all writes)
gives it — an older one is a read before the neighbour's write, a newer one
a read after a later hop or the all-gather overwrote it — and the result
must equal ``ring_all_reduce_plain`` bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ring_allreduce import (agent_program,
                                                ring_all_reduce_plain)


def _events(n, chunk, tile, agents, r, g):
    """The agent's steps with each add and copy split into read + write."""
    for step in agent_program(n, chunk, tile, agents, r, g):
        if step[0] in ("add", "copy"):
            yield ("read",) + step
            yield ("write",) + step
        else:
            yield step


class _Ring:
    """Memory of the stacked ranks: values, and a version per element that
    every write bumps."""

    def __init__(self, x, n, chunk, agents):
        self.x = x.copy()
        self.version = np.zeros(x.shape, np.int64)
        self.ready = np.zeros((n, agents), np.int64)
        self.n, self.chunk = n, chunk

    def cols(self, c, lo, hi):
        return slice(c * self.chunk + lo, c * self.chunk + hi)

    def read(self, r, step):
        kind, c, lo, hi = step[0], step[1], step[2], step[3]
        cols = self.cols(c, lo, hi)
        rows = (r, (r - 1) % self.n) if kind == "add" else (r,)
        return ([self.x[q, cols].copy() for q in rows],
                [self.version[q, cols].copy() for q in rows])

    def write(self, r, step, values):
        kind, c, lo, hi = step[0], step[1], step[2], step[3]
        cols = self.cols(c, lo, hi)
        if kind == "add":
            total = values[0] + values[1]          # one float32 add
            targets = [r] + ([step[4]] if step[4] is not None else [])
        else:
            total, targets = values[0], [(r + 1) % self.n]
        for q in targets:
            self.x[q, cols] = total
            self.version[q, cols] += 1


def _lockstep(x, n, chunk, tile, agents):
    """The versions every read must see, from the ring in lock step: step
    p of every agent reads, then every agent writes, then releases."""
    mem = _Ring(x, n, chunk, agents)
    progs = {(r, g): list(agent_program(n, chunk, tile, agents, r, g))
             for r in range(n) for g in range(agents)}
    seen = {a: [] for a in progs}
    for p in range(max(len(s) for s in progs.values())):
        live = {a: s[p] for a, s in progs.items() if p < len(s)}
        got = {}
        for (r, g), step in live.items():
            if step[0] == "wait":
                assert mem.ready[step[1], g] >= step[2], "lock step stalls"
            elif step[0] in ("add", "copy"):
                got[(r, g)] = mem.read(r, step)
                seen[(r, g)].append(got[(r, g)][1])
        for (r, g), step in live.items():
            if step[0] in ("add", "copy"):
                mem.write(r, step, got[(r, g)][0])
        for (r, g), step in live.items():
            if step[0] == "release":
                mem.ready[r, g] = step[1]
    return mem, seen


def _interleaved(x, n, chunk, tile, agents, rng, seen):
    """Run every agent's events in a random interleaving, checking each
    read's versions against the lock-step ring's."""
    mem = _Ring(x, n, chunk, agents)
    events = {(r, g): list(_events(n, chunk, tile, agents, r, g))
              for r in range(n) for g in range(agents)}
    pos = {a: 0 for a in events}
    held, reads = {}, {a: 0 for a in events}

    def enabled(a):
        if pos[a] >= len(events[a]):
            return False
        ev = events[a][pos[a]]
        return ev[0] != "wait" or mem.ready[ev[1], a[1]] >= ev[2]

    while True:
        ready = [a for a in events if enabled(a)]
        if not ready:
            assert all(pos[a] == len(events[a]) for a in events), \
                "the ring deadlocked"
            return mem
        a = ready[rng.integers(len(ready))]
        for _ in range(int(rng.geometric(0.4))):     # a burst of one agent
            if not enabled(a):
                break
            ev = events[a][pos[a]]
            r, g = a
            if ev[0] == "read":
                values, versions = mem.read(r, ev[1:])
                want = seen[a][reads[a]]
                reads[a] += 1
                for v, w in zip(versions, want):
                    assert not (v < w).any(), (
                        f"rank {r} agent {g} {ev[1:]} read before the "
                        f"neighbour's write (version {v} < {w})")
                    assert not (v > w).any(), (
                        f"rank {r} agent {g} {ev[1:]} read a location "
                        f"already overwritten (version {v} > {w})")
                held[a] = values
            elif ev[0] == "write":
                mem.write(r, ev[1:], held.pop(a))
            elif ev[0] == "release":
                assert ev[1] > mem.ready[r, g], "a ready word went back"
                mem.ready[r, g] = ev[1]
            pos[a] += 1


@pytest.mark.parametrize("tiles", ["several", "one"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_k5_protocol_under_random_schedules(n, tiles):
    """40 seeded schedules each, over ragged chunks: tiles of 1-3 floats,
    several an agent, as the tile counters run at a large chunk; or one
    tile an agent (a whole slice), as at a chunk below the agents' tiles."""
    for seed in range(40):
        rng = np.random.default_rng(1000 * n + 100 * (tiles == "one") + seed)
        chunk = int(rng.integers(1, 8))
        agents = int(rng.integers(1, 4))
        tile = (int(rng.integers(1, 4)) if tiles == "several"
                else -(-chunk // agents))
        x = rng.standard_normal((n, n * chunk)).astype(np.float32)
        want_mem, seen = _lockstep(x, n, chunk, tile, agents)
        mem = _interleaved(x, n, chunk, tile, agents, rng, seen)
        assert np.array_equal(mem.version, want_mem.version)
        want = ring_all_reduce_plain(torch.from_numpy(x.copy()))
        assert torch.equal(torch.from_numpy(mem.x), want), (n, tiles, seed)


def test_k5_lockstep_is_the_plain_ring():
    """The lock-step run of the step program is the plain ring itself, so
    the versions it hands the schedule test are the intended ones."""
    rng = np.random.default_rng(7)
    for n, chunk, tile, agents in ((2, 5, 2, 2), (4, 6, 4, 1), (8, 3, 1, 3)):
        x = rng.standard_normal((n, n * chunk)).astype(np.float32)
        mem, _ = _lockstep(x, n, chunk, tile, agents)
        want = ring_all_reduce_plain(torch.from_numpy(x.copy()))
        assert torch.equal(torch.from_numpy(mem.x), want)
        # every row ends as the sum
        assert np.allclose(mem.x, x.sum(0, keepdims=True).repeat(n, 0),
                           rtol=1e-5, atol=1e-5)
