"""Deterministic, shardable token pipelines (synthetic + file-backed).

Both sources implement the same contract:

    batches = source.batches(step_start)          # infinite iterator
    batch   = next(batches)                       # numpy, GLOBAL batch
    shard   = source.host_shard(batch, host, n)   # this host's rows

Determinism: batch contents are a pure function of (seed, step), so a
restarted job resumes mid-epoch bit-identically — the property the
checkpoint/restart test asserts.  Sharding is by contiguous row blocks, so
elastic re-runs with a different host count still see the same global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"  # synthetic | file
    path: str | None = None


def _philox(seed: int, step: int, rows: int, cols: int, vocab: int) -> np.ndarray:
    """Counter-based deterministic token block (no RNG state to checkpoint)."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=step))
    return rng.integers(0, vocab, size=(rows, cols), dtype=np.int32)


class SyntheticLM:
    """Markov-flavoured synthetic LM data: learnable but trivial structure
    (next token = affine function of current + noise) so loss demonstrably
    decreases in examples/integration tests."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        base = _philox(c.seed, step, c.global_batch, c.seq_len + 1, c.vocab)
        # inject structure: token[t+1] ≡ (7·token[t] + 13) mod vocab, 50% of
        # the time — a pattern a model can learn quickly.
        det = (7 * base[:, :-1] + 13) % c.vocab
        mask = _philox(c.seed + 1, step, c.global_batch, c.seq_len, 2)
        nxt = np.where(mask.astype(bool), det, base[:, 1:])
        tokens = base[:, :-1]
        labels = nxt
        return {"tokens": tokens, "labels": labels}

    def batches(self, step_start: int = 0) -> Iterator[dict]:
        step = step_start
        while True:
            yield self.batch_at(step)
            step += 1

    @staticmethod
    def host_shard(batch: dict, host: int, n_hosts: int) -> dict:
        def shard(x):
            rows = x.shape[0]
            assert rows % n_hosts == 0, (rows, n_hosts)
            per = rows // n_hosts
            return x[host * per : (host + 1) * per]
        return {k: shard(v) for k, v in batch.items()}


class FileTokens:
    """Memory-mapped flat token file (uint16/uint32), sequence-packed.

    Deterministic: sequence i of step s starts at a hash-derived offset, so
    restarts and different host counts see identical global batches.
    """

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        if len(self.data) < cfg.seq_len + 2:
            raise ValueError("token file smaller than one sequence")

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        n = len(self.data) - c.seq_len - 1
        offs = _philox(c.seed ^ 0x5EED, step, c.global_batch, 1, n)[:, 0]
        tokens = np.stack([self.data[o : o + c.seq_len] for o in offs]).astype(np.int32)
        labels = np.stack([self.data[o + 1 : o + 1 + c.seq_len] for o in offs]).astype(np.int32)
        return {"tokens": tokens % c.vocab, "labels": labels % c.vocab}

    batches = SyntheticLM.batches
    host_shard = staticmethod(SyntheticLM.host_shard)


def make_source(cfg: DataConfig):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg)
    if cfg.kind == "file":
        return FileTokens(cfg)
    raise ValueError(f"unknown data kind {cfg.kind!r}")


__all__ = ["DataConfig", "SyntheticLM", "FileTokens", "make_source"]
