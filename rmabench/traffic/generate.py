"""The general traffic generator: every cell's inputs from its workload
file's ``traffic`` parameters and the run's seed.

Sizes and arrival gaps are *stratified*: a mix of n requests takes the n
quantiles (i + 1/2)/n of its distributions.  An open loop's arrangement of
them is part of the mix, drawn once from the mix's own ``arrangement``
seed, and blocked: the sorted values are cut into ``strata`` bands, and
every run of ``strata`` consecutive requests takes one value of each band.
A tail over ~100 requests moves with the order of the long ones, more
than with anything else a seed changes, so every run's seed draws only the
token ids (and, in a closed loop, the order of the sizes).

Kinds of traffic:

* ``train``: ``ranks`` × ``rows`` sequences of ``seq_len`` + 1 token ids,
  uniform over the vocabulary, a fresh batch each step (drawn on the
  device from a generator of the run's seed);
* ``open``: a Poisson process at ``rate`` requests/s for the window (the
  gaps are the exponential distribution's quantiles), prompt and output
  lengths log-uniform over ``[lo, hi]``, in the mix's arrangement;
* ``closed``: ``clients`` clients, each with a queue of requests whose
  lengths are the quantiles above, permuted; a client sends its next
  request when its last one completes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: numpy streams of a run seed
SIZES, ORDER, TOKENS = 11, 12, 13


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def log_uniform_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    """The n stratified quantiles of a log-uniform integer on [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    return np.floor(np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo)))
                    ).astype(np.int64).clip(lo, hi)


def exponential_quantiles(mean: float, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return -mean * np.log1p(-u)


@dataclasses.dataclass
class Req:
    rid: int
    due: float               # seconds after the window opens (open loop)
    prompt: np.ndarray       # int64 token ids
    max_new: int
    client: int = 0


def blocked(values: np.ndarray, strata: int, g: np.random.Generator
            ) -> np.ndarray:
    """``values`` reordered: sorted, cut into ``strata`` bands of
    consecutive values, each band shuffled, then dealt out a round at a
    time, one value of every band a round in a shuffled order."""
    vals = np.sort(values)
    n = len(vals)
    band = (np.arange(n) * strata) // n
    bands = [g.permutation(vals[band == b]) for b in range(strata)]
    out = []
    for r in range(max(len(b) for b in bands)):
        for b in g.permutation(strata):
            if r < len(bands[b]):
                out.append(bands[b][r])
    return np.asarray(out, dtype=vals.dtype)


def _lengths(spec: dict, key: str, n: int, strata: int,
             g: np.random.Generator):
    lo, hi = spec[key]
    return blocked(log_uniform_quantiles(lo, hi, n), strata, g)


def _prompt(g: np.random.Generator, length: int, vocab: int) -> np.ndarray:
    return g.integers(0, vocab, size=int(length), dtype=np.int64)


def open_loop(spec: dict, seed: int, seconds: float, vocab: int) -> list:
    """The requests due in a window of ``seconds``: ``rate`` × seconds of
    them, arrival gaps from the exponential quantiles in the mix's
    arrangement, the last due before the window closes; token ids from
    ``seed``."""
    n = max(1, int(round(spec["rate"] * seconds)))
    k = spec["strata"]
    gaps = blocked(exponential_quantiles(1.0 / spec["rate"], n), k,
                   rng(spec["arrangement"], ORDER))
    due = np.cumsum(gaps)
    due *= min(1.0, (seconds - 0.5 / spec["rate"]) / due[-1])
    sizes = rng(spec["arrangement"], SIZES)
    prompts = _lengths(spec, "prompt", n, k, sizes)
    outs = _lengths(spec, "output", n, k, sizes)
    toks = rng(seed, TOKENS)
    return [Req(i, float(due[i]), _prompt(toks, prompts[i], vocab),
                int(outs[i])) for i in range(n)]


def closed_loop(spec: dict, seed: int, vocab: int) -> list:
    """Per client, its queue of requests (``per_client`` each)."""
    clients, per = spec["clients"], spec["per_client"]
    n = clients * per
    sizes = rng(seed, SIZES)
    prompts = sizes.permutation(log_uniform_quantiles(*spec["prompt"], n))
    outs = sizes.permutation(log_uniform_quantiles(*spec["output"], n))
    toks = rng(seed, TOKENS)
    reqs = [Req(i, 0.0, _prompt(toks, prompts[i], vocab), int(outs[i]),
                client=i % clients) for i in range(n)]
    return [[r for r in reqs if r.client == c] for c in range(clients)]


class TrainFeed:
    """Token batches ``(ranks, rows, seq_len + 1)`` uniform over the
    vocabulary, one fresh batch a call, from the run's seed."""

    def __init__(self, spec: dict, seed: int, vocab: int, device):
        import torch

        from rmabench.weights import BATCHES, device_seed

        self.shape = (spec["ranks"], spec["rows"], spec["seq_len"] + 1)
        self.vocab = vocab
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(device_seed(seed, BATCHES))

    @property
    def tokens_per_batch(self) -> int:
        r, b, s = self.shape
        return r * b * (s - 1)

    def next(self):
        import torch

        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device, dtype=torch.int64)


def as_train_batch(tokens):
    """A program batch ``{"tokens", "labels"}`` of the global batch (rank
    r's rows contiguous): inputs and next-token labels."""
    flat = tokens.reshape(-1, tokens.shape[-1])
    return {"tokens": flat[:, :-1], "labels": flat[:, 1:]}
