"""Faults planted underneath the timed path, to show that the check
catches them: in the CPU tests, and in readings on the card
(``run.py --readings <seeds> --fault <name>``).  Each is a context manager
that patches the program and restores it."""
from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def state_unchanged():
    """A train step that returns its parameters and optimizer state
    unchanged."""
    import repro_torch.train.trainstep as ts

    return _patch(ts, "adamw_update",
                  lambda grads, opt, params, cfg: (params, opt, {}))


def half_batch():
    """Half of every rank's rows left out, the mean taken over the rest."""
    from repro_torch.models.model import Model

    loss = Model.loss

    def half(self, params, batch):
        n = max(1, batch["tokens"].shape[0] // 2)
        return loss(self, params, {k: v[:n] for k, v in batch.items()})

    return _patch(Model, "loss", half)


def no_exchange():
    """The gradient all-reduce left out: every rank keeps its own row."""
    import repro_torch.core.rma.collectives as coll

    return _patch(coll, "plan_all_reduce", lambda mat, *a, **k: mat)


def altered_token():
    """Every fifth decode tick's tokens altered where they are produced."""
    from repro_torch.serve.engine import Executor

    decode = Executor.decode
    ticks = []

    def altered(self, last_tokens):
        out = decode(self, last_tokens)
        ticks.append(1)
        if len(ticks) % 5 == 0:
            out = (np.asarray(out) + 1) % self.model.cfg.vocab
        return out

    return _patch(Executor, "decode", altered)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "altered_token": altered_token}
