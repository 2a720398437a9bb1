"""Carry reference weights across: the JAX package's ``model.init`` parameter
tree (as numpy arrays, e.g. from ``jax.device_get``) → the port's
parameters, so both packages compute the same function.  The two trees have
the same names, nesting and layouts, so conversion is a leaf-wise copy; it
checks every leaf's shape against what the port would allocate for ``cfg``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import leaves_with_paths, tree_map


def params_from_jax(tree_of_numpy, cfg, *, device="cuda") -> dict:
    """Port parameters (float32/stored dtype preserved) from a reference
    parameter tree of numpy arrays, on ``device``."""
    dev = resolve_device(device)
    from repro_torch.models import build_model

    expect = build_model(cfg).init(0, device="meta")
    want = dict(leaves_with_paths(expect))
    got = leaves_with_paths(tree_of_numpy)
    if set(want) != {p for p, _ in got}:
        missing = sorted(map(str, set(want) - {p for p, _ in got}))
        extra = sorted(map(str, {p for p, _ in got} - set(want)))
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"unexpected {extra}")
    for path, arr in got:
        if tuple(np.shape(arr)) != tuple(want[path].shape):
            raise ValueError(f"leaf {path}: shape {np.shape(arr)} != "
                             f"{tuple(want[path].shape)}")
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev),
        tree_of_numpy)


__all__ = ["params_from_jax"]
