"""Parameters from a seed, made on the device in one large draw.

The benchmark makes the weights itself and hands the same tensors to the
program and to the reference.  A layout (a tree of dicts and lists whose
leaves carry ``shape``, e.g. the program's parameter tree built on the
``meta`` device) fixes the leaves; every leaf is a view of one float32
buffer filled by a single ``normal_`` call from a ``torch.Generator`` on
the device, then shaped in place by its name:

* matrices: scaled by 1/sqrt(fan-in), the input width of the product;
* norm scales 1 + 0.1 n, biases 0.05 n, Mamba2's ``D`` 1 + 0.1 n and
  ``dt_bias`` 0.1 n;
* Mamba2's ``A_log`` log(linspace(1, 16, heads)) on every layer;
* the embedding table n (unit rows, as a pre-norm stack expects).

Leaves stacked on a leading layer axis (under ``scan``) draw a different
row for every layer.  A leaf whose name is not known raises, so a new
architecture states how it is drawn.
"""
from __future__ import annotations

import math

import torch

#: derived seeds: one stream per purpose
WEIGHTS, BATCHES = 0, 1


def device_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of run seed ``seed``."""
    return (int(seed) * 1_000_003 + 7919 * stream + 1) % (2**63 - 1)


def walk(tree, prefix=()):
    """``(path, leaf)`` pairs, dict keys sorted and lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, prefix + (i,))
    else:
        yield prefix, tree


def rebuild(tree, by_path, prefix=()):
    if isinstance(tree, dict):
        return {k: rebuild(v, by_path, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, by_path, prefix + (i,))
                          for i, v in enumerate(tree))
    return by_path[prefix]


_BIASES = {"bias", "bq", "bk", "bv", "bo", "bi", "conv_b"}


def _fan_in(path, shape) -> int:
    name, parent = path[-1], (path[-2] if len(path) > 1 else None)
    if name == "conv_w":
        return shape[1]
    if parent == "moe" and name in ("wi", "wo"):
        return shape[1]                     # (experts, in, out)
    if name == "wo" and parent in ("attn", "cross"):
        return shape[0] * shape[1]          # (heads, head_dim, d)
    if name in ("wq", "wk", "wv", "wi", "wo", "in_proj", "out_proj",
                "kernel", "router"):
        return shape[0]
    raise KeyError(f"no rule draws leaf {'/'.join(map(str, path))} "
                   f"{tuple(shape)}")


def _shape_leaf(path, t: torch.Tensor) -> None:
    """Turn the standard normals in ``t`` into the leaf's values, in place."""
    stacked = "scan" in path
    shape = tuple(t.shape[1:] if stacked else t.shape)
    name = path[-1]
    if name == "scale" or name == "D":
        t.mul_(0.1).add_(1.0)
    elif name in _BIASES:
        t.mul_(0.05)
    elif name == "dt_bias":
        t.mul_(0.1)
    elif name == "A_log":
        heads = shape[0]
        t.copy_(torch.log(torch.linspace(1.0, 16.0, heads, device=t.device,
                                         dtype=torch.float32)).expand_as(t))
    elif name == "table":
        pass
    else:
        t.mul_(1.0 / math.sqrt(_fan_in(path, shape)))


def make_params(layout, seed: int, device) -> dict:
    """The parameter tree of ``layout``'s structure and shapes, float32, on
    ``device``, from ``seed``."""
    pairs = list(walk(layout))
    total = sum(math.prod(leaf.shape) for _, leaf in pairs)
    gen = torch.Generator(device=device)
    gen.manual_seed(device_seed(seed, WEIGHTS))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    by_path, off = {}, 0
    for path, leaf in pairs:
        n = math.prod(leaf.shape)
        view = flat[off:off + n].view(tuple(leaf.shape))
        _shape_leaf(path, view)
        by_path[path] = view
        off += n
    return rebuild(layout, by_path)


def count(layout) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in walk(layout))
