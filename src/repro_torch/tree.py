"""Parameter trees: nested dicts and lists of tensors, walked in the JAX
package's pytree order (dict keys sorted, lists in order), so a flattened
gradient vector lays its leaves out exactly as the reference's does."""
from __future__ import annotations

from typing import Any, Callable


def leaves_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_paths(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(leaves_with_paths(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree: Any, new_leaves: list) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` (in
    :func:`leaves` order)."""
    it = iter(new_leaves)
    paths = [p for p, _ in leaves_with_paths(tree)]
    by_path = dict(zip(paths, it))
    return _rebuild(tree, (), by_path)


def _rebuild(tree, prefix, by_path):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], prefix + (k,), by_path) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, prefix + (i,), by_path)
                          for i, v in enumerate(tree))
    return by_path[prefix]


__all__ = ["leaves_with_paths", "leaves", "tree_map", "unflatten"]
