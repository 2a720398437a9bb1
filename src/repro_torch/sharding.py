"""Logical-axis sharding: the single place where names meet the mesh.

Model code annotates tensors with *logical* axis names ("batch", "embed",
"heads", "expert", ...).  The launch layer activates a :class:`ShardingRules`
context mapping logical names to mesh axes; inside it,
``logical_constraint`` checks an annotation against the tensor's rank and
``spec_to_sharding`` turns a parameter-spec tree into :class:`NamedSharding`s.
Outside any context everything is a no-op, so model code never needs a mesh
to run.

The mesh is the port's own shape-only :class:`Mesh`: axis names, sizes and
an array of placeholder devices that carry a ``process_index``.  It places
nothing: one card holds every tensor whole, so ``logical_constraint``
returns its input unchanged, and a :class:`NamedSharding` only answers what
one device's shard of a global shape is (``shard_shape``, the JAX
package's rule: a dim must divide by the product of its mesh axes, else
``ValueError``).  The dry-run (``repro_torch.launch.dryrun``) reads the
shards of every argument from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Mapping, Sequence

import numpy as np

_state = threading.local()


#: Default logical→mesh mapping for the production mesh ("data", "model").
#: A logical name may map to a tuple of mesh axes (sharded over both).
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),       # data parallel over pods × data axis
    "fsdp": ("pod", "data"),        # parameter sharding axis for FSDP/ZeRO-3
    "embed": None,                  # activations' feature dim: replicated
    "heads": "model",               # tensor parallel: attention heads
    "kv_heads": "model",            # tensor parallel: KV heads
    "mlp": "model",                 # tensor parallel: FFN hidden
    "vocab": "model",               # tensor parallel: output vocab
    "expert": "model",              # expert parallel
    "seq": None,                    # sequence dim of activations
    "kv_seq": None,                 # sequence dim of KV caches
    "q_lora": None,
    "kv_lora": None,
    "ssm_state": None,
    "conv": None,
}


@dataclasses.dataclass(frozen=True)
class PlaceholderDevice:
    """A mesh position: an id and the process (host) that would own it."""
    id: int
    process_index: int = 0


class Mesh:
    """A shape-only device mesh: ``devices`` (an object array of
    :class:`PlaceholderDevice`, one axis per name) and ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a "
                             f"{devices.ndim}-d device array")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(f"{a}={n}" for a, n in
                                   self.shape.items()) + ")"


class P(tuple):
    """A partition spec: one entry per dim — ``None`` (replicated), a mesh
    axis name, or a tuple of them."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec over it."""
    mesh: Mesh
    spec: P

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """One device's shard of ``global_shape``; a dim that its mesh axes
        do not divide raises ``ValueError`` (no padding)."""
        if len(self.spec) > len(global_shape):
            raise ValueError(f"partition spec {self.spec} has more entries "
                             f"than the rank-{len(global_shape)} shape")
        sizes = self.mesh.shape
        out = []
        for i, dim in enumerate(global_shape):
            part = self.spec[i] if i < len(self.spec) else None
            axes = () if part is None else (
                (part,) if isinstance(part, str) else tuple(part))
            ways = math.prod(sizes[a] for a in axes)
            if dim % ways:
                raise ValueError(
                    f"one of the dimensions of shape {tuple(global_shape)} "
                    f"(dim {i} = {dim}) is not divisible by the mesh axes "
                    f"{axes} of size {ways} it is sharded over "
                    f"(spec {self.spec})")
            out.append(dim // ways)
        return tuple(out)


class ShardingRules:
    """An activated mapping from logical axis names to mesh axes."""

    def __init__(self, mesh: Mesh, rules: Mapping[str, object]):
        self.mesh = mesh
        # drop mappings onto axes the mesh does not have (e.g. "pod" on the
        # single-pod mesh)
        axes = set(mesh.axis_names)

        def _filter(v):
            if v is None:
                return None
            if isinstance(v, str):
                return v if v in axes else None
            vv = tuple(a for a in v if a in axes)
            return vv if vv else None

        self.rules = {k: _filter(v) for k, v in dict(rules).items()}

    def partition_spec(self, names: Sequence[str | None]) -> P:
        """The partition spec of ``names``; a mesh axis used by an earlier
        dim of the same spec is dropped."""
        used: set[str] = set()
        parts = []
        for n in names:
            v = None if n is None else self.rules.get(n)
            if v is None:
                parts.append(None)
                continue
            axes = (v,) if isinstance(v, str) else tuple(v)
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            if not axes:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(axes)
        return P(*parts)

    def sharding(self, names: Sequence[str | None]) -> NamedSharding:
        return NamedSharding(self.mesh, self.partition_spec(names))


def current_rules() -> ShardingRules | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(mesh: Mesh, rules: Mapping[str, object] | None = None):
    """Activate a logical→mesh mapping for the enclosed region."""
    prev = getattr(_state, "rules", None)
    _state.rules = ShardingRules(mesh, rules if rules is not None
                                 else DEFAULT_RULES)
    try:
        yield _state.rules
    finally:
        _state.rules = prev


def logical_constraint(x, *names: str | None):
    """The JAX package's sharding constraint by logical names: under active
    rules a name count other than ``x``'s rank raises; ``x`` is returned
    unchanged (one card holds it whole)."""
    if current_rules() is not None and len(names) != x.ndim:
        raise ValueError(f"{len(names)} names for rank-{x.ndim} array")
    return x


def _is_spec(x) -> bool:
    return x is None or isinstance(x, tuple)


def map_specs(fn: Callable, spec_tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a spec tree (a tuple of names or
    ``None``), keeping its dicts and lists."""
    if _is_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [map_specs(fn, v) for v in spec_tree]
    raise TypeError(f"not a spec tree leaf or node: {spec_tree!r}")


def spec_to_sharding(spec_tree, rules: ShardingRules):
    """Map a tree of logical-name tuples to a tree of NamedShardings."""
    return map_specs(lambda names: rules.sharding(names or ()), spec_tree)


def spec_to_pspec(spec_tree, rules: ShardingRules):
    return map_specs(lambda names: rules.partition_spec(names or ()),
                     spec_tree)


__all__ = [
    "DEFAULT_RULES",
    "PlaceholderDevice",
    "Mesh",
    "P",
    "NamedSharding",
    "ShardingRules",
    "use_rules",
    "current_rules",
    "logical_constraint",
    "map_specs",
    "spec_to_sharding",
    "spec_to_pspec",
]
