"""Topology — the host×device factorization of the rank axis as a plan input.

On a real machine the n ranks of an axis are g hosts × l local devices, and
same-host peers can bypass the network through shared-memory windows.
:class:`Topology` names that factorization, host-major (rank r lives on host
r // l at local index r % l); ``Topology(n, 1)`` is the flat declaration.
A permute whose every (src, tgt) pair stays on one host is **intra**: plans
bill it to the shared-memory tier, and the substrate owes it no flush epoch.

On one card every rank is a row of one tensor, so the factorization changes
the schedule and its phase ledger, not where bytes physically move.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Iterable

__all__ = ["Topology", "default_topology", "topology_fingerprint",
           "topology_from_mesh", "classify_cp"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """``hosts × local`` factorization of one rank axis, host-major."""

    hosts: int
    local: int

    def __post_init__(self):
        if self.hosts < 1 or self.local < 1:
            raise ValueError(
                f"topology needs hosts >= 1 and local >= 1, got "
                f"{self.hosts}x{self.local}")

    @property
    def axis_size(self) -> int:
        return self.hosts * self.local

    @classmethod
    def flat(cls, n: int) -> "Topology":
        """The flat declaration: n hosts × 1 device — all peers remote."""
        return cls(hosts=n, local=1)

    def host_of(self, rank: int) -> int:
        return rank // self.local

    def local_of(self, rank: int) -> int:
        return rank % self.local

    def pair_is_intra(self, src: int, tgt: int) -> bool:
        return self.host_of(src) == self.host_of(tgt)

    def perm_is_intra(self, perm: Iterable[tuple[int, int]]) -> bool:
        """True iff every (src, tgt) pair of ``perm`` stays on one host."""
        return all(self.pair_is_intra(s, t) for s, t in perm)

    def intra_ring_perm(self, shift: int = 1) -> tuple[tuple[int, int], ...]:
        """Ring over the l local indices of each host (l disjoint same-host
        rings issued as one permute)."""
        g, l = self.hosts, self.local
        return tuple((h * l + j, h * l + (j + shift) % l)
                     for h in range(g) for j in range(l))

    def inter_ring_perm(self, shift: int = 1) -> tuple[tuple[int, int], ...]:
        """Ring over the g hosts, one lane per local index j: rank (h, j)
        sends to ((h+shift) % g, j)."""
        g, l = self.hosts, self.local
        return tuple((h * l + j, ((h + shift) % g) * l + j)
                     for h in range(g) for j in range(l))

    def fingerprint(self) -> tuple:
        """Hashable identity for compiled-plan cache keys."""
        return ("topo", self.hosts, self.local)

    def __repr__(self) -> str:
        return f"Topology({self.hosts}x{self.local})"


def topology_fingerprint(topo: "Topology | None") -> tuple | None:
    """Cache-key helper that tolerates the undeclared (flat) case."""
    return None if topo is None else topo.fingerprint()


def default_topology(axis_size: int, *, env: str | None = None
                     ) -> "Topology | None":
    """The ambient declaration for an axis of ``axis_size``:
    ``RMA_TOPOLOGY=GxL`` (or ``env``), ``None`` (flat) when nothing is
    declared.  A shape that does not factor ``axis_size`` raises."""
    spec = env if env is not None else os.environ.get("RMA_TOPOLOGY", "")
    spec = spec.strip().lower()
    if not spec:
        return None
    m = re.fullmatch(r"(\d+)x(\d+)", spec)
    if not m:
        raise ValueError(
            f"RMA_TOPOLOGY must look like '2x4' (hosts x local), got {spec!r}")
    topo = Topology(hosts=int(m.group(1)), local=int(m.group(2)))
    if topo.axis_size != axis_size:
        raise ValueError(
            f"RMA_TOPOLOGY={spec} declares {topo.axis_size} ranks but the "
            f"axis has {axis_size}")
    return topo


def topology_from_mesh(mesh, axis: str) -> "Topology | None":
    """Discover the host×device factorization of one mesh axis.

    Groups the axis's devices by ``process_index`` (a multi-host run has
    one process per host).  Returns a :class:`Topology` when the devices
    tile host-major into equal same-process groups (a multi-host mesh laid
    out host by host) and ``None`` when they don't (an interleaved layout gets the safe flat treatment, not a wrong
    one).  Single-process meshes fall back to :func:`default_topology`, so
    ``RMA_TOPOLOGY`` can pin a factorization.  ``mesh`` is
    ``repro_torch.sharding.Mesh`` (or anything with ``shape``,
    ``axis_names`` and a ``devices`` array).
    """
    if axis not in getattr(mesh, "shape", {}):
        return None
    devs = mesh.devices
    try:
        import numpy as np
        axes = list(mesh.axis_names)
        moved = np.moveaxis(devs, axes.index(axis), -1)
        lanes = moved.reshape(-1, devs.shape[axes.index(axis)])
    except Exception:
        return None
    n = lanes.shape[1]
    procs = [[getattr(d, "process_index", 0) for d in lane] for lane in lanes]
    if len({tuple(p) for p in procs}) != 1:
        return None  # different lanes see different layouts: stay flat
    seq = procs[0]
    if len(set(seq)) == 1:
        return default_topology(n)  # single process: env override or flat
    # host-major check: equal-size contiguous runs, one per process
    run_lens: list[int] = []
    last, count = None, 0
    seen: set = set()
    for p in seq:
        if p == last:
            count += 1
        else:
            if p in seen:
                return None  # process appears in two runs: interleaved
            seen.add(p)
            if last is not None:
                run_lens.append(count)
            last, count = p, 1
    run_lens.append(count)
    if len(set(run_lens)) != 1:
        return None
    return Topology(hosts=len(run_lens), local=run_lens[0])


_CP_PAIRS = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")
_PAIR = re.compile(r"\{(\d+),(\d+)\}")


def classify_cp(hlo_text: str, topo: "Topology | None"
                ) -> tuple[int, int]:
    """Split an HLO text's ``collective-permute(`` count into ``(inter,
    intra)`` under ``topo``.

    A permute is intra iff *every* ``{src,tgt}`` pair in its
    ``source_target_pairs`` stays on one host; with ``topo=None``
    everything counts as inter.  The total always equals
    ``hlo_text.count("collective-permute(")``.  A pure text function, the
    JAX package's, so both packages read the same HLO the same way.
    """
    inter = intra = 0
    for line in hlo_text.splitlines():
        if "collective-permute(" not in line:
            continue
        m = _CP_PAIRS.search(line)
        pairs = [(int(a), int(b)) for a, b in _PAIR.findall(m.group(1))] \
            if m else []
        if topo is not None and pairs and topo.perm_is_intra(pairs):
            intra += 1
        else:
            inter += 1
    return inter, intra
