"""One-sided communication windows — the paper's MPI-RMA extensions on one card.

The reproduction of *Quo Vadis MPI RMA?* (Schuchart et al., EuroMPI'21):
MPI RMA windows with the paper's proposed extensions,

* ``WindowConfig.scope``    — P1: thread(=stream)-scope vs process-scope flushes;
* ``WindowConfig.order``    — P2: a-priori ordered operation sequences;
* accumulate declarations   — P3: ``same_op`` / ``assert_accumulate_intrinsic``
  and the intrinsic-vs-bandwidth crossover (``accumulate.py``);
* ``Window.dup_with_info``  — P4: window duplication.

A :class:`Window` is a thin view: the stacked buffer, completion counters,
flush queues and phase ledger live in :class:`~repro_torch.core.rma.
substrate.Substrate`, shared by a whole dup family, and the view owns its
:class:`WindowConfig` only — so a dup is zero-copy by construction.

Ranks: MPI processes are the rows of the stacked buffer (``(n, ...)``, row
r = rank r), MPI threads are numbered issue streams.  Payloads are stacked
the same way: row r is what rank r issues.  The phase cost of every
operation is the JAX package's (``substrate.py`` has the table).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import obs
from repro_torch.core.rma.substrate import (SCOPE_PROCESS, SCOPE_THREAD,
                                            CompletionToken, FlushQueues,
                                            Substrate)
from repro_torch.core.rma.topology import Topology

Perm = Sequence[tuple[int, int]]

#: Info keys an implementation may refuse to change on dup (paper §3);
#: ``max_streams`` sizes the substrate's per-stream state at allocate time.
_DUP_IMMUTABLE_KEYS = frozenset({"max_streams"})

#: Every op an accumulate may name.
KNOWN_ACC_OPS = frozenset(
    {"sum", "min", "max", "replace", "prod", "band", "bor", "bxor"}
)


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    """The window *info object* — anticipated-usage declarations (paper §2).

    ``scope``: ``"process"`` (MPI-faithful) or ``"thread"`` (a flush
    completes the calling stream only, P1).  ``order``: same-stream
    operations complete in issue order without intermediate flushes (P2).
    ``assert_accumulate_intrinsic``: the application asserts every
    accumulate is inside the hardware envelope (P3; violations raise).
    ``accumulate_ops``: the anticipated accumulate ops.  ``same_op``: every
    accumulate through this view uses this one op (must be declared in
    ``accumulate_ops``).  ``max_atomic_elems``: the declared atomic
    envelope (``None``: calibrated crossover or the hardware default).
    ``max_streams``: number of issue streams, fixed at allocation.
    ``topology``: optional host×device factorization; same-host traffic
    then rides the shared-memory tier and owes no flush epoch."""

    scope: str = SCOPE_PROCESS
    order: bool = False
    assert_accumulate_intrinsic: bool = False
    accumulate_ops: tuple[str, ...] = ("sum",)
    same_op: str | None = None
    max_atomic_elems: int | None = None
    max_streams: int = 1
    topology: "Topology | None" = None

    def __post_init__(self):
        if self.scope not in (SCOPE_PROCESS, SCOPE_THREAD):
            raise ValueError(f"invalid scope {self.scope!r}")
        if self.topology is not None and not isinstance(self.topology, Topology):
            raise ValueError(
                f"topology must be a Topology or None, got {self.topology!r}")
        if self.max_streams < 1:
            raise ValueError("max_streams must be >= 1")
        for op in self.accumulate_ops:
            if op not in KNOWN_ACC_OPS:
                raise ValueError(f"unknown accumulate op {op!r} in accumulate_ops")
        if self.same_op is not None:
            if self.same_op not in KNOWN_ACC_OPS:
                raise ValueError(f"unknown accumulate op same_op={self.same_op!r}")
            if self.same_op not in self.accumulate_ops:
                raise ValueError(
                    f"same_op={self.same_op!r} contradicts accumulate_ops="
                    f"{self.accumulate_ops!r}; declare it in both")
        if self.max_atomic_elems is not None and self.max_atomic_elems < 1:
            raise ValueError("max_atomic_elems must be >= 1")

    def replace(self, **kw) -> "WindowConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Window:
    """An allocated RMA window over a stacked rank axis (``MPI_Win_allocate``).

    Operations update the shared substrate in place and return this view,
    so ``win = win.put(...)`` and plain ``win.put(...)`` both work."""

    substrate: Substrate
    config: WindowConfig

    @property
    def buffer(self) -> torch.Tensor:
        return self.substrate.buffer

    @property
    def axis(self) -> str:
        return self.substrate.axis

    @property
    def axis_size(self) -> int:
        return self.substrate.axis_size

    @property
    def group(self) -> FlushQueues:
        """The dup family's shared flush-queue state."""
        return self.substrate.queues

    @property
    def ledger(self):
        """The dup family's phase ledger."""
        return self.substrate.ledger

    @property
    def device(self) -> torch.device:
        """Where the window's control state lives (:attr:`Substrate.device`)."""
        return self.substrate.device

    @classmethod
    def allocate(cls, buffer: torch.Tensor, axis: str, axis_size: int,
                 config: WindowConfig | None = None, *,
                 device=None) -> "Window":
        """``MPI_Win_allocate``: expose ``buffer``, the stacked ``(axis_size,
        ...)`` shards of every rank.  The window aliases it (no copy).
        ``device``: where its control state lives (default the buffer's;
        the card under a pinned host buffer, which only K3's puts and reads
        reach)."""
        if not buffer.is_contiguous():
            raise ValueError("a window exposes a contiguous stacked buffer")
        config = config or WindowConfig()
        with obs.span("rma.allocate"):
            return cls(Substrate.allocate(buffer, axis, axis_size,
                                          config.max_streams, device), config)

    def dup_with_info(self, **info) -> "Window":
        """``MPIX_Win_dup_with_info`` (paper §3): a new view over the same
        substrate with an independent config.  Immutable keys are silently
        retained, except that asking for more issue streams than the
        substrate was allocated with raises (it would index past it)."""
        if ("max_streams" in info
                and info["max_streams"] > self.substrate.n_streams):
            raise ValueError(
                f"dup_with_info(max_streams={info['max_streams']}) exceeds "
                f"the {self.substrate.n_streams} issue stream(s) this "
                "window's substrate was allocated with; max_streams sizes "
                "the per-stream state at allocate time and cannot grow on an "
                "aliased window — allocate the parent with enough streams")
        with obs.span("rma.dup"):
            accepted = {k: v for k, v in info.items()
                        if k not in _DUP_IMMUTABLE_KEYS}
            return dataclasses.replace(
                self, config=self.config.replace(**accepted))

    def completion_token(self, stream: int = 0) -> CompletionToken:
        """The stream's completion token: it stands for every operation
        issued on the stream and, after a flush, for their completion at
        the target.  The handle for *cross-window* ordering: pass it as
        ``put_signal(..., after=...)`` to sequence a doorbell on a control
        window behind this window's epoch.  Costs no launch, no host read
        and no phase (:class:`~repro_torch.core.rma.substrate.
        CompletionToken`)."""
        self._check_stream(stream)
        return self.substrate.token(stream)

    def _shm(self, perm: Perm) -> bool:
        t = self.config.topology
        return t is not None and t.perm_is_intra(perm)

    def _check_stream(self, stream: int) -> None:
        if not (0 <= stream < self.config.max_streams):
            raise ValueError(
                f"stream {stream} out of range for max_streams={self.config.max_streams}")
        if stream >= self.substrate.n_streams:
            raise ValueError(
                f"stream {stream} exceeds the {self.substrate.n_streams} "
                "issue stream(s) this window's substrate was allocated with "
                "(a view config cannot widen max_streams past the "
                "allocate-time state)")

    # -- one-sided operations ------------------------------------------------
    def put(self, data: torch.Tensor, perm: Perm, *, offset=0,
            stream: int = 0) -> "Window":
        """``MPI_Put``: origin s writes ``data[s]`` into target t's window at
        ``offset``, for every (s, t) in ``perm``.  One phase; remote
        completion after :meth:`flush` (or, under ``order=True``, by a later
        operation on the same stream)."""
        self._check_stream(stream)
        self.substrate.put(data, perm, offset=offset, stream=stream,
                           shm=self._shm(perm))
        return self

    def get(self, perm: Perm, *, offset=0, size: int, stream: int = 0
            ) -> tuple["Window", torch.Tensor]:
        """``MPI_Get``: origin s reads ``size`` rows at ``offset`` of target
        t's window.  One round trip (2 phases)."""
        self._check_stream(stream)
        _, data = self.substrate.get(perm, offset=offset, size=size,
                                     stream=stream, shm=self._shm(perm))
        return self, data

    def accumulate(self, data: torch.Tensor, perm: Perm, *, op: str = "sum",
                   offset=0, stream: int = 0) -> "Window":
        """``MPI_Accumulate``, routed on the declared usage by the engine
        (:mod:`repro_torch.core.rma.accumulate`): declared single-op usage
        at or below the crossover takes the intrinsic path (K2 atomics, 1
        phase), above it the tiled path (K1, 1 phase); undeclared usage the
        conservative software path (2 phases)."""
        from repro_torch.core.rma import accumulate as _engine

        self._check_stream(stream)
        return _engine.routed_accumulate(self, data, perm, op=op,
                                         offset=offset, stream=stream)

    def fetch_op(self, data: torch.Tensor, perm: Perm, *, op: str = "sum",
                 offset=0, stream: int = 0) -> tuple["Window", torch.Tensor]:
        """``MPI_Fetch_and_op``: atomic read-modify-write returning each
        origin the target's old value.  Always one round trip."""
        self._check_stream(stream)
        _, old = self.substrate.fetch_rmw(data, perm, op, offset=offset,
                                          stream=stream, shm=self._shm(perm))
        return self, old

    def compare_and_swap(self, compare: torch.Tensor, new: torch.Tensor,
                         perm: Perm, *, offset=0, stream: int = 0
                         ) -> tuple["Window", torch.Tensor]:
        """``MPI_Compare_and_swap`` on a single element; one round trip.
        ``compare``/``new`` are stacked per rank, ``(n,)``."""
        self._check_stream(stream)
        _, old = self.substrate.compare_swap(compare, new, perm,
                                             offset=offset, stream=stream,
                                             shm=self._shm(perm))
        return self, old

    def _accumulate_path(self, path: str, data, perm, *, op, offset, stream
                         ) -> "Window":
        self.substrate.rmw(data, perm, op, path=path, offset=offset,
                           stream=stream, shm=self._shm(perm))
        return self

    def get_info(self) -> WindowConfig:
        """``MPI_Win_get_info``: the configuration in effect."""
        return self.config

    # -- synchronization -----------------------------------------------------
    def flush(self, stream: int | None = None) -> "Window":
        """``MPI_Win_flush`` through the shared epoch engine: process scope
        completes every stream of the dup family (the serialized walk);
        thread scope (P1) only the named stream."""
        with obs.span("rma.flush"):
            self.substrate.flush(scope=self.config.scope, stream=stream)
        return self

    def flush_local(self, stream: int | None = None) -> "Window":
        """``MPI_Win_flush_local``: local completion only (origin buffers
        reusable; remote completion not implied) — no round trip."""
        self.substrate.flush_local(scope=self.config.scope, stream=stream)
        return self

    def fence(self) -> "Window":
        """Active-target ``MPI_Win_fence``: a collective barrier completing
        every stream (process scope whatever the window's scope key)."""
        self.substrate.fence()
        return self


__all__ = ["Window", "WindowConfig", "KNOWN_ACC_OPS", "SCOPE_PROCESS",
           "SCOPE_THREAD"]
