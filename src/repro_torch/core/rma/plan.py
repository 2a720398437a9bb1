"""Declarative RMA plans — build-once, execute-many communication schedules.

Applications declare a whole communication pattern instead of one hint at a
time (the paper's thesis lifted from windows to patterns):

1. **Record** the pattern on an :class:`RmaPlan` against declared plan
   windows — ``put``/``get``/``send``/``hop``/``accumulate``/``signal``/
   ``compute`` and the ``ring_all_reduce`` macro — with explicit ordering
   edges.  Ops name bindings or earlier results; nothing moves.
2. **Compile** runs the planner passes of the JAX package, unchanged:
   declaration validation (``PlanError`` at build time), stream
   auto-assignment, flush-epoch coalescing, same-peer put fusion,
   compile-time accumulate routing, and the hierarchical ring rewrite under
   a declared topology.  The compiled plan predicts its phases
   (:attr:`CompiledPlan.phases`, per tier, :meth:`CompiledPlan.phase_table`).
3. **Execute** replays the schedule eagerly on live windows whose substrate
   bills the same phases to its ledger.  A declared flat ring macro
   (``order=True``, ``same_op="sum"``, float32) runs as one launch of kernel
   K5, billed the phases of the op range it replaces.  A payload followed
   by its chained doorbell on an ordered window — a ``put``/``send`` and
   its ``signal`` (kernel K4), or a sum ``accumulate``/``hop`` and its
   ``signal`` (kernel K6) — runs as one launch billed as the two ops;
   everything else runs op by op on the substrate's kernels.  The chosen
   lowering of every macro and every such pair is in
   :attr:`CompiledPlan.lowering`.

P5 handle ops (``put_handle``/``get_handle``) replay through
:func:`~repro_torch.core.rma.memhandle.win_from_memhandle` on a dynamic
window, and :attr:`PlanResult.err_count` sums their stale-handle counts.
A prefetch edge (:meth:`RmaPlan.prefetch`) issues a transport op early on
the window's last declared stream and places its completion epoch, the
``prefetch-wait``, right before its consumer; on the card that stream is a
column of the completion counters, and the wait one K3 wait on it (all
launches still share one CUDA stream).

``compile(backend=)`` picks the lowering target per recorded macro
(:mod:`repro_torch.core.rma.backends`): ``"rma"`` keeps everything on the
substrate; ``"gspmd"`` collapses every lowerable macro into one step that
computes its collective (a library operation on the stacked layout, billed
0 phases); ``"auto"`` decides per macro from the latency table measured on
the card; ``"interpret"`` tags the schedule for
:meth:`CompiledPlan.interpret`, a walk on stacked tensors.  K5 and the
K4/K6 pairs lower only ranges that stayed on the substrate.

Values in a plan are stacked: a binding or an op result is ``(n, ...)``,
row r = rank r, and recorded closures see the rank vector as ``env.ranks``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Sequence

import torch

from repro_torch import obs
from repro_torch.core.rma import accumulate as acc_engine
from repro_torch.core.rma.substrate import SCOPE_THREAD, _is_static
from repro_torch.core.rma.topology import Topology
from repro_torch.core.rma.window import KNOWN_ACC_OPS, WindowConfig
from repro_torch.kernels.common import as_dtype

Perm = Sequence[tuple[int, int]]


class PlanError(ValueError):
    """A build-time declaration violation in an :class:`RmaPlan`."""


@dataclasses.dataclass(frozen=True)
class OpRef:
    """Handle to a recorded plan op: a data source for later ops, an
    ``after=`` ordering edge, or a plan output."""

    idx: int
    label: str = ""


@dataclasses.dataclass
class _Op:
    idx: int
    kind: str                      # comm kind, or "compute"
    window: str | None = None
    perm: tuple | None = None
    source: Any = None             # binding name | OpRef | callable(env)
    cur: Any = None                # hop: local accumulator input
    offset: Any = 0
    size: int | None = None        # get
    op: str | None = None          # accumulate-class op name
    stream: int | None = None      # pinned issue stream (None = planner picks)
    after: tuple = ()              # completion edges (OpRefs)
    reads: tuple = ()              # value edges a closure consumes (OpRefs)
    shape: tuple | None = None     # declared payload spec (for routing)
    dtype: Any = None
    fuse: bool = False             # put: may join a gather-write group
    slot: int | None = None        # put/get_handle: static registration slot
    handle: Any = None             # put/get_handle: handle source
    value: Any = None              # signal: flag payload override
    fn: Callable | None = None     # compute
    prefetch: bool = False         # planned early issue (plan.prefetch edge)
    label: str = ""
    # -- filled by the compiler --
    deps: frozenset = frozenset()
    sync_deps: frozenset = frozenset()
    comm_deps: frozenset = frozenset()
    comm_sync: frozenset = frozenset()
    path: str | None = None
    tier: str = "inter"


@dataclasses.dataclass
class _PlanWindow:
    """A plan-level window declaration — the pattern-wide info object."""

    name: str
    scope: str = SCOPE_THREAD
    order: bool = True
    accumulate_ops: tuple = ("sum",)
    same_op: str | None = None
    assert_accumulate_intrinsic: bool = False
    max_atomic_elems: int | None = None
    max_streams: int = 1
    dtype: Any = torch.float32
    entry_epoch: bool = False      # flush caller in-flight ops on entry
    exit_epoch: bool = False       # complete the pattern's ops on exit

    def config(self) -> WindowConfig:
        return WindowConfig(
            scope=self.scope, order=self.order,
            accumulate_ops=self.accumulate_ops, same_op=self.same_op,
            assert_accumulate_intrinsic=self.assert_accumulate_intrinsic,
            max_atomic_elems=self.max_atomic_elems,
            max_streams=self.max_streams)


@dataclasses.dataclass
class _Step:
    """One entry of the compiled schedule."""

    kind: str            # "op" | "flush" | "entry" | "fused" | "gspmd"
    window: str | None = None
    stream: int | None = None
    op: _Op | None = None
    group: tuple = ()
    phases: int = 0
    tier: str = "inter"
    macro: "_Macro | None" = None  # gspmd: the macro this step computes
    pwait: bool = False  # flush placed by a prefetch edge (the late wait
                         # right before the consumer)


@dataclasses.dataclass(frozen=True)
class _Macro:
    """A bracketed op range recorded by a collective macro
    (:meth:`RmaPlan.ring_all_reduce` / :meth:`RmaPlan.all_to_all`) — the
    unit of backend selection.  Ops ``[lo, hi)`` realize the pattern on the
    substrate; a backend that recognizes it (or kernel K5, for a declared
    flat ring) may take the whole range over and produce ``results``."""

    kind: str                      # "ring" | "a2a"
    lo: int                        # first recorded op idx (inclusive)
    hi: int                        # one past the last recorded op idx
    axis: str
    n: int
    shape: tuple                   # one rank's payload shape
    dtype: Any
    op: str | None
    source: Any
    counts: Any = None             # a2a: counts binding/OpRef
    chunks: int = 1
    hier: bool = False             # the hierarchical rewrite was recorded
    windows: tuple = ()
    results: tuple = ()            # OpRefs downstream consumers may use
    label: str = ""


class PlanEnv:
    """The execute-time environment a plan's closures see: ``env[ref]``
    reads an earlier result or a binding, :meth:`buffer` a window's stacked
    buffer, ``env.ranks`` the rank vector ``arange(n)``."""

    def __init__(self, bindings: dict, views: dict, n: int, device):
        self.bindings = bindings
        self.values: dict[int, torch.Tensor] = {}
        self._views = views
        self.n = n
        self.ranks = torch.arange(n, device=device)

    def __getitem__(self, key):
        if isinstance(key, OpRef):
            return self.values[key.idx]
        return self.bindings[key]

    def buffer(self, window: str) -> torch.Tensor:
        return self._views[window].buffer


@dataclasses.dataclass
class PlanResult:
    """One replay's updated window views (caller configs restored), its
    declared outputs, and the stale-handle drops its P5 handle ops counted,
    per rank (``(n,)`` int32 on the windows' device)."""

    windows: dict[str, Any]
    outputs: dict[str, torch.Tensor]
    err_count: torch.Tensor


class RmaPlan:
    """Records a communication pattern once, then :meth:`compile`."""

    def __init__(self, name: str = "rma-plan",
                 topology: Topology | None = None):
        if topology is not None and not isinstance(topology, Topology):
            raise PlanError(
                f"topology must be a Topology or None, got {topology!r}")
        self.name = name
        self.topology = topology
        self._windows: dict[str, _PlanWindow] = {}
        self._bindings: dict[str, tuple[tuple, torch.dtype]] = {}
        self._ops: list[_Op] = []
        self._edges: list[tuple[int, int]] = []
        self._outputs: list[tuple[str, Any]] = []
        self._macros: list[_Macro] = []
        self._prefetch: list[tuple[int, int]] = []  # prefetch(op, before)

    # -- declarations ---------------------------------------------------------
    def window(self, name: str, **decl) -> str:
        """Declare a plan window: the ``WindowConfig`` info keys plus
        ``dtype`` and ``entry_epoch``/``exit_epoch`` (lent windows want
        both)."""
        if name in self._windows:
            raise PlanError(f"window {name!r} declared twice")
        if "dtype" in decl:
            decl["dtype"] = as_dtype(decl["dtype"])
        self._windows[name] = w = _PlanWindow(name=name, **decl)
        w.config()  # surface invalid info-key combinations at declaration
        return name

    def bind(self, name: str, shape: Sequence[int], dtype) -> str:
        """Declare a typed input placeholder (one rank's shape), filled with
        a stacked ``(n, *shape)`` tensor at execute time."""
        if name in self._bindings:
            raise PlanError(f"binding {name!r} declared twice")
        self._bindings[name] = (tuple(shape), as_dtype(dtype))
        return name

    # -- recording ------------------------------------------------------------
    def _record(self, **kw) -> OpRef:
        op = _Op(idx=len(self._ops), **kw)
        if op.kind != "compute":
            if op.window not in self._windows:
                raise PlanError(
                    f"op {op.kind!r} names undeclared window {op.window!r}")
            op.perm = tuple(tuple(p) for p in op.perm)
        for ref in (*op.after, *op.reads):
            if not isinstance(ref, OpRef) or ref.idx >= op.idx:
                raise PlanError(
                    "after=/reads= take OpRefs of already-recorded ops")
        self._ops.append(op)
        return OpRef(op.idx, op.label or f"{op.kind}#{op.idx}")

    def put(self, window: str, source, perm, *, offset=0, stream=None,
            after=(), fuse: bool = False, shape=None, dtype=None,
            label: str = "") -> OpRef:
        """Record a write; ``fuse=True`` marks it joinable into a same-peer
        gather-write phase."""
        return self._record(kind="put", window=window, source=source,
                            perm=perm, offset=offset, stream=stream,
                            after=tuple(after), fuse=fuse, shape=shape,
                            dtype=dtype, label=label)

    def get(self, window: str, perm, *, offset=0, size: int, stream=None,
            after=(), label: str = "") -> OpRef:
        """Record a read; the result is this op's value."""
        return self._record(kind="get", window=window, perm=perm,
                            offset=offset, size=size, stream=stream,
                            after=tuple(after), label=label)

    def send(self, window: str, source, perm, *, stream=None, after=(),
             shape=None, dtype=None, label: str = "") -> OpRef:
        """Record a raw one-phase channel transfer (the ring hop
        primitive); the value is what each rank receives."""
        return self._record(kind="send", window=window, source=source,
                            perm=perm, stream=stream, after=tuple(after),
                            shape=shape, dtype=dtype, label=label)

    def hop(self, window: str, source, cur, perm, *, op: str = "sum",
            stream=None, after=(), shape=None, dtype=None,
            label: str = "") -> OpRef:
        """Record one reduce-ring hop: send ``source`` along ``perm`` and
        combine the received piece into ``cur`` (routed: a declared same-op
        window is one phase, an undeclared one pays the per-hop ack)."""
        return self._record(kind="hop", window=window, source=source, cur=cur,
                            perm=perm, op=op, stream=stream,
                            after=tuple(after), shape=shape, dtype=dtype,
                            label=label)

    def accumulate(self, window: str, source, perm, *, op: str = "sum",
                   offset=0, stream=None, after=(), shape=None, dtype=None,
                   label: str = "") -> OpRef:
        """Record an ``MPI_Accumulate``; its path is routed at compile."""
        return self._record(kind="accumulate", window=window, source=source,
                            perm=perm, op=op, offset=offset, stream=stream,
                            after=tuple(after), shape=shape, dtype=dtype,
                            label=label)

    def fetch_op(self, window: str, source, perm, *, op: str = "sum",
                 offset=0, stream=None, after=(), shape=None, dtype=None,
                 label: str = "") -> OpRef:
        """Record an atomic fetch-and-op; the value is the fetched old word."""
        return self._record(kind="fetch_op", window=window, source=source,
                            perm=perm, op=op, offset=offset, stream=stream,
                            after=tuple(after), shape=shape, dtype=dtype,
                            label=label)

    def signal(self, window: str, perm, *, flag_offset, value=None,
               stream=None, after=(), label: str = "") -> OpRef:
        """Record a notification flag: an accumulate of the window's
        declared op at ``flag_offset``, ordered behind ``after``."""
        return self._record(kind="signal", window=window, perm=perm,
                            offset=flag_offset, value=value, stream=stream,
                            after=tuple(after), label=label)

    def compute(self, fn: Callable[[PlanEnv], torch.Tensor], *, reads=(),
                after=(), shape=None, dtype=None, label: str = "") -> OpRef:
        """Record a local (zero-phase) transform; ``fn(env)`` returns the
        stacked result.  ``reads`` are value edges, ``after`` completion
        edges."""
        return self._record(kind="compute", fn=fn, reads=tuple(reads),
                            after=tuple(after), shape=shape, dtype=dtype,
                            label=label)


    def put_handle(self, window: str, source, handle, perm, *, slot=None,
                   offset=0, stream=None, after=(), shape=None, dtype=None,
                   label: str = "") -> OpRef:
        """Record a P5 memory-handle put: the payload and the handle's
        ``[addr, epoch]`` header ride one packet (2 phases); stale handles
        are dropped and counted into :attr:`PlanResult.err_count`.  ``slot``
        (static) arms the call-time use-after-release check.  The window
        must be a dynamic window at execute time."""
        return self._record(kind="put_handle", window=window, source=source,
                            handle=handle, perm=perm, slot=slot,
                            offset=offset, stream=stream, after=tuple(after),
                            shape=shape, dtype=dtype, label=label)

    def get_handle(self, window: str, handle, perm, *, slot=None, offset=0,
                   size: int, stream=None, after=(), label: str = "") -> OpRef:
        """Record a P5 memory-handle read: request + response (2 phases),
        no registration query.  A stale handle's response is zeros, counted
        into :attr:`PlanResult.err_count`; the fetched rows are this op's
        value."""
        return self._record(kind="get_handle", window=window, handle=handle,
                            perm=perm, slot=slot, offset=offset, size=size,
                            stream=stream, after=tuple(after), label=label)

    def prefetch(self, op: OpRef, before: OpRef) -> None:
        """Declare ``op`` (a transport op, typically a :meth:`get_handle`)
        a planned **prefetch** for ``before``: it issues as early as the
        schedule allows on the stream the planner dedicates to prefetch
        traffic (the window's last declared one), and its completion epoch
        lands *late*, immediately before ``before``'s step, instead of at
        the next ordinary flush point, so everything scheduled in between
        overlaps it.  The phase table shows the op as ``prefetch:<label>``
        and the epoch as ``prefetch-wait[window/stream]``.  A plan with no
        prefetch edge compiles exactly as before."""
        self._edges.append((op.idx, before.idx))
        self._prefetch.append((op.idx, before.idx))

    def all_to_all(self, data_window: str, hdr_window: str, source, counts,
                   axis: str, n: int, *, shape, dtype, op: str | None = None,
                   chunks: int = 1) -> tuple[OpRef, OpRef, OpRef]:
        """Record a whole declared all-to-all (``shape[0] == n*m`` rows of
        one rank, the k-th ``m``-row block addressed to rank k) with its
        count headers and doorbells.  Returns ``(out, counts, bells)``
        OpRefs — the exchanged data, per-source received row counts, and
        per-source arrival flags.  Under a declared ``g×l`` topology with
        ``g > 1 and l > 1`` (and ``chunks == 1``, ``op in (None, "sum")``)
        the exchange is the hierarchical two-stage relay; otherwise the
        flat per-peer exchange.  The recorded range is bracketed as a
        macro for backend selection at :meth:`compile`."""
        from repro_torch.core.rma import alltoall as _a2a

        lo = len(self._ops)
        hier = _a2a.hier_applies(self.topology, n, chunks=chunks, op=op)
        out, cnts, bells = _a2a.lower_all_to_all(
            self, data_window, hdr_window, source, counts, axis, n,
            shape=tuple(shape), dtype=dtype, op=op, chunks=chunks)
        self._macros.append(_Macro(
            kind="a2a", lo=lo, hi=len(self._ops), axis=axis, n=n,
            shape=tuple(shape), dtype=as_dtype(dtype), op=op, source=source,
            counts=counts, chunks=chunks, hier=hier,
            windows=(data_window, hdr_window), results=(out, cnts, bells),
            label=f"a2a[{data_window}]"))
        return out, cnts, bells

    def ring_all_reduce(self, window: str, source, axis: str, n: int, *,
                        shape, dtype, op: str = "sum", stream: int = 0,
                        label: str = "") -> OpRef:
        """Record a whole declared ring all-reduce of ``source`` (one rank's
        ``shape``, ``shape[0] % n == 0``) on plan window ``window``.  Under a
        declared ``g×l`` topology with ``g > 1 and l > 1`` the ring is
        rewritten hierarchically (2(g−1) inter-node phases instead of
        2(n−1)); otherwise the flat ring is recorded.  Returns the OpRef of
        the reduced result.  The recorded range is bracketed as a macro:
        a backend may take it over at :meth:`compile`, and kernel K5 a
        declared flat ring that stays on the substrate."""
        from repro_torch.core.rma import collectives as _coll

        lo = len(self._ops)
        out, hier = _coll.lower_ring_all_reduce(
            self, window, source, axis, n, shape=tuple(shape), dtype=dtype,
            op=op, stream=stream)
        self._macros.append(_Macro(
            kind="ring", lo=lo, hi=len(self._ops), axis=axis, n=n,
            shape=tuple(shape), dtype=as_dtype(dtype), op=op, source=source,
            hier=hier, windows=(window,), results=(out,),
            label=label or f"ring[{window}]"))
        return out

    def order(self, first: OpRef, then: OpRef) -> None:
        """Add a completion edge after the fact (a cycle is rejected at
        compile)."""
        self._edges.append((first.idx, then.idx))

    def output(self, name: str, value) -> None:
        """Mark ``value`` (an OpRef or ``callable(env)``) as a named output."""
        self._outputs.append((name, value))

    # -- compile: the planner passes -----------------------------------------
    def _refs_in(self, *specs):
        for s in specs:
            if isinstance(s, OpRef):
                yield s.idx

    def _spec_of(self, op: _Op):
        """Resolve an op's payload (shape, dtype) for routing/validation."""
        if op.shape is not None and op.dtype is not None:
            return tuple(op.shape), as_dtype(op.dtype)
        src = op.source
        if isinstance(src, str):
            if src not in self._bindings:
                raise PlanError(f"op {op.idx} reads undeclared binding {src!r}")
            return self._bindings[src]
        if isinstance(src, OpRef):
            prev = self._ops[src.idx]
            if prev.kind in ("send", "hop", "compute", "fetch_op"):
                try:
                    return self._spec_of(prev)
                except PlanError:
                    return None
        return None

    def _k5_lowering(self, mac: _Macro, naive_flush: bool) -> tuple[str, str]:
        """Whether kernel K5 may take a ring macro's whole range over."""
        w = self._windows[mac.windows[0]]
        if naive_flush:
            return "rma", "naive_flush measures per-op epochs"
        if mac.hier:
            return "rma", "hierarchical rewrite runs op by op"
        if not w.order:
            return "rma", "order=False: the flush-separated baseline"
        if w.same_op != "sum" or mac.op != "sum":
            return "rma", "undeclared ring: per-hop completion acks"
        if mac.dtype != torch.float32:
            return "rma", f"K5 reduces float32, not {mac.dtype}"
        return "k5", "declared flat sum ring"

    def _signal_lowering(self, ops, steps, fused_of, in_kernel, naive_flush,
                         collective=frozenset()):
        """Pair every ``signal`` with the payload op it chains behind (an
        ``after`` edge to a put/send/hop/accumulate on the same perm and
        stream) and decide whether one kernel launch carries both: K4 for
        a put or send, K6 for a sum accumulate or hop.  Ops a backend
        collective took over (``collective``) pair with nothing.  Returns
        ``[(data idx, signal idx, kernel, hoisted value idx, reason)]``."""
        pos = {s.op.idx: k for k, s in enumerate(steps) if s.kind == "op"}
        pairs, used = [], set()
        for sig in ops:
            if sig.kind != "signal" or sig.idx in collective:
                continue
            cand = [ops[r.idx] for r in sig.after
                    if r.idx not in collective
                    and ops[r.idx].kind in ("put", "send", "hop", "accumulate")
                    and ops[r.idx].perm == sig.perm
                    and ops[r.idx].stream == sig.stream]
            if not cand:
                continue
            d = cand[-1]
            kernel = "k4" if d.kind in ("put", "send") else "k6"
            hoist, why = None, None
            if naive_flush:
                why = "naive_flush measures per-op epochs"
            elif not self._windows[d.window].order:
                why = "order=False: a flush separates payload and flag"
            elif acc_engine.PATH_SOFTWARE in (d.path, sig.path):
                why = "undeclared: completion acks"
            elif kernel == "k6" and d.op != "sum":
                why = f"K6 lowers sum, not {d.op}"
            elif d.idx in fused_of:
                why = "the payload joins a gather-write"
            elif d.idx in in_kernel:
                why = "the payload is part of a K5 ring"
            elif d.idx in used:
                why = "the payload already carries a flag"
            elif len({t for _, t in d.perm}) != len(d.perm):
                why = "two origins reach one target"
            elif not _is_static(sig.offset):
                why = "a flag displacement computed at replay"
            elif any(steps[k].kind != "op" or steps[k].op.kind != "compute"
                     for k in range(pos[d.idx] + 1, pos[sig.idx])):
                why = "other operations between payload and flag"
            elif isinstance(sig.value, OpRef) and sig.value.idx > d.idx:
                v = ops[sig.value.idx]
                if v.kind != "compute" or any(x > d.idx for x in v.deps):
                    why = "the flag value depends on the payload"
                else:
                    hoist = v.idx
            if why is None:
                used.add(d.idx)
                why = ("payload then chained flag in one launch"
                       if kernel == "k4" else
                       "sum fold then chained flag in one launch")
            else:
                kernel = "rma"
            pairs.append((d.idx, sig.idx, kernel, hoist, why))
        return pairs

    def compile(self, *, naive_flush: bool = False,
                backend: str = "rma") -> "CompiledPlan":
        """Run the planner passes and freeze the schedule.
        ``naive_flush=True`` builds the conservative baseline (an epoch
        after every transport op).

        ``backend`` selects the lowering target per recorded macro:

        * ``"rma"`` (default) — everything on the substrate;
        * ``"gspmd"`` — every lowerable macro collapses into one step
          computing its collective, billed 0 phases; a macro that cannot
          stays on the substrate with the reason in :attr:`CompiledPlan.
          lowering`;
        * ``"auto"`` — per macro, the faster of the two in the latency
          table measured on the card (:mod:`~repro_torch.core.rma.backends.
          costmodel`); a missing or bad table falls back to ``rma`` with
          one warning, never an error;
        * ``"interpret"`` — the substrate schedule, tagged for
          :meth:`CompiledPlan.interpret`.

        Selection is skipped under ``naive_flush`` (the baseline measures
        the substrate's per-op epochs, which a collective would erase)."""
        if backend not in ("rma", "gspmd", "interpret", "auto"):
            raise PlanError(
                f"unknown backend {backend!r}; expected one of 'auto', "
                "'rma', 'gspmd', 'interpret'")
        ops = [dataclasses.replace(o) for o in self._ops]

        # prefetch edges: tag the early-issued ops and index the late waits
        # by consumer (pass 3 dedicates a stream, pass 6 places each wait
        # right before its consumer's step)
        pf_by_consumer: dict[int, list[int]] = {}
        for p, c in self._prefetch:
            if ops[p].kind == "compute":
                raise PlanError(
                    f"plan.prefetch: op {p} is a compute — only transport "
                    "ops can be prefetched (their completion is what the "
                    "late wait covers)")
            ops[p].prefetch = True
            pf_by_consumer.setdefault(c, []).append(p)

        # backend selection — per recorded macro, whether its whole op range
        # leaves the substrate for its collective; the verdict and any
        # decline reason are recorded ("auto" consults the measured table
        # and never raises)
        gspmd_idxs: set[int] = set()
        gspmd_at: dict[int, _Macro] = {}
        selection: list[tuple] = []
        if backend in ("gspmd", "auto") and not naive_flush:
            from repro_torch.core.rma.backends import costmodel as _costmodel
            from repro_torch.core.rma.backends import gspmd as _gspmd
            for mac in self._macros:
                ok, why = _gspmd.macro_lowerable(self, mac)
                if not ok:
                    selection.append((mac.label, "rma", why))
                    continue
                if backend == "auto":
                    target, reason = _costmodel.choose(mac.kind)
                else:
                    target, reason = "gspmd", "forced by backend='gspmd'"
                selection.append((mac.label, target, reason))
                if target == "gspmd":
                    gspmd_idxs.update(range(mac.lo, mac.hi))
                    gspmd_at[mac.lo] = mac
        resolved_backend = ("interpret" if backend == "interpret"
                            else "gspmd" if gspmd_at else "rma")

        # pass 0 — dependency graph + cycle check (value vs completion edges)
        for o in ops:
            sync = {r.idx for r in o.after}
            deps = set(sync)
            deps.update(r.idx for r in o.reads)
            deps.update(self._refs_in(o.source, o.cur, o.offset, o.handle,
                                      o.value))
            o.deps = frozenset(deps)
            o.sync_deps = frozenset(sync)
        succ: dict[int, set[int]] = {o.idx: set() for o in ops}
        indeg = {o.idx: len(o.deps) for o in ops}
        for o in ops:
            for d in o.deps:
                succ[d].add(o.idx)
        for first, then in self._edges:
            if then not in succ[first]:
                succ[first].add(then)
                indeg[then] += 1
        ready = sorted(i for i, d in indeg.items() if d == 0)
        topo: list[int] = []
        while ready:
            i = ready.pop(0)
            topo.append(i)
            for j in sorted(succ[i]):
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
            ready.sort()
        if len(topo) != len(ops):
            cyc = sorted(i for i, d in indeg.items() if d > 0)
            raise PlanError(
                f"ordering cycle through ops {cyc} — the recorded edges "
                "admit no schedule; remove one plan.order()/after= edge")
        edge_extra: dict[int, set[int]] = {o.idx: set() for o in ops}
        for first, then in self._edges:
            edge_extra[then].add(first)

        # pass 1 — declaration validation (build-time, per paper §2.3)
        for o in ops:
            if o.kind == "compute":
                continue
            w = self._windows[o.window]
            if o.kind in ("accumulate", "hop", "fetch_op", "signal"):
                name = o.op if o.kind != "signal" else (w.same_op or "sum")
                if name not in KNOWN_ACC_OPS:
                    raise PlanError(f"unknown accumulate op {name!r} (op {o.idx})")
                if name not in w.accumulate_ops:
                    raise PlanError(
                        f"op {o.idx} ({o.kind}) uses {name!r} but window "
                        f"{w.name!r} declares accumulate_ops="
                        f"{w.accumulate_ops!r} — an undeclared operation is "
                        "a declaration violation; extend the window's "
                        "declared vocabulary at plan.window()")
            if o.stream is not None and not (0 <= o.stream < w.max_streams):
                raise PlanError(
                    f"op {o.idx} pins stream {o.stream} but window {w.name!r} "
                    f"declares max_streams={w.max_streams}")

        # pass 2 — accumulate routing from the plan-wide declared op set
        for o in ops:
            if o.kind in ("accumulate", "hop"):
                spec = self._spec_of(o)
                if spec is None:
                    raise PlanError(
                        f"op {o.idx} ({o.kind}) needs a declared payload "
                        "spec for routing — bind() the source or pass "
                        "shape=/dtype=")
                shape, dt = spec
                count = 1
                for dim in shape:
                    count *= dim
                try:
                    o.path = acc_engine.route(o.op, count, dt,
                                              self._windows[o.window].config())
                except ValueError as e:
                    raise PlanError(f"op {o.idx}: {e}") from None
            elif o.kind == "signal":
                w = self._windows[o.window]
                flag_op = w.same_op if w.same_op is not None else "sum"
                try:
                    o.path = acc_engine.route(flag_op, 1, w.dtype, w.config())
                except ValueError as e:
                    raise PlanError(f"op {o.idx}: {e}") from None

        # pass 2b — topology tier classification (intra: the whole permute
        # stays on one host, rides the shared-memory tier, owes no epoch)
        tdecl = self.topology
        for o in ops:
            if o.kind == "compute":
                continue
            o.tier = ("intra" if tdecl is not None
                      and tdecl.perm_is_intra(o.perm) else "inter")

        # pass 3 — stream assignment: chains inherit, independent chains
        # spread round-robin over the declared streams (max P1 concurrency).
        # A window with prefetch ops dedicates its last declared stream to
        # them, so the late prefetch-wait drains prefetch traffic only
        pos = {idx: k for k, idx in enumerate(topo)}
        next_stream: dict[str, int] = {}
        pf_windows = {ops[p].window for ps in pf_by_consumer.values()
                      for p in ps}
        for idx in topo:
            o = ops[idx]
            if o.kind == "compute" or o.stream is not None:
                continue
            w = self._windows[o.window]
            if o.prefetch:
                o.stream = w.max_streams - 1
                continue
            same_win = [d for d in self._comm_ancestors(ops, o)
                        if ops[d].window == o.window
                        and ops[d].stream is not None]
            if same_win:
                o.stream = ops[max(same_win, key=lambda d: pos[d])].stream
            else:
                lanes = w.max_streams
                if o.window in pf_windows and w.max_streams > 1:
                    lanes = w.max_streams - 1   # keep the prefetch lane clear
                nxt = next_stream.get(o.window, 0)
                o.stream = nxt % lanes
                next_stream[o.window] = nxt + 1

        # pass 4 — comm frontiers of all edges and of completion edges
        comm: dict[int, frozenset] = {}
        for idx in topo:
            o = ops[idx]
            acc: set[int] = set()
            for d in sorted(o.deps | edge_extra[idx]):
                if ops[d].kind == "compute":
                    acc |= comm[d]
                else:
                    acc.add(d)
            comm[idx] = frozenset(acc)
            o.comm_deps = comm[idx]
            sync: set[int] = set()
            for d in sorted(o.sync_deps | edge_extra[idx]):
                if ops[d].kind == "compute":
                    sync |= comm[d]
                else:
                    sync.add(d)
            o.comm_sync = frozenset(sync)

        # pass 5 — put fusion: same (window, stream, perm), static offsets,
        # identical dependency frontier => one gather-write phase
        fused_groups: list[list[int]] = []
        fused_of: dict[int, int] = {}
        if not naive_flush:
            buckets: dict[tuple, list[int]] = {}
            for idx in topo:
                o = ops[idx]
                if (o.kind == "put" and o.fuse and _is_static(o.offset)
                        and self._spec_of(o) is not None):
                    key = (o.window, o.stream, o.perm, o.comm_deps)
                    buckets.setdefault(key, []).append(idx)
            for members in buckets.values():
                if len(members) > 1:
                    gid = len(fused_groups)
                    fused_groups.append(members)
                    for m in members:
                        fused_of[m] = gid

        # pass 6 — schedule with coalesced flush epochs (intra-tier ops are
        # born completed: they never enter `pending`)
        steps: list[_Step] = []
        flushed: set[int] = {o.idx for o in ops
                             if o.kind != "compute" and o.tier == "intra"}
        # ops of a collective step never touch the substrate: born completed
        flushed.update(i for i in gspmd_idxs if ops[i].kind != "compute")
        pending: dict[tuple, list[int]] = {}
        used_streams: dict[str, set] = {w: set() for w in self._windows}
        inter_streams: dict[str, set] = {w: set() for w in self._windows}

        def emit_flush(wname: str, stream: int | None, pwait: bool = False):
            w = self._windows[wname]
            if w.scope == SCOPE_THREAD:
                keys = [(wname, stream)]
            else:  # process scope: the engine drains every stream, serialized
                keys = [k for k in pending if k[0] == wname]
                stream = None
            ph = sum(2 for k in keys if pending.get(k))
            steps.append(_Step(kind="flush", window=wname, stream=stream,
                               phases=ph, pwait=pwait))
            for k in keys:
                flushed.update(pending.pop(k, ()))

        for wname, w in self._windows.items():
            # entry epochs drain the caller's in-flight ops (unknowable at
            # compile: 0 predicted); omitted under a single-host topology
            if w.entry_epoch and (tdecl is None or tdecl.hosts > 1):
                strs = sorted({o.stream for o in ops
                               if o.kind != "compute" and o.window == wname
                               and o.idx not in gspmd_idxs})
                for s in strs:
                    steps.append(_Step(kind="entry", window=wname, stream=s))

        for idx in topo:
            o = ops[idx]
            # late prefetch waits: a prefetched op's epoch lands here, right
            # before its consumer's step
            for p in pf_by_consumer.get(idx, ()):
                if p not in flushed:
                    emit_flush(ops[p].window, ops[p].stream, pwait=True)
            if idx in gspmd_idxs:
                # a backend-selected macro: its whole range is one
                # collective step at the range head (topo order is index
                # order, so every value the macro consumes exists)
                mac = gspmd_at.get(idx)
                if mac is not None:
                    steps.append(_Step(kind="gspmd", macro=mac, phases=0))
                continue
            if o.kind == "compute":
                steps.append(_Step(kind="op", op=o))
                continue
            gid = fused_of.get(idx)
            if gid is not None and idx != fused_groups[gid][0]:
                continue  # emitted with the group head
            group = fused_groups[gid] if gid is not None else [idx]
            for member in group:
                for d in sorted(ops[member].comm_sync):
                    if d in gspmd_idxs:
                        continue    # a collective step completes at once
                    u = ops[d]
                    if (not self._windows[u.window].order) and d not in flushed:
                        emit_flush(u.window, u.stream)
            key = (o.window, o.stream)
            if gid is not None:
                steps.append(_Step(kind="fused", window=o.window,
                                   stream=o.stream,
                                   group=tuple(ops[m] for m in group),
                                   phases=1, tier=o.tier))
            else:
                steps.append(_Step(kind="op", window=o.window,
                                   stream=o.stream, op=o,
                                   phases=self._op_phases(o), tier=o.tier))
            pending.setdefault(key, []).extend(
                m for m in group if ops[m].tier == "inter")
            used_streams[o.window].add(o.stream)
            if o.tier == "inter":
                inter_streams[o.window].add(o.stream)
            if naive_flush:
                emit_flush(o.window, o.stream)

        # exit epochs complete what the pattern put in flight (only streams
        # that carried inter-tier ops owe one)
        for wname, w in self._windows.items():
            if not w.exit_epoch:
                continue
            if w.scope == SCOPE_THREAD:
                for s in sorted(inter_streams[wname]):
                    emit_flush(wname, s)
            elif inter_streams[wname]:
                emit_flush(wname, None)

        # the port's kernels lower what stayed on the substrate: K5 a declared
        # flat ring, K4/K6 a payload and its chained doorbell
        rings = [mac for mac in self._macros
                 if mac.kind == "ring" and mac.lo not in gspmd_at]
        ring_low = [(mac.label, *self._k5_lowering(mac, naive_flush))
                    for mac in rings]
        kernel_macros = tuple(mac for mac, low in zip(rings, ring_low)
                              if low[1] == "k5")
        in_kernel = {i for mac in kernel_macros for i in range(mac.lo, mac.hi)}
        pairs = self._signal_lowering(ops, steps, fused_of, in_kernel,
                                      naive_flush, gspmd_idxs)
        lowering = tuple(selection) + tuple(ring_low) + tuple(
            (f"{ops[d].label or ops[d].kind}+{ops[g].label or 'signal'}", k,
             why) for d, g, k, _, why in pairs)
        return CompiledPlan(
            name=self.name, windows=dict(self._windows),
            bindings=dict(self._bindings), steps=tuple(steps),
            outputs=tuple(self._outputs),
            used_streams={w: tuple(sorted(s))
                          for w, s in used_streams.items()},
            naive=naive_flush, topology=self.topology,
            backend=resolved_backend, lowering=lowering,
            kernel_macros=kernel_macros,
            signal_pairs=tuple(p for p in pairs if p[2] != "rma"))

    @staticmethod
    def _comm_ancestors(ops, o: _Op):
        """Direct deps, looking through compute ops to their comm frontier."""
        seen, stack, out = set(), list(o.deps), []
        while stack:
            d = stack.pop()
            if d in seen:
                continue
            seen.add(d)
            if ops[d].kind == "compute":
                stack.extend(ops[d].deps)
            else:
                out.append(d)
        return out

    def _op_phases(self, o: _Op) -> int:
        """The substrate cost model, applied at compile time."""
        addr = 0 if _is_static(o.offset) else 1
        if o.kind == "put":
            return 1 + addr
        if o.kind == "send":
            return 1
        if o.kind in ("put_handle", "get_handle"):
            return 2              # payload or request + the handle header
        if o.kind in ("get", "fetch_op"):
            return 2 + addr
        if o.kind in ("accumulate", "signal"):
            return (2 if o.path == acc_engine.PATH_SOFTWARE else 1) + addr
        if o.kind == "hop":
            return 2 if o.path == acc_engine.PATH_SOFTWARE else 1
        raise AssertionError(o.kind)


@dataclasses.dataclass
class CompiledPlan:
    """A frozen, replayable communication schedule.  ``phases`` is the
    planner's predicted phase count — the cost model the substrate's ledger
    bills, so a replay's ledger must equal it — kept per tier under a
    declared topology (``phases_inter``/``phases_intra``)."""

    name: str
    windows: dict[str, _PlanWindow]
    bindings: dict[str, tuple]
    steps: tuple
    outputs: tuple
    used_streams: dict[str, tuple]
    naive: bool = False
    topology: Topology | None = None
    #: resolved lowering target: "rma", "gspmd" (at least one macro taken
    #: over by its collective) or "interpret" (the walker's tag)
    backend: str = "rma"
    #: (label, target, reason) records: first the backend selection of
    #: every macro (under "gspmd"/"auto"; target "rma" | "gspmd"), then
    #: the kernel lowering of every ring macro left on the substrate and
    #: of every payload+doorbell pair ("k5" | "k4" | "k6" | "rma")
    lowering: tuple = ()
    kernel_macros: tuple = ()
    #: the pairs one kernel carries: (data idx, signal idx, kernel,
    #: hoisted flag-value idx or None, reason)
    signal_pairs: tuple = ()

    @property
    def phases(self) -> int:
        return sum(s.phases for s in self.steps)

    @property
    def phases_inter(self) -> int:
        return sum(s.phases for s in self.steps if s.tier == "inter")

    @property
    def phases_intra(self) -> int:
        return sum(s.phases for s in self.steps if s.tier == "intra")

    def phase_table(self) -> list[tuple[str, int]]:
        """Per-step (label, predicted phases); node-local steps are tagged
        ``[intra]``.  A backend other than ``rma`` leads with a
        ``backend[...]`` row, and collective steps read
        ``gspmd:psum[...]`` / ``gspmd:all_to_all[...]``."""
        rows = []
        if self.backend != "rma":
            rows.append((f"backend[{self.backend}]", 0))
        for s in self.steps:
            tag = " [intra]" if s.tier == "intra" else ""
            if s.kind == "gspmd":
                coll = "psum" if s.macro.kind == "ring" else "all_to_all"
                rows.append((f"gspmd:{coll}[{s.macro.label}]", s.phases))
            elif s.kind == "flush":
                word = "prefetch-wait" if s.pwait else "flush"
                rows.append((f"{word}[{s.window}/{s.stream}]", s.phases))
            elif s.kind == "entry":
                rows.append((f"entry[{s.window}/{s.stream}]", s.phases))
            elif s.kind == "fused":
                rows.append((f"fused-put[{s.window}/{s.stream}]x"
                             f"{len(s.group)}{tag}", s.phases))
            elif s.op.kind == "compute":
                continue
            else:
                name = s.op.label or f"{s.op.kind}#{s.op.idx}"
                if s.op.prefetch:
                    name = f"prefetch:{name}"
                rows.append((f"{name}{tag}", s.phases))
        return rows

    # -- execute: replay the schedule ----------------------------------------
    def _resolve(self, spec, env: PlanEnv):
        if isinstance(spec, OpRef):
            return env.values[spec.idx]
        if isinstance(spec, str):
            return env.bindings[spec]
        if callable(spec):
            return spec(env)
        return spec

    def execute(self, windows: dict[str, Any],
                bindings: dict[str, torch.Tensor] | None = None, *,
                donate: Sequence[str] = ()) -> PlanResult:
        """Replay the schedule on live windows with fresh stacked bindings.

        Each window runs under the plan's declared config for the replay
        (a zero-copy dup) and comes back with the caller's config.  A
        binding named in ``donate`` may be overwritten (the K5 ring reduces
        it in place instead of copying)."""
        with obs.span("rma.execute", plan=self.name):
            return self._replay(windows, bindings, donate)

    def _replay(self, windows, bindings, donate) -> PlanResult:
        bindings = dict(bindings or {})
        n = None
        device = None
        for bname, (shape, dt) in self.bindings.items():
            if bname not in bindings:
                raise PlanError(f"execute() missing binding {bname!r}")
            got = bindings[bname]
            if tuple(got.shape[1:]) != shape or got.dtype != dt:
                raise PlanError(
                    f"binding {bname!r} expects stacked shape=(n, *{shape}) "
                    f"dtype={dt}, got shape={tuple(got.shape)} "
                    f"dtype={got.dtype} — rebuild the plan for a new "
                    "pattern instead of rebinding")
        views: dict[str, Any] = {}
        for wname, decl in self.windows.items():
            if wname not in windows:
                raise PlanError(f"execute() missing window {wname!r}")
            win = windows[wname]
            need = max(self.used_streams[wname], default=0) + 1
            if win.substrate.n_streams < need:
                raise PlanError(
                    f"plan {self.name!r} schedules {need} issue stream(s) on "
                    f"window {wname!r} but its substrate was allocated with "
                    f"{win.substrate.n_streams}; allocate with "
                    f"max_streams>={need}")
            cfg = decl.config().replace(max_streams=win.substrate.n_streams,
                                        topology=self.topology)
            views[wname] = dataclasses.replace(win, config=cfg)
            n, device = win.axis_size, win.device
        env = PlanEnv(bindings, views, n, device)
        errs = torch.zeros(n, dtype=torch.int32, device=device)

        macro_at = {mac.lo: mac for mac in self.kernel_macros}
        skip: set[int] = set()
        for mac in self.kernel_macros:
            skip.update(range(mac.lo, mac.hi))
        pair_at = {p[0]: p for p in self.signal_pairs}
        by_idx = {s.op.idx: s for s in self.steps if s.kind == "op"}
        done: set[int] = set()      # ops a paired launch already carried
        for step in self.steps:
            if step.kind == "gspmd":
                from repro_torch.core.rma.backends.gspmd import execute_macro

                env.values.update(execute_macro(
                    step.macro, lambda spec: self._resolve(spec, env)))
                continue
            if step.kind in ("entry", "flush"):
                w = views[step.window]
                w.substrate.flush(scope=self.windows[step.window].scope,
                                  stream=step.stream)
                continue
            if step.kind == "fused":
                sub = views[step.window].substrate
                sub.put_multi([self._resolve(o.source, env) for o in step.group],
                              step.group[0].perm,
                              offsets=[o.offset for o in step.group],
                              stream=step.stream, shm=step.tier == "intra")
                continue
            o = step.op
            if o.idx in skip:
                mac = macro_at.get(o.idx)
                if mac is not None:
                    self._run_kernel_macro(mac, views, env, donate)
                continue
            if o.idx in done:
                continue
            if o.kind == "compute":
                env.values[o.idx] = o.fn(env)
                continue
            pair = pair_at.get(o.idx)
            if pair is not None:
                done.update(self._run_signal_pair(pair, by_idx, views, env))
                continue
            self._exec_comm(o, views, env, errs)

        outputs = {name: self._resolve(spec, env) for name, spec in self.outputs}
        restored = {wname: dataclasses.replace(views[wname],
                                               config=windows[wname].config)
                    for wname in self.windows}
        return PlanResult(windows=restored, outputs=outputs, err_count=errs)

    def interpret(self, buffers, bindings=None, *, axis: str = "x",
                  regs=None):
        """Walk this schedule on stacked tensors with no substrate: every
        window buffer and binding is the stacked ``(n, ...)`` tensor of all
        ranks.  ``regs`` maps handle windows to stacked ``(n, slots, 3)``
        registration tables — needed to model ``put_handle``/``get_handle``
        (stale drops and zero-masks counted per rank); without it those
        raise.  Returns an ``InterpretResult`` (see
        :mod:`repro_torch.core.rma.backends.interpret`)."""
        from repro_torch.core.rma.backends.interpret import interpret_plan

        return interpret_plan(self, buffers, bindings, axis=axis, regs=regs)

    def _run_kernel_macro(self, mac: _Macro, views, env: PlanEnv,
                          donate) -> None:
        """The declared flat ring in one K5 launch, billed — and queued for
        its exit epoch — exactly as the op range it replaces."""
        from repro_torch.kernels.ring_allreduce import ring_all_reduce

        x = self._resolve(mac.source, env)
        inplace = isinstance(mac.source, str) and mac.source in donate
        env.values[mac.results[0].idx] = ring_all_reduce(
            x, axis_size=mac.n, inplace=inplace)
        sub = views[mac.windows[0]].substrate
        for s in self.steps:
            o = s.op
            if s.kind != "op" or o.kind == "compute" or \
                    not mac.lo <= o.idx < mac.hi:
                continue
            shm = o.tier == "intra"
            sub.ledger.bill("ring", s.phases, shm=shm)
            if not shm:
                sub.queues.note_op(o.stream, o.perm)

    @staticmethod
    def _bill(step: _Step, sub) -> None:
        """Bill a step's op to its window's ledger and queue as its op-by-op
        execution would."""
        o = step.op
        kind = {"put": "put", "send": "send", "hop": "send"}.get(
            o.kind, "accumulate")
        shm = o.tier == "intra"
        sub.ledger.bill(kind, step.phases, shm=shm)
        if not shm:
            sub.queues.note_op(o.stream, o.perm)

    def _run_signal_pair(self, pair, by_idx, views, env: PlanEnv
                         ) -> tuple[int, ...]:
        """A payload op and its chained signal in one K4/K6 launch
        (:meth:`Substrate.launch_signal`), billed as the two ops; returns
        the ops it carried (the signal, a hoisted flag value)."""
        d_idx, g_idx, _, hoist, _ = pair
        d, sig = by_idx[d_idx].op, by_idx[g_idx].op
        dsub = views[d.window].substrate
        fsub = views[sig.window].substrate
        fdecl = self.windows[sig.window]
        if hoist is not None:
            env.values[hoist] = by_idx[hoist].op.fn(env)
        flag_op = fdecl.same_op if fdecl.same_op is not None else "sum"
        flag = self._resolve(sig.value, env)
        if flag is None:
            one = acc_engine.default_flag_value(flag_op, fsub.buffer.dtype)
            flag = one.to(fsub.device).expand(fsub.axis_size, 1)
        common = dict(flag=flag, flag_offset=sig.offset, flag_op=flag_op,
                      flag_sub=fsub, stream=d.stream)
        if d.kind == "send":
            src = self._resolve(d.source, env).contiguous()
            rows = src.view(-1, 1) if src.dim() == 1 else src
            out = torch.zeros_like(rows)
            dsub.launch_signal(rows, d.perm, dst=out, **common)
            env.values[d.idx] = out.view(src.shape)
        elif d.kind == "hop":
            out = self._resolve(d.cur, env).clone()
            rows = out.view(-1, 1) if out.dim() == 1 else out
            piece = self._resolve(d.source, env).reshape(rows.shape)
            dsub.launch_signal(piece, d.perm, op=d.op, dst=rows, **common)
            idle = sorted(set(range(out.shape[0])) - {t for _, t in d.perm})
            if idle:    # op by op they add the zeros they received
                out[idle] += 0
            env.values[d.idx] = out
        else:           # put / accumulate into the window
            dsub.launch_signal(self._resolve(d.source, env), d.perm,
                               op=d.op if d.kind == "accumulate" else None,
                               offset=self._resolve(d.offset, env), **common)
        self._bill(by_idx[d_idx], dsub)
        self._bill(by_idx[g_idx], fsub)
        return (g_idx,) if hoist is None else (g_idx, hoist)

    def _exec_comm(self, o: _Op, views, env: PlanEnv,
                   errs: torch.Tensor) -> None:
        decl = self.windows[o.window]
        sub = views[o.window].substrate
        shm = o.tier == "intra"
        offset = self._resolve(o.offset, env)
        if o.kind == "put":
            sub.put(self._resolve(o.source, env), o.perm, offset=offset,
                    stream=o.stream, shm=shm)
        elif o.kind == "get":
            _, env.values[o.idx] = sub.get(o.perm, offset=offset,
                                           size=o.size, stream=o.stream,
                                           shm=shm)
        elif o.kind == "send":
            _, env.values[o.idx] = sub.channel_send(
                self._resolve(o.source, env), o.perm, stream=o.stream,
                shm=shm)
        elif o.kind == "hop":
            piece = self._resolve(o.source, env)
            cur = self._resolve(o.cur, env)
            _, recvd = sub.channel_send(piece, o.perm, stream=o.stream,
                                        shm=shm)
            if o.path == acc_engine.PATH_SOFTWARE:
                sub.target_ack(o.perm, stream=o.stream)
            env.values[o.idx] = acc_engine.apply_op(cur, recvd, o.op)
        elif o.kind in ("accumulate", "signal"):
            if o.kind == "signal":
                op_name = decl.same_op if decl.same_op is not None else "sum"
                data = self._resolve(o.value, env)
                if data is None:
                    one = acc_engine.default_flag_value(op_name,
                                                        sub.buffer.dtype)
                    data = one.to(sub.device).expand(sub.axis_size, 1)
            else:
                op_name, data = o.op, self._resolve(o.source, env)
            sub.rmw(data, o.perm, op_name, path=o.path, offset=offset,
                    stream=o.stream, shm=shm)
        elif o.kind == "fetch_op":
            _, env.values[o.idx] = sub.fetch_rmw(
                self._resolve(o.source, env), o.perm, o.op, offset=offset,
                stream=o.stream, shm=shm)
        elif o.kind in ("put_handle", "get_handle"):
            from repro_torch.core.rma.dynamic import DynamicWindow
            from repro_torch.core.rma.memhandle import win_from_memhandle

            view = views[o.window]
            if not isinstance(view, DynamicWindow):
                raise PlanError(f"{o.kind} needs a dynamic window for "
                                f"{o.window!r}, got {type(view).__name__}")
            mhw = win_from_memhandle(view, self._resolve(o.handle, env),
                                     slot=o.slot)
            if o.kind == "put_handle":
                mhw.put(self._resolve(o.source, env), o.perm, offset=offset,
                        stream=o.stream)
            else:
                _, env.values[o.idx] = mhw.get(o.perm, offset=offset,
                                               size=o.size, stream=o.stream)
            errs += mhw.err_count
        else:
            raise AssertionError(o.kind)


# ---------------------------------------------------------------------------
# Plan-cache registry — the recompilation surface
# ---------------------------------------------------------------------------

#: Every build-once compiled-plan cache in the process, by name.
_PLAN_CACHES: dict[str, dict] = {}


def register_plan_cache(name: str, cache: dict) -> dict:
    """Register a build-once compiled-plan cache (held by reference) so a
    topology change can drop exactly the affected entries."""
    _PLAN_CACHES[name] = cache
    return cache


def plan_cache_stats() -> dict[str, int]:
    """Entry count per registered cache."""
    return {name: len(cache) for name, cache in _PLAN_CACHES.items()}


def invalidate_plan_caches(predicate: Callable[[tuple], bool]
                           ) -> dict[str, list]:
    """Drop every cached plan whose key matches ``predicate``; returns
    ``{cache_name: [dropped keys]}`` for non-empty drops."""
    dropped: dict[str, list] = {}
    for name, cache in _PLAN_CACHES.items():
        hits = [k for k in cache if predicate(k)]
        for k in hits:
            del cache[k]
        if hits:
            dropped[name] = hits
    return dropped


def invalidate_topology(fingerprint: tuple) -> dict[str, list]:
    """Drop every cached plan built for topology ``fingerprint`` (a
    ``Topology.fingerprint()``; ``None`` is ambiguous in cache keys and
    raises)."""
    if fingerprint is None:
        raise ValueError(
            "invalidate_topology(None): the undeclared-flat fingerprint is "
            "ambiguous in cache keys — declare a Topology (e.g. "
            "Topology.flat(n)) so its fingerprint can be matched exactly")
    return invalidate_plan_caches(
        lambda key: any(el == fingerprint for el in key))


# ---------------------------------------------------------------------------
# Legacy-wrapper deprecation bookkeeping
# ---------------------------------------------------------------------------

_LEGACY_WARNED: set[str] = set()


def warn_legacy_once(entry: str, replacement: str) -> None:
    """Emit the legacy entry point's ``DeprecationWarning`` once per process
    per entry point.  The wrappers stay supported and numerically identical
    (they build and execute the same plan); the warning points callers at
    the plan-native surface."""
    if entry in _LEGACY_WARNED:
        return
    _LEGACY_WARNED.add(entry)
    warnings.warn(
        f"{entry} is a legacy imperative entry point kept as a thin wrapper "
        f"over the declarative plan API; build the pattern once with "
        f"{replacement} and replay it", DeprecationWarning, stacklevel=3)


__all__ = [
    "RmaPlan", "CompiledPlan", "PlanEnv", "PlanResult", "PlanError", "OpRef",
    "register_plan_cache", "plan_cache_stats", "invalidate_plan_caches",
    "invalidate_topology", "warn_legacy_once",
]
