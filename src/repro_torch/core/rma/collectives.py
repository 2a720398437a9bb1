"""One-sided collectives on the RMA substrate.

* ``ring_reduce_scatter`` / ``ring_all_gather``: the imperative rings, hop
  by hop on a window substrate.  Each ring runs on a *duplicated view* of a
  window (P4) carrying its per-use config: with ``order=True`` (P2)
  consecutive hops chain on the stream with no per-hop ack; with
  ``order=False`` a thread-scope flush (P1) precedes every hop that
  consumes remotely written data.  A reduce hop is an accumulate routed
  through the engine (``accumulate.acc_hop``): a view declaring
  ``same_op="sum"`` (``declare_op=True``) stays at one data phase a hop,
  an undeclared one pays a completion ack.  On the card every hop is one
  K3 launch (``Substrate.channel_send``) and every flush one K3 wait.
* ``plan_all_reduce`` / ``all_reduce_plan``: the ring all-reduce as a
  declarative plan, and ``rma_all_reduce``, its deprecated imperative
  entry point.

The planned ring is recorded as a declarative plan (:mod:`repro_torch.core.rma.
plan`) on a thread-scope window: reduce-scatter hops are accumulates routed
through the engine (a window declaring ``same_op="sum"`` stays at one data
phase per hop; an undeclared one pays a completion ack per hop), all-gather
hops are channel sends, and under ``order=True`` (P2) consecutive hops chain
without flushes — 2(n−1) phases.  A declared ``g×l`` topology rewrites the
ring hierarchically: intra-host reduce-scatter, a ring over the host
leaders, intra-host all-gather — 2(g−1) inter-host phases.

Everything is stacked: ``x`` is ``(n, ...)``, row r = rank r's
contribution, and every row of the result holds the reduction.  The
declared flat ring executes as one launch of kernel K5
(``kernels.ring_allreduce``), which sums in this recorder's order.

Producer/consumer notification (paper Listings 1 and 2): ``put_signal`` and
``put_signal_pipelined`` land a payload and then its flag, the pair as one
launch of kernel K4 (``kernels.ordered_put_signal``).
"""
from __future__ import annotations

import torch

import dataclasses

from repro_torch.core.rma import accumulate as acc_engine
from repro_torch.core.rma.plan import OpRef, RmaPlan, register_plan_cache
from repro_torch.core.rma.substrate import (SCOPE_THREAD, CompletionToken,
                                            Substrate)
from repro_torch.core.rma.topology import (Topology, default_topology,
                                           topology_fingerprint)
from repro_torch.core.rma.window import Window, WindowConfig
from repro_torch.kernels.common import as_dtype


def _ring_perm(n: int, shift: int = 1):
    return tuple((i, (i + shift) % n) for i in range(n))


def _refs(*xs):
    """The OpRefs among ``xs`` (binding names carry no ordering edge)."""
    return tuple(r for r in xs if isinstance(r, OpRef))


# ---------------------------------------------------------------------------
# The imperative rings
# ---------------------------------------------------------------------------


def _ring_substrate(x: torch.Tensor, axis: str, n: int, *, order: bool,
                    win: Window | None, streams=(0,),
                    same_op: str | None = None
                    ) -> tuple[Substrate, WindowConfig]:
    """The substrate a ring runs on, and the config in effect.

    With a lent ``win`` the ring runs on a **duplicate** carrying its
    per-use config (P4); ``max_streams`` is dup-immutable, so the lent
    window must have enough issue streams.  Entering the collective
    flushes the caller's in-flight operations on the streams the ring is
    about to use.  Without ``win`` a one-off window over ``x`` is
    allocated (its flushes find nothing to drain).  ``same_op``: the reduce
    rings' op declaration (paper §2.3); ``None`` leaves the hops
    undeclared."""
    acc_info = ({"same_op": same_op, "accumulate_ops": (same_op,)}
                if same_op is not None else {"same_op": None})
    if win is not None:
        if max(streams) >= win.config.max_streams:
            raise ValueError(
                f"ring needs streams {tuple(streams)} but the lent window "
                f"has max_streams={win.config.max_streams} (dup-immutable); "
                "allocate it with enough issue streams")
        view = win.dup_with_info(order=order, scope=SCOPE_THREAD, **acc_info)
    else:
        view = Window.allocate(
            x.contiguous(), axis, n,
            WindowConfig(scope=SCOPE_THREAD, order=order,
                         max_streams=len(streams), **acc_info))
    sub = view.substrate
    for s in streams:
        sub = sub.flush(scope=view.config.scope, stream=s)
    return sub, view.config


def _finish_lent(subs, out: torch.Tensor, win: Window | None, streams
                 ) -> torch.Tensor:
    """A collective on a **lent** window returns with nothing in flight, as
    an MPI blocking collective does: each direction's stream is flushed
    (thread scope).  A one-off window's queues die with it."""
    if win is None:
        return out
    for sub, s in zip(subs, streams):
        sub.flush(scope=SCOPE_THREAD, stream=s)
    return out


def _hop_flush(sub: Substrate, *, order: bool, stream: int,
               dependent: bool) -> Substrate:
    """Without P2 a completion ack (thread-scope flush epoch) precedes
    every hop that consumes remotely written data."""
    if order or not dependent:
        return sub
    return sub.flush(scope=SCOPE_THREAD, stream=stream)


def _by_chunk(x: torch.Tensor, n: int) -> torch.Tensor:
    """Stacked ``(n, L, ...)`` as ``(rank, chunk, L // n, ...)``."""
    c = x.shape[1] // n
    return x[:, :n * c].reshape((x.shape[0], n, c) + tuple(x.shape[2:]))


def _ring_reduce_scatter_dir(sub: Substrate, x: torch.Tensor, n: int, *,
                             cfg: WindowConfig, shift: int, stream: int = 0,
                             op: str = "sum") -> tuple[Substrate,
                                                       torch.Tensor]:
    """One direction's reduce-scatter: at hop k rank r sends its partial of
    chunk (r − s·k) and adds what arrives into chunk (r − s(k+1)); rank r
    ends owning chunk (r + s), returned stacked."""
    perm = _ring_perm(n, shift)
    ranks = torch.arange(n, device=x.device)
    s = 1 if shift == 1 else -1
    acc = _by_chunk(x, n).clone()
    for k in range(n - 1):
        # hop k sends a partial holding hop k-1's received data
        sub = _hop_flush(sub, order=cfg.order, stream=stream, dependent=k > 0)
        piece = acc[ranks, (ranks - s * k) % n]
        recv = (ranks - s * (k + 1)) % n
        sub, new = acc_engine.acc_hop(sub, cfg, acc[ranks, recv], piece,
                                      perm, op=op, stream=stream)
        acc[ranks, recv] = new
    return sub, acc[ranks, (ranks + s) % n]


def _ring_all_gather_dir(sub: Substrate, x: torch.Tensor, n: int, *,
                         order: bool, shift: int, owner_shift: int = 0,
                         stream: int = 0, entry_dep: bool = False
                         ) -> tuple[Substrate, torch.Tensor]:
    """One direction's all-gather: every hop forwards the piece received in
    the one before (``entry_dep``: hop 0 also depends on an earlier phase,
    as RS → AG does)."""
    if n == 1:
        return sub, x
    perm = _ring_perm(n, shift)
    ranks = torch.arange(n, device=x.device)
    s = 1 if shift == 1 else -1
    out = x.new_zeros((x.shape[0], n) + tuple(x.shape[1:]))
    out[ranks, (ranks + owner_shift) % n] = x
    piece = x
    for k in range(n - 1):
        sub = _hop_flush(sub, order=order, stream=stream,
                         dependent=k > 0 or entry_dep)
        sub, piece = sub.channel_send(piece, perm, stream=stream)
        # the piece received at hop k left rank r − s(k+1), which owns
        # chunk (origin + owner_shift) % n
        out[ranks, (ranks - s * (k + 1) + owner_shift) % n] = piece
    return sub, out.reshape((x.shape[0], n * x.shape[1])
                            + tuple(x.shape[2:]))


def _check_stacked(x: torch.Tensor, n: int, what: str) -> None:
    if x.dim() < 2 or x.shape[0] != n:
        raise ValueError(f"{what} expects stacked input with leading dim "
                         f"{n}, got {tuple(x.shape)}")


def ring_reduce_scatter(x: torch.Tensor, axis: str, axis_size: int, *,
                        order: bool = True, bidirectional: bool = False,
                        win: Window | None = None,
                        declare_op: bool = True) -> torch.Tensor:
    """Ring reduce-scatter of the stacked ``x`` (``(n, L, ...)``, ``L``
    divisible by n): row r of the result is the sum over ranks of chunk
    ``(r + 1) % n`` (``(n, L // n, ...)``).

    ``order=False`` is the paper's no-P2 baseline: a completion ack (a
    thread-scope flush) before each dependent hop.  ``bidirectional=True``
    splits every rank's rows in two halves reduced in opposite ring
    directions on two issue streams of one substrate.  ``win``: run on a
    duplicate of this lent window instead of a throwaway one (its streams
    are flushed on entry and exit).  ``declare_op=True`` declares
    ``same_op="sum"`` on the ring's view (one data phase a hop); ``False``
    is the undeclared baseline (a completion ack a hop)."""
    n = axis_size
    _check_stacked(x, n, "ring_reduce_scatter")
    if n == 1:
        return x
    if x.shape[1] % n != 0:
        raise ValueError(f"leading dim {x.shape[1]} not divisible by axis "
                         f"size {n}")
    same_op = "sum" if declare_op else None
    if bidirectional:
        h = x.shape[1] // 2
        base, cfg = _ring_substrate(x, axis, n, order=order, win=win,
                                    streams=(0, 1), same_op=same_op)
        s_lo, lo = _ring_reduce_scatter_dir(base, x[:, :h], n, cfg=cfg,
                                            shift=1, stream=0)
        s_hi, hi = _ring_reduce_scatter_dir(base, x[:, h:], n, cfg=cfg,
                                            shift=-1, stream=1)
        out = torch.cat([lo, hi], dim=1)
        return _finish_lent((s_lo, s_hi), out, win, (0, 1))
    sub, cfg = _ring_substrate(x, axis, n, order=order, win=win,
                               same_op=same_op)
    sub, mine = _ring_reduce_scatter_dir(sub, x, n, cfg=cfg, shift=1)
    return _finish_lent((sub,), mine, win, (0,))


def ring_all_gather(x: torch.Tensor, axis: str, axis_size: int, *,
                    order: bool = True, owner_shift: int = 0,
                    win: Window | None = None) -> torch.Tensor:
    """Ring all-gather of the stacked ``x`` (``(n, c, ...)``): every row of
    the result is the concatenation of the ranks' contributions in chunk
    order (``(n, n c, ...)``).  ``owner_shift``: rank r's contribution is
    chunk ``(r + owner_shift) % n`` — after :func:`ring_reduce_scatter`
    rank r owns chunk (r + 1) % n, so the two compose with
    ``owner_shift=1``."""
    _check_stacked(x, axis_size, "ring_all_gather")
    sub, cfg = _ring_substrate(x, axis, axis_size, order=order, win=win)
    sub, out = _ring_all_gather_dir(sub, x, axis_size, order=cfg.order,
                                    shift=1, owner_shift=owner_shift)
    return _finish_lent((sub,), out, win, (0,))


# ---------------------------------------------------------------------------
# The planned all-reduce: the ring pattern as a declarative RMA plan
# ---------------------------------------------------------------------------


def _index(x: torch.Tensor, starts: torch.Tensor, size: int):
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)[:, None]
    return rows, starts[:, None] + torch.arange(size, device=x.device)


def _take(x: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """Per-rank slice along dim 1: ``out[r] = x[r, starts[r]:+size]``."""
    rows, idx = _index(x, starts, size)
    return x[rows, idx]


def _place(x: torch.Tensor, upd: torch.Tensor, starts: torch.Tensor
           ) -> torch.Tensor:
    """Functional per-rank update: a copy of ``x`` with ``upd[r]`` written
    at ``starts[r]`` of row r."""
    out = x.clone()
    rows, idx = _index(x, starts, upd.shape[1])
    out[rows, idx] = upd.to(x.dtype)
    return out


def _zeros(env, shape, dtype):
    return torch.zeros((env.n,) + tuple(shape), dtype=dtype,
                       device=env.ranks.device)


def _record_ring_direction(plan, axis: str, n: int, xref, dshape, dtype, *,
                           shift: int, stream: int, window: str = "ring",
                           op: str = "sum"):
    """Record one ring direction (reduce-scatter then all-gather) on plan
    window ``window``; returns the OpRef of the gathered output.  At hop k
    rank r adds the incoming partial of chunk (r − s(k+1)) to its own."""
    del axis
    chunk = dshape[0] // n
    pshape, s = (chunk,) + tuple(dshape[1:]), (1 if shift == 1 else -1)
    perm = _ring_perm(n, shift)
    state = xref
    prev_hop = None
    for k in range(n - 1):
        piece = plan.compute(
            lambda env, st=state, k=k: _take(
                env[st], ((env.ranks - s * k) % n) * chunk, chunk),
            reads=_refs(state), shape=pshape, dtype=dtype,
            label=f"rs{shift:+d}:piece{k}")
        cur = plan.compute(
            lambda env, st=state, k=k: _take(
                env[st], ((env.ranks - s * (k + 1)) % n) * chunk, chunk),
            reads=_refs(state), shape=pshape, dtype=dtype,
            label=f"rs{shift:+d}:cur{k}")
        prev_hop = plan.hop(
            window, piece, cur, perm, op=op, stream=stream,
            after=_refs(prev_hop), shape=pshape, dtype=dtype,
            label=f"rs{shift:+d}:hop{k}")
        state = plan.compute(
            lambda env, st=state, h=prev_hop, k=k: _place(
                env[st], env[h], ((env.ranks - s * (k + 1)) % n) * chunk),
            reads=_refs(state, prev_hop), shape=dshape, dtype=dtype,
            label=f"rs{shift:+d}:state{k}")
    mine = plan.compute(
        lambda env, st=state: _take(env[st], ((env.ranks + s) % n) * chunk,
                                    chunk),
        reads=_refs(state), shape=pshape, dtype=dtype,
        label=f"rs{shift:+d}:mine")
    # all-gather with owner shift s (rank r owns chunk (r+s) % n after RS)
    out = plan.compute(
        lambda env, mn=mine: _place(_zeros(env, dshape, dtype), env[mn],
                                    ((env.ranks + s) % n) * chunk),
        reads=_refs(mine), shape=dshape, dtype=dtype,
        label=f"ag{shift:+d}:out0")
    piece, prev = mine, prev_hop
    for k in range(n - 1):
        sd = plan.send(window, piece, perm, stream=stream, after=_refs(prev),
                       shape=pshape, dtype=dtype,
                       label=f"ag{shift:+d}:send{k}")
        out = plan.compute(
            lambda env, o=out, sd=sd, k=k: _place(
                env[o], env[sd], ((env.ranks - s * (k + 1) + s) % n) * chunk),
            reads=_refs(out, sd), shape=dshape, dtype=dtype,
            label=f"ag{shift:+d}:out{k + 1}")
        piece = prev = sd
    return out


def _record_tier_rs(plan, window: str, xref, dshape, dtype, *, size: int,
                    perm, idx, op: str, stream: int, tag: str, after=None):
    """Record a reduce-scatter over one tier's ring (shift +1): ``size``
    ranks per ring, ``perm`` the tier's permutation, ``idx(env)`` each
    rank's position in its ring.  Returns ``(mine, last_hop)``."""
    chunk = dshape[0] // size
    pshape = (chunk,) + tuple(dshape[1:])
    state, prev_hop = xref, None
    for k in range(size - 1):
        piece = plan.compute(
            lambda env, st=state, k=k: _take(
                env[st], ((idx(env) - k) % size) * chunk, chunk),
            reads=_refs(state), shape=pshape, dtype=dtype,
            label=f"{tag}:rs:piece{k}")
        cur = plan.compute(
            lambda env, st=state, k=k: _take(
                env[st], ((idx(env) - (k + 1)) % size) * chunk, chunk),
            reads=_refs(state), shape=pshape, dtype=dtype,
            label=f"{tag}:rs:cur{k}")
        prev_hop = plan.hop(
            window, piece, cur, perm, op=op, stream=stream,
            after=_refs(prev_hop, *(after or ())), shape=pshape, dtype=dtype,
            label=f"{tag}:rs:hop{k}")
        state = plan.compute(
            lambda env, st=state, h=prev_hop, k=k: _place(
                env[st], env[h], ((idx(env) - (k + 1)) % size) * chunk),
            reads=_refs(state, prev_hop), shape=dshape, dtype=dtype,
            label=f"{tag}:rs:state{k}")
    mine = plan.compute(
        lambda env, st=state: _take(env[st], ((idx(env) + 1) % size) * chunk,
                                    chunk),
        reads=_refs(state), shape=pshape, dtype=dtype,
        label=f"{tag}:rs:mine")
    return mine, prev_hop


def _record_tier_ag(plan, window: str, xref, pshape, dtype, *, size: int,
                    perm, idx, stream: int, tag: str, entry=None):
    """Record an all-gather (owner shift +1) over one tier's ring; ``entry``
    is the previous stage's last op.  Returns ``(out, last_send)``."""
    chunk = pshape[0]
    oshape = (chunk * size,) + tuple(pshape[1:])
    out = plan.compute(
        lambda env, mn=xref: _place(_zeros(env, oshape, dtype), env[mn],
                                    ((idx(env) + 1) % size) * chunk),
        reads=_refs(xref), shape=oshape, dtype=dtype, label=f"{tag}:ag:out0")
    piece, prev = xref, entry
    for k in range(size - 1):
        sd = plan.send(window, piece, perm, stream=stream, after=_refs(prev),
                       shape=pshape, dtype=dtype, label=f"{tag}:ag:send{k}")
        out = plan.compute(
            lambda env, o=out, sd=sd, k=k: _place(
                env[o], env[sd], ((idx(env) - (k + 1) + 1) % size) * chunk),
            reads=_refs(out, sd), shape=oshape, dtype=dtype,
            label=f"{tag}:ag:out{k + 1}")
        piece = prev = sd
    return out, prev


def _record_hier_ring(plan, window: str, source, topo: Topology, dshape,
                      dtype, *, op: str, stream: int):
    """The hierarchical rewrite: intra-host reduce-scatter → ring over the
    g host leaders per local index (j-plane lanes) → intra-host all-gather.
    The intra stages ride same-host perms (the shared-memory tier), so the
    inter-host phase count is exactly 2(g−1)."""
    g, l = topo.hosts, topo.local

    def local(env):
        return env.ranks % l

    def host(env):
        return env.ranks // l

    perm_i = topo.intra_ring_perm(1)
    perm_x = topo.inter_ring_perm(1)
    chunk_a = dshape[0] // l
    ashape = (chunk_a,) + tuple(dshape[1:])
    bshape = (chunk_a // g,) + tuple(dshape[1:])
    mine_a, last_a = _record_tier_rs(
        plan, window, source, dshape, dtype, size=l, perm=perm_i, idx=local,
        op=op, stream=stream, tag="hA")
    mine_b, last_rs = _record_tier_rs(
        plan, window, mine_a, ashape, dtype, size=g, perm=perm_x, idx=host,
        op=op, stream=stream, tag="hB", after=_refs(last_a))
    full_a, last_b = _record_tier_ag(
        plan, window, mine_b, bshape, dtype, size=g, perm=perm_x, idx=host,
        stream=stream, tag="hB", entry=last_rs)
    out, _ = _record_tier_ag(
        plan, window, full_a, ashape, dtype, size=l, perm=perm_i, idx=local,
        stream=stream, tag="hC", entry=last_b)
    return out


def lower_ring_all_reduce(plan, window: str, source, axis: str, n: int, *,
                          shape, dtype, op: str = "sum", stream: int = 0,
                          label: str = ""):
    """Lower ``RmaPlan.ring_all_reduce``: the hierarchical pass under a
    non-degenerate ``g×l`` topology matching the axis, else the flat ring.
    Returns ``(out, hierarchical)``.  ``label`` is accepted and ignored, as
    the JAX package's is (the recorders emit their own labels)."""
    del label
    dshape, dt = tuple(shape), as_dtype(dtype)
    topo = plan.topology
    if (topo is not None and topo.axis_size == n
            and topo.hosts > 1 and topo.local > 1):
        return _record_hier_ring(plan, window, source, topo, dshape, dt,
                                 op=op, stream=stream), True
    return _record_ring_direction(plan, axis, n, source, dshape, dt,
                                  shift=1, stream=stream, window=window,
                                  op=op), False


_RING_PLANS: dict[tuple, object] = register_plan_cache("ring_collectives", {})


def all_reduce_plan(axis: str, n: int, shape, dtype, *, order: bool = True,
                    bidirectional: bool = False, declare_op: bool = True,
                    lent: bool = False, naive_flush: bool = False,
                    topology: Topology | None = None, backend: str = "rma"):
    """Build (or fetch from the build-once cache) the compiled ring
    all-reduce plan for one static configuration; ``shape`` is one rank's
    padded input shape.  ``topology`` with ``g > 1 and l > 1`` selects the
    hierarchical rewrite (the bidirectional split keeps flat directions);
    its fingerprint is part of the cache key.

    ``backend``: the lowering target (``"auto" | "rma" | "gspmd" |
    "interpret"``) threaded to :meth:`RmaPlan.compile`.  ``"auto"`` is
    resolved to a concrete target *before* the cache key is formed: the
    pick depends on the table on disk, and an environment-dependent
    decision must never be a cache key."""
    if backend == "auto":
        from repro_torch.core.rma.backends import costmodel as _costmodel

        backend = _costmodel.choose("ring")[0]
    dt = as_dtype(dtype)
    key = (axis, n, tuple(shape), str(dt), order, bidirectional, declare_op,
           lent, naive_flush, topology_fingerprint(topology), backend)
    if key in _RING_PLANS:
        return _RING_PLANS[key]
    plan = RmaPlan(f"rma_all_reduce[n={n}]", topology=topology)
    streams = (0, 1) if bidirectional else (0,)
    plan.window("ring", scope=SCOPE_THREAD, order=order,
                max_streams=len(streams),
                same_op="sum" if declare_op else None,
                accumulate_ops=("sum",), dtype=dt,
                entry_epoch=lent, exit_epoch=lent)
    plan.bind("x", tuple(shape), dt)
    if bidirectional:
        h = shape[0] // 2
        hshape = (h,) + tuple(shape[1:])
        lo = plan.compute(lambda env: env["x"][:, :h], shape=hshape, dtype=dt,
                          label="split:lo")
        hi = plan.compute(lambda env: env["x"][:, h:], shape=hshape, dtype=dt,
                          label="split:hi")
        lo_full = _record_ring_direction(plan, axis, n, lo, hshape, dt,
                                         shift=1, stream=0)
        hi_full = _record_ring_direction(plan, axis, n, hi, hshape, dt,
                                         shift=-1, stream=1)
        out = plan.compute(
            lambda env: torch.cat([env[lo_full], env[hi_full]], dim=1),
            reads=(lo_full, hi_full), shape=tuple(shape), dtype=dt,
            label="concat")
    else:
        out = plan.ring_all_reduce("ring", "x", axis, n, shape=tuple(shape),
                                   dtype=dt, op="sum", stream=0)
    plan.output("out", out)
    compiled = plan.compile(naive_flush=naive_flush, backend=backend)
    _RING_PLANS[key] = compiled
    return compiled


def plan_all_reduce(x: torch.Tensor, axis: str, axis_size: int, *,
                    order: bool = True, bidirectional: bool = False,
                    win: Window | None = None, declare_op: bool = True,
                    topology: Topology | None = None, backend: str = "rma",
                    donate: bool = False) -> torch.Tensor:
    """Plan-native one-sided ring all-reduce of the stacked ``x`` (``(n,
    ...)``): fetch the compiled schedule from the build-once cache and
    replay it.  ``win``: run on this lent window (its streams are flushed
    on entry and exit, as an MPI blocking collective would).  ``topology``
    ``None`` consults ``RMA_TOPOLOGY``.  ``donate=True`` lets the K5 ring
    reduce ``x`` in place.  ``backend``: the lowering target;
    ``"interpret"`` walks the same schedule on stacked tensors with no
    substrate (and cannot run on a lent window).  Returns the stacked
    result (under ``"gspmd"`` a broadcast view of the one sum)."""
    n = axis_size
    if x.shape[0] != n:
        raise ValueError(f"plan_all_reduce expects stacked input with "
                         f"leading dim {n}, got {tuple(x.shape)}")
    if n == 1:
        return x
    if backend == "interpret" and win is not None:
        raise ValueError(
            "backend='interpret' walks the schedule on stacked tensors and "
            "cannot run on a lent window")
    if topology is None:
        topology = default_topology(n)
    orig = x.shape[1]
    pad = (-orig) % (2 * n if bidirectional else n)
    if pad:
        x = torch.cat([x, x.new_zeros((n, pad) + tuple(x.shape[2:]))], dim=1)
        donate = True       # the padded copy is ours to overwrite
    compiled = all_reduce_plan(axis, n, x.shape[1:], x.dtype, order=order,
                               bidirectional=bidirectional,
                               declare_op=declare_op, lent=win is not None,
                               topology=topology, backend=backend)
    if backend == "interpret":
        out = compiled.interpret({"ring": torch.zeros_like(x)}, {"x": x},
                                 axis=axis).outputs["out"]
        return out[:, :orig] if pad else out
    streams = (0, 1) if bidirectional else (0,)
    if win is None:
        same_op = "sum" if declare_op else None
        acc_info = ({"same_op": same_op, "accumulate_ops": (same_op,)}
                    if same_op is not None else {})
        ring = Window.allocate(
            x.contiguous(), axis, n,
            WindowConfig(scope=SCOPE_THREAD, order=order,
                         max_streams=len(streams), **acc_info))
    else:
        if max(streams) >= win.config.max_streams:
            raise ValueError(
                f"ring needs streams {tuple(streams)} but the lent window "
                f"has max_streams={win.config.max_streams} (dup-immutable); "
                "allocate it with enough issue streams")
        ring = win
    res = compiled.execute({"ring": ring}, {"x": x},
                           donate=("x",) if donate else ())
    out = res.outputs["out"]
    return out[:, :orig] if pad else out


def rma_all_reduce(x: torch.Tensor, axis: str, axis_size: int, *,
                   order: bool = True, bidirectional: bool = False,
                   win: Window | None = None,
                   declare_op: bool = True) -> torch.Tensor:
    """One-sided ring all-reduce of the stacked ``x`` — the reference's
    imperative entry point, kept as a thin wrapper over
    :func:`plan_all_reduce` (same arguments, numerics and phases: 2(n−1)
    data phases under P2, plus a thread-scope flush before every dependent
    hop without it).

    .. deprecated:: emits a ``DeprecationWarning`` once per process; build
       the pattern with ``all_reduce_plan`` (or call ``plan_all_reduce``).
    """
    from repro_torch.core.rma.plan import warn_legacy_once

    warn_legacy_once("repro_torch.core.rma.rma_all_reduce",
                     "collectives.all_reduce_plan(...).execute (or "
                     "plan_all_reduce)")
    return plan_all_reduce(x, axis, axis_size, order=order,
                           bidirectional=bidirectional, win=win,
                           declare_op=declare_op)


# ---------------------------------------------------------------------------
# Producer/consumer put+signal (paper Listings 1 & 2)
# ---------------------------------------------------------------------------


def _flag_payload(win: Window, flag_value):
    """The flag's op on this window (its declared ``same_op``, else sum) and
    the stacked ``(n, k)`` flag payload (default: the op-aware value)."""
    flag_op = win.config.same_op if win.config.same_op is not None else "sum"
    if flag_value is None:
        one = acc_engine.default_flag_value(flag_op, win.buffer.dtype)
        # filled where the flag lands: no host-to-device copy
        flag_value = torch.full((win.axis_size, 1), one.item(),
                                dtype=one.dtype, device=win.buffer.device)
    return flag_op, flag_value.reshape(win.axis_size, -1)


def _put_then_signal(win: Window, data, perm, *, data_offset, flag_offset,
                     flag_value, stream, hold=None) -> Window:
    """The last put and its flag as one K4 launch, ordered on an
    ``order=True`` window and in the Listing-1 shape otherwise; ``hold``
    withholds the flag while that stall word is not 0."""
    win._check_stream(stream)
    flag_op, flag = _flag_payload(win, flag_value)
    path = acc_engine.route(flag_op, int(flag[0].numel()), win.buffer.dtype,
                            win.config)
    win.substrate.put_signal(
        data, perm, offset=data_offset, flag=flag, flag_offset=flag_offset,
        flag_op=flag_op, flag_path=path, stream=stream, shm=win._shm(perm),
        ordered=win.config.order, scope=win.config.scope, hold=hold)
    return win


def put_signal(win: Window, data: torch.Tensor, perm, *, data_offset=0,
               flag_offset: int, flag_value=None, stream: int = 0,
               after=None) -> Window:
    """Put the stacked ``data`` then raise a completion flag at the target.

    * ``win.config.order=True`` (paper Listing 2): the flag accumulate is
      chained behind the put on the ordered channel — no intermediate
      flush.  Phases: put 1 + flag 1 (2 on a hint-less window).
    * ``win.config.order=False`` (paper Listing 1): a full flush separates
      the put and the signal — 2 more phases, and on the card a grid-wide
      completion wait inside the launch.

    The flag is an accumulate routed through the engine: on a ``same_op``
    window it uses the declared op, and the default ``flag_value`` (stacked
    ``(n, 1)``) is op-aware (``accumulate.default_flag_value``; under
    ``prod``/``band`` the caller must pre-set the word).  Both halves run as
    one K4 launch.

    ``after``: a completion token of *another* window
    (:meth:`Window.completion_token`).  The whole put + signal is ordered
    behind it — cross-window notified access: a doorbell that must not
    overtake its data.  On the card the current CUDA stream waits for the
    token's event (no host synchronization), so the K4 launch may be issued
    on another stream than the token was taken on.  The token's family
    flushes with a bounded wait that counts a stall instead of hanging; K4
    reads that family's stall word, and while it is not 0 the data lands
    but the flag is withheld and counted in this window's ``stalls`` — no
    doorbell over transfers a flush gave up on.  It bills nothing: the
    ledger is that of the same call without ``after``."""
    hold = None
    if after is not None:
        if not isinstance(after, CompletionToken):
            raise TypeError(f"after= takes a window's completion token "
                            f"(Window.completion_token), got {type(after)}")
        after.wait()
        hold = after.stalls
    return _put_then_signal(win, data, perm, data_offset=data_offset,
                            flag_offset=flag_offset, flag_value=flag_value,
                            stream=stream, hold=hold)


def put_signal_pipelined(win: Window, data: torch.Tensor, perm, *,
                         chunks: int, data_offset: int = 0, flag_offset: int,
                         flag_value=None, stream: int = 0,
                         order: bool | None = None) -> Window:
    """Chunked put + single signal: chunk ``c`` of the stacked ``data``
    (split along dim 1) lands at ``data_offset + c * step``, back to back,
    and the flag chains behind the last chunk (P2) or behind a flush
    (without P2).  The last chunk and the flag are one K4 launch.

    ``order``: per-use override of the ordering info key, applied by
    duplicating the caller's window (P4) and handing back the caller's
    config over the updated substrate."""
    n = data.shape[1]
    if n % chunks:
        raise ValueError(f"data length {n} not divisible by chunks={chunks}")
    view = win if order is None else win.dup_with_info(order=order)
    step = n // chunks
    for c in range(chunks - 1):
        view = view.put(data[:, c * step:(c + 1) * step], perm,
                        offset=data_offset + c * step, stream=stream)
    view = _put_then_signal(view, data[:, (chunks - 1) * step:], perm,
                            data_offset=data_offset + (chunks - 1) * step,
                            flag_offset=flag_offset, flag_value=flag_value,
                            stream=stream)
    return view if order is None else dataclasses.replace(view,
                                                          config=win.config)


__all__ = ["ring_reduce_scatter", "ring_all_gather", "rma_all_reduce",
           "all_reduce_plan", "plan_all_reduce", "lower_ring_all_reduce",
           "put_signal", "put_signal_pipelined"]
