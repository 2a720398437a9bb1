"""One-sided all-to-all token exchange — the MoE dispatch collective.

The expert-parallel all-to-all is the pattern the paper's extensions were
designed for: many small peer-to-peer transfers, each followed by a
notification.  The exchange is recorded as a declarative plan:

* **header phase** — each origin publishes how many valid rows it sends to
  each peer with a ``fetch_op`` on a small control window (one atomic per
  peer); header words are indexed by ring shift, so the displacement is a
  static constant and ships no address word.
* **data phases** — the payload block for each peer is issued as
  ``chunks`` back-to-back transfers on a per-direction issue stream
  (forward shifts on stream 0, backward shifts on stream 1: P1 × P4).  With
  ``op`` set, every landing is an accumulate routed through the engine (the
  MoE combine direction).
* **doorbell** — after a peer's chunks, one accumulate raises that peer's
  doorbell word.  Under P2 (``order=True``) it chains behind the data with
  no flush; the undeclared baseline pays an ack epoch per peer.

On the card the last data transfer of each peer and its doorbell run as one
launch of kernel K4 (plain transfers) or K6 (sum landings); the planner
records that choice per pair (``CompiledPlan.lowering``) and bills both ops
exactly as op by op.

Layout: stacked.  ``x`` is ``(n, n*m, ...)`` — row r is rank r's payload,
whose rows ``[j*m, (j+1)*m)`` go to peer j — and the result's row r holds,
at ``[i*m, (i+1)*m)``, what peer i sent to rank r.  ``counts`` is ``(n,
n)``: ``counts[r, j]`` valid rows from r to j; the result's ``counts[r, i]``
is what peer i announced to r.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from repro_torch.core.rma.collectives import _place, _take, _zeros
from repro_torch.core.rma.plan import OpRef, RmaPlan, register_plan_cache
from repro_torch.core.rma.substrate import SCOPE_THREAD
from repro_torch.core.rma.topology import (Topology, default_topology,
                                           topology_fingerprint)
from repro_torch.core.rma.window import Window, WindowConfig
from repro_torch.kernels.common import as_dtype

I32 = torch.int32


def _refs(*xs):
    """The OpRefs among ``xs`` (binding names carry no ordering edge)."""
    return tuple(r for r in xs if isinstance(r, OpRef))


def hier_applies(topo: "Topology | None", n: int, *, chunks: int = 1,
                 op: str | None = None) -> bool:
    """Whether the hierarchical all-to-all rewrite fires: a non-degenerate
    ``g×l`` topology matching the axis, unchunked payloads, and a landing
    rule the relay preserves (plain puts or the declared ``"sum"``)."""
    return (topo is not None and topo.axis_size == n and topo.hosts > 1
            and topo.local > 1 and chunks == 1 and op in (None, "sum"))


class AllToAllResult(NamedTuple):
    """``data``: exchanged rows, block i from peer i.  ``counts``: valid-row
    count per source block (from the fetch_op header exchange).  ``bells``:
    per-source doorbell words — 1 for every remote peer whose notification
    landed (0 for self).  All stacked over the rank axis."""

    data: torch.Tensor
    counts: torch.Tensor
    bells: torch.Tensor


def _peer_stream(shift: int, n: int) -> int:
    """Forward half of the peer set on stream 0, backward half on stream 1."""
    return 0 if shift <= n // 2 else 1


def _by_source(env, words: torch.Tensor, n: int) -> torch.Tensor:
    """Re-index shift-addressed words by source rank: ``out[r, (r - j) %
    n] = words[r, j]``."""
    r = env.ranks[:, None]
    out = torch.zeros((n, n), dtype=I32, device=words.device)
    out[r, (r - torch.arange(n, device=words.device)[None]) % n] = \
        words.to(I32)
    return out


# ---------------------------------------------------------------------------
# The planned exchange
# ---------------------------------------------------------------------------


def _record_flat_a2a(plan, data_window: str, hdr_window: str, source, counts,
                     axis: str, n: int, *, shape, dtype, op, chunks):
    """Record the flat per-peer exchange plus the in-plan decode of the
    shift-addressed header words.  Returns ``(out, counts, bells)``."""
    del axis
    dt = as_dtype(dtype)
    m = shape[0] // n
    step = m // chunks
    pshape = (step,) + tuple(shape[1:])

    out = plan.compute(
        lambda env: _place(_zeros(env, shape, dt),
                           _take(env[source], env.ranks * m, m),
                           env.ranks * m),
        reads=_refs(source), shape=tuple(shape), dtype=dt, label="own-chunk")
    hdr_refs = []
    for k in range(1, n):
        s = _peer_stream(k, n)
        perm = tuple((i, (i + k) % n) for i in range(n))
        # header: publish this block's valid-row count at the target
        cnt = plan.compute(
            lambda env, k=k: env[counts][env.ranks,
                                         (env.ranks + k) % n][:, None],
            reads=_refs(counts), shape=(1,), dtype=I32,
            label=f"peer{k}:count")
        hdr_refs.append(plan.fetch_op(
            hdr_window, cnt, perm, op="sum", offset=k, stream=s, shape=(1,),
            dtype=I32, label=f"peer{k}:hdr"))
        # data: chunked one-sided transfers on the direction's stream
        last = None
        for c in range(chunks):
            pc = plan.compute(
                lambda env, k=k, c=c: _take(
                    env[source], ((env.ranks + k) % n) * m + c * step, step),
                reads=_refs(source), shape=pshape, dtype=dt,
                label=f"peer{k}:piece{c}")
            if op is None:
                last = plan.send(data_window, pc, perm, stream=s,
                                 shape=pshape, dtype=dt,
                                 label=f"peer{k}:data{c}")
            else:
                cur = plan.compute(
                    lambda env, o=out, k=k, c=c: _take(
                        env[o], ((env.ranks - k) % n) * m + c * step, step),
                    reads=(out,), shape=pshape, dtype=dt,
                    label=f"peer{k}:cur{c}")
                last = plan.hop(data_window, pc, cur, perm, op=op, stream=s,
                                shape=pshape, dtype=dt,
                                label=f"peer{k}:acc{c}")
            got = last
            out = plan.compute(
                lambda env, o=out, g=got, k=k, c=c: _place(
                    env[o], env[g], ((env.ranks - k) % n) * m + c * step),
                reads=(out, got), shape=tuple(shape), dtype=dt,
                label=f"peer{k}:out{c}")
        # doorbell: must not overtake the peer's data — a completion edge
        # the planner turns into a P2 chain, or an ack epoch per peer
        hdr_refs.append(plan.signal(
            hdr_window, perm, flag_offset=n + k, stream=s, after=(last,),
            label=f"peer{k}:bell"))

    def _counts(env):
        hdr = env.buffer(hdr_window)[:, :n].clone()
        hdr[:, 0] = env[counts][env.ranks, env.ranks]
        return _by_source(env, hdr, n)

    cnts = plan.compute(_counts, reads=_refs(counts), after=tuple(hdr_refs),
                        shape=(n,), dtype=I32, label="counts")
    bells = plan.compute(
        lambda env: _by_source(env, env.buffer(hdr_window)[:, n:2 * n], n),
        after=tuple(hdr_refs), shape=(n,), dtype=I32, label="bells")
    return out, cnts, bells


def _record_hier_a2a(plan, data_window: str, hdr_window: str, source, counts,
                     axis: str, n: int, *, shape, dtype, op):
    """The hierarchical rewrite: intra-node redistribution → one exchange
    per host shift.

    Stage 1 (shared-memory tier) re-sorts blocks by destination local index:
    for every local shift k the rank hands its same-host peer ``(h, j+k)``
    the g blocks addressed to that peer's local index, with their count
    words.  Stage 2 crosses the network once per host shift k2: one send
    carrying the l blocks bound for host ``(h+k2) % g`` and one doorbell
    whose ``(l+1,)`` payload piggybacks the relayed counts behind the
    arrival flag — exactly ``2(g−1)`` inter-node phases.  The header window
    completes by doorbell (no exit epoch)."""
    del axis
    topo = plan.topology
    g, l = topo.hosts, topo.local
    dt = as_dtype(dtype)
    m = shape[0] // n
    gshape = (g * m,) + tuple(shape[1:])
    lshape = (l * m,) + tuple(shape[1:])

    def host(env):
        return env.ranks // l

    def loc(env):
        return env.ranks % l

    def lane_gather(env, k):
        tgt = (loc(env) + k) % l
        return torch.cat([_take(env[source], (h2 * l + tgt) * m, m)
                          for h2 in range(g)], dim=1)

    def lane_counts(env, k):
        tgt = (loc(env) + k) % l
        return torch.stack([env[counts][env.ranks, h2 * l + tgt]
                            for h2 in range(g)], dim=1)

    # Stage 1: lanes[k] holds the g blocks sourced from same-host peer
    # (h, (j-k) % l) and destined to local index j (lane 0: own, local)
    lanes = [plan.compute(lambda env: lane_gather(env, 0), reads=_refs(source),
                          shape=gshape, dtype=dt, label="h1:lane0")]
    lane_cnt = [plan.compute(lambda env: lane_counts(env, 0),
                             reads=_refs(counts), shape=(g,), dtype=I32,
                             label="h1:lanecnt0")]
    for k in range(1, l):
        perm = topo.intra_ring_perm(k)
        dk = plan.compute(lambda env, k=k: lane_gather(env, k),
                          reads=_refs(source), shape=gshape, dtype=dt,
                          label=f"h1:gather{k}")
        ck = plan.compute(lambda env, k=k: lane_counts(env, k),
                          reads=_refs(counts), shape=(g,), dtype=I32,
                          label=f"h1:gathercnt{k}")
        lanes.append(plan.send(data_window, dk, perm, stream=0, shape=gshape,
                               dtype=dt, label=f"h1:relay{k}"))
        lane_cnt.append(plan.send(hdr_window, ck, perm, stream=0, shape=(g,),
                                  dtype=I32, label=f"h1:relaycnt{k}"))

    # Stage 2: one exchange per host shift, data + doorbell-with-counts
    recv2, sigs = [], []
    for k2 in range(1, g):
        perm = topo.inter_ring_perm(k2)
        pay = plan.compute(
            lambda env, k2=k2: torch.cat(
                [_take(env[lk], ((host(env) + k2) % g) * m, m)
                 for lk in lanes], dim=1),
            reads=_refs(*lanes), shape=lshape, dtype=dt, label=f"h2:pay{k2}")
        if op is None:
            got = plan.send(data_window, pay, perm, stream=0, shape=lshape,
                            dtype=dt, label=f"h2:data{k2}")
        else:
            # combine direction: land through the accumulate engine into
            # zeroed slots, so the declared op reproduces the put numerics
            cur = plan.compute(lambda env: _zeros(env, lshape, dt),
                               shape=lshape, dtype=dt, label=f"h2:cur{k2}")
            got = plan.hop(data_window, pay, cur, perm, op=op, stream=0,
                           shape=lshape, dtype=dt, label=f"h2:acc{k2}")
        recv2.append(got)
        cpay = plan.compute(
            lambda env, k2=k2: torch.cat(
                [torch.ones((env.n, 1), dtype=I32, device=env.ranks.device)]
                + [env[ck][env.ranks, (host(env) + k2) % g][:, None]
                   for ck in lane_cnt], dim=1),
            reads=_refs(*lane_cnt), shape=(l + 1,), dtype=I32,
            label=f"h2:cnt{k2}")
        sigs.append(plan.signal(
            hdr_window, perm, flag_offset=(k2 - 1) * (l + 1), value=cpay,
            stream=0, after=(got,), label=f"h2:bell{k2}"))

    def sources(env):
        """(source rank of every (k2, k) block) for the assembly/decode."""
        hh, jj = host(env), loc(env)
        intra = {k: hh * l + (jj - k) % l for k in range(1, l)}
        inter = {(k2, k): ((hh - k2) % g) * l + (jj - k) % l
                 for k2 in range(1, g) for k in range(l)}
        return intra, inter

    def assemble(env):
        r = env.ranks
        out = _place(_zeros(env, shape, dt), _take(env[source], r * m, m),
                     r * m)
        intra, inter = sources(env)
        for k in range(1, l):
            out = _place(out, _take(env[lanes[k]], host(env) * m, m),
                         intra[k] * m)
        for (k2, k), src in inter.items():
            out = _place(out, env[recv2[k2 - 1]][:, k * m:(k + 1) * m],
                         src * m)
        return out

    out = plan.compute(assemble, reads=_refs(source, *lanes, *recv2),
                       shape=tuple(shape), dtype=dt, label="h:out")

    def decode_counts(env):
        r, hdr = env.ranks, env.buffer(hdr_window)
        cvec = torch.zeros((n, n), dtype=I32, device=r.device)
        cvec[r, r] = env[counts][r, r]
        intra, inter = sources(env)
        for k in range(1, l):
            cvec[r, intra[k]] = env[lane_cnt[k]][r, host(env)]
        for (k2, k), src in inter.items():
            cvec[r, src] = hdr[:, (k2 - 1) * (l + 1) + 1 + k].to(I32)
        return cvec

    def decode_bells(env):
        r, hdr = env.ranks, env.buffer(hdr_window)
        bvec = torch.zeros((n, n), dtype=I32, device=r.device)
        intra, inter = sources(env)
        for k in range(1, l):
            # shared-memory arrival: the relayed counts came in-plan, so
            # the bell is a constant
            bvec[r, intra[k]] = 1
        for (k2, k), src in inter.items():
            bvec[r, src] = hdr[:, (k2 - 1) * (l + 1)].to(I32)
        return bvec

    cnts = plan.compute(decode_counts, reads=_refs(counts, *lane_cnt),
                        after=tuple(sigs), shape=(n,), dtype=I32,
                        label="h:counts")
    bells = plan.compute(decode_bells, reads=_refs(*lane_cnt),
                         after=tuple(sigs), shape=(n,), dtype=I32,
                         label="h:bells")
    return out, cnts, bells


def lower_all_to_all(plan, data_window: str, hdr_window: str, source, counts,
                     axis: str, n: int, *, shape, dtype, op: str | None = None,
                     chunks: int = 1):
    """Lower ``RmaPlan.all_to_all``: the hierarchical two-stage relay when
    :func:`hier_applies` under the plan's declared topology, otherwise the
    flat per-peer exchange.  Returns ``(out, counts, bells)`` OpRefs."""
    if hier_applies(plan.topology, n, chunks=chunks, op=op):
        return _record_hier_a2a(plan, data_window, hdr_window, source, counts,
                                axis, n, shape=tuple(shape), dtype=dtype,
                                op=op)
    return _record_flat_a2a(plan, data_window, hdr_window, source, counts,
                            axis, n, shape=tuple(shape), dtype=dtype, op=op,
                            chunks=chunks)


_A2A_PLANS: dict[tuple, object] = register_plan_cache("moe_alltoall", {})


def all_to_all_plan(axis: str, n: int, shape, dtype, *, chunks: int = 1,
                    order: bool = True, declare: bool = True,
                    op: str | None = None, lent: bool = False,
                    naive_flush: bool = False,
                    topology: Topology | None = None,
                    backend: str = "rma"):
    """Build (or fetch from the build-once cache) the compiled all-to-all
    plan for one static configuration.  ``shape`` is one rank's ``(n*m,
    ...)`` payload shape.  Per peer: one fetch_op count header, ``chunks``
    data transfers on the direction's stream, and a doorbell ordered behind
    the data.  ``topology`` with ``g > 1 and l > 1`` records the
    hierarchical relay; its fingerprint is part of the cache key.

    ``backend``: the lowering target (``"auto" | "rma" | "gspmd" |
    "interpret"``) threaded to :meth:`RmaPlan.compile`.  ``"auto"`` is
    resolved to a concrete target *before* the cache key is formed: the
    pick depends on the table on disk, and an environment-dependent
    decision must never be a cache key."""
    if backend == "auto":
        from repro_torch.core.rma.backends import costmodel as _costmodel

        backend = _costmodel.choose("a2a")[0]
    dt = as_dtype(dtype)
    key = (axis, n, tuple(shape), str(dt), chunks, order, declare, op, lent,
           naive_flush, topology_fingerprint(topology), backend)
    if key in _A2A_PLANS:
        return _A2A_PLANS[key]
    streams = (0, 1) if n > 2 else (0,)
    data_op = op if (op is not None and declare) else None
    hier = hier_applies(topology, n, chunks=chunks, op=op)
    plan = RmaPlan(f"rma_all_to_all[n={n},chunks={chunks}]",
                   topology=topology)
    plan.window("data", scope=SCOPE_THREAD, order=order,
                max_streams=len(streams), same_op=data_op,
                accumulate_ops=(op,) if op is not None else ("sum",),
                dtype=dt, entry_epoch=lent, exit_epoch=lent)
    plan.window("hdr", scope=SCOPE_THREAD, order=order,
                max_streams=len(streams),
                same_op="sum" if declare else None, accumulate_ops=("sum",),
                dtype=I32, exit_epoch=not hier)
    plan.bind("x", tuple(shape), dt)
    plan.bind("counts", (n,), I32)
    out, cnts, bells = plan.all_to_all("data", "hdr", "x", "counts", axis, n,
                                       shape=tuple(shape), dtype=dt, op=op,
                                       chunks=chunks)
    plan.output("out", out)
    plan.output("counts", cnts)
    plan.output("bells", bells)
    compiled = plan.compile(naive_flush=naive_flush, backend=backend)
    _A2A_PLANS[key] = compiled
    return compiled


#: (start, end) CUDA events of every exchange while :func:`timed_exchanges`
#: is active, else None
_timing: list | None = None


@contextlib.contextmanager
def timed_exchanges(enabled: bool = True):
    """Record a pair of CUDA events around every exchange replayed on the
    card inside the ``with`` block; yields the list of pairs (empty when
    ``enabled`` is False)."""
    global _timing
    outer, pairs = _timing, []
    _timing = pairs if enabled else None
    try:
        yield pairs
    finally:
        _timing = outer


def _exchange(x: torch.Tensor, counts: torch.Tensor, spec: tuple,
              win: Window | None = None):
    """Replay the cached plan on stacked ``x`` (no autograd); returns the
    plan's result."""
    timing = _timing if x.is_cuda else None
    if timing is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    res = _replay(x, counts, spec, win)
    if timing is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        timing.append((start, end))
    return res


def _replay(x: torch.Tensor, counts: torch.Tensor, spec: tuple,
            win: Window | None = None):
    axis, n, chunks, order, declare, op, topology, backend = spec
    compiled = all_to_all_plan(axis, n, x.shape[1:], x.dtype, chunks=chunks,
                               order=order, declare=declare, op=op,
                               lent=win is not None, topology=topology,
                               backend=backend)
    if backend == "interpret":
        return compiled.interpret(
            {"data": torch.zeros_like(x),
             "hdr": torch.zeros((n, 2 * n), dtype=I32, device=x.device)},
            {"x": x, "counts": counts}, axis=axis)
    streams = (0, 1) if n > 2 else (0,)
    hdr = Window.allocate(
        torch.zeros((n, 2 * n), dtype=I32, device=x.device), axis, n,
        WindowConfig(scope=SCOPE_THREAD, order=order,
                     max_streams=len(streams),
                     same_op="sum" if declare else None,
                     accumulate_ops=("sum",)))
    if win is not None:
        if max(streams) >= win.config.max_streams:
            raise ValueError(
                f"exchange needs streams {tuple(streams)} but the lent "
                f"window has max_streams={win.config.max_streams} "
                "(dup-immutable); allocate it with enough issue streams")
        data = win
    else:
        data_op = op if (op is not None and declare) else None
        acc_info = ({"same_op": data_op, "accumulate_ops": (data_op,)}
                    if data_op is not None else {})
        data = Window.allocate(
            x, axis, n, WindowConfig(scope=SCOPE_THREAD, order=order,
                                     max_streams=len(streams), **acc_info))
    return compiled.execute({"data": data, "hdr": hdr},
                            {"x": x, "counts": counts})


class _AllToAll(torch.autograd.Function):
    """The exchange's data output under autograd.  The block exchange is
    its own transpose — block (r → i) of the input lands at block (i ← r)
    of the output — so the backward is the same declared all-to-all on the
    cotangent, replayed on the port's kernels.  Nothing is saved for the
    backward, so no saved tensor aliases a window a later exchange
    overwrites."""

    @staticmethod
    def forward(ctx, x, counts, spec, win):
        res = _exchange(x.detach().contiguous(), counts, spec, win)
        ctx.spec = spec
        cnts, bells = res.outputs["counts"], res.outputs["bells"]
        ctx.mark_non_differentiable(cnts, bells)
        return res.outputs["out"], cnts, bells

    @staticmethod
    def backward(ctx, grad, _gc, _gb):
        n, m = grad.shape[0], grad.shape[1] // ctx.spec[1]
        full = torch.full((n, n), m, dtype=I32, device=grad.device)
        res = _exchange(grad.contiguous(), full, ctx.spec)
        return res.outputs["out"], None, None, None


def plan_all_to_all(x: torch.Tensor, axis: str, axis_size: int, *,
                    counts: torch.Tensor | None = None, chunks: int = 1,
                    order: bool = True, declare: bool = True,
                    op: str | None = None, win: Window | None = None,
                    topology: Topology | None = None,
                    backend: str = "rma") -> AllToAllResult:
    """Plan-native one-sided all-to-all of the stacked ``x`` (``(axis_size,
    axis_size*m, ...)``; ``counts`` stacked ``(axis_size, axis_size)``,
    default ``m`` everywhere): replay the cached compiled schedule and
    return the stacked :class:`AllToAllResult`.  The data output is
    differentiable (its backward is the same exchange).

    ``order``: P2 — doorbells chain behind their data with no flush.
    ``declare``: declare ``same_op="sum"`` on the control window (and, with
    ``op``, on the data view).  ``op``: land data as accumulates (the MoE
    combine).  ``win``: lend a window's substrate for the data phases.
    ``topology``: ``None`` consults ``RMA_TOPOLOGY``; a non-degenerate one
    replays the hierarchical relay.  ``backend``: the lowering target;
    ``"interpret"`` walks the same schedule on stacked tensors with no
    substrate (and cannot run on a lent window)."""
    n = axis_size
    if backend == "interpret" and win is not None:
        raise ValueError(
            "backend='interpret' walks the schedule on stacked tensors and "
            "cannot run on a lent window")
    if topology is None:
        topology = default_topology(n)
    if x.dim() < 2 or x.shape[0] != n:
        raise ValueError(
            f"plan_all_to_all expects stacked input with leading dim {n} "
            f"(one slot per rank), got shape {tuple(x.shape)}")
    if x.shape[1] % n:
        raise ValueError(
            f"per-rank leading dim {x.shape[1]} not divisible by axis "
            f"size {n}")
    m = x.shape[1] // n
    if m % chunks:
        raise ValueError(f"per-peer rows {m} not divisible by chunks={chunks}")
    if counts is None:
        counts = torch.full((n, n), m, dtype=I32, device=x.device)
    if tuple(counts.shape) != (n, n):
        raise ValueError(f"stacked counts must have shape ({n}, {n}), got "
                         f"{tuple(counts.shape)}")
    counts = counts.to(device=x.device, dtype=I32)
    if n == 1:
        return AllToAllResult(x, counts, torch.zeros((1, 1), dtype=I32,
                                                     device=x.device))
    spec = (axis, n, chunks, order, declare, op, topology, backend)
    return AllToAllResult(*_AllToAll.apply(x, counts, spec, win))


def rma_all_to_all(x: torch.Tensor, axis: str, axis_size: int, *,
                   counts: torch.Tensor | None = None, chunks: int = 1,
                   order: bool = True, declare: bool = True,
                   op: str | None = None, win: Window | None = None
                   ) -> AllToAllResult:
    """One-sided all-to-all of the stacked ``x`` — the reference's
    imperative entry point, kept as a thin wrapper over
    :func:`plan_all_to_all` (same arguments, same numerics and phases).

    .. deprecated:: emits a ``DeprecationWarning`` once per process; build
       the pattern with ``all_to_all_plan`` (or call ``plan_all_to_all``).
    """
    from repro_torch.core.rma.plan import warn_legacy_once

    warn_legacy_once("repro_torch.core.rma.rma_all_to_all",
                     "alltoall.all_to_all_plan(...).execute (or "
                     "plan_all_to_all)")
    return plan_all_to_all(x, axis, axis_size, counts=counts, chunks=chunks,
                           order=order, declare=declare, op=op, win=win)


__all__ = ["rma_all_to_all", "plan_all_to_all", "all_to_all_plan",
           "lower_all_to_all", "hier_applies", "AllToAllResult",
           "timed_exchanges"]
