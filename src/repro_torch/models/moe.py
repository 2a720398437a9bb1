"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

``ep_mode="gspmd"`` is the JAX package's single-program dispatch: route,
sort the T·k assignments by expert, scatter into a dense ``(E, C, d)``
buffer (capacity C, drops beyond), batched expert matmuls, gather back and
combine with the gates (:func:`combine_sorted`: each token's terms in a
fixed order, so the card's result does not depend on atomics' timing).

``ep_mode="rma"`` is the expert-parallel path over ``ep_ranks`` stacked
ranks (the mesh axis of the JAX package, explicit here as ``dp_ranks`` is
for the gradient ring): tokens are split over the ranks, each rank packs
its assignments per destination rank (first-level sort), the dispatch rides
:func:`repro_torch.core.rma.alltoall.plan_all_to_all` (count headers,
per-peer transfers, P2-chained doorbells — one K4 launch per peer on the
card), receivers run the second-level sort into their local ``(E/n, C, d)``
buffer, and the combine returns through the same collective with
``op="sum"`` (one K6 launch per peer).  Rank r holds experts
``[r·E/n, (r+1)·E/n)``.  Where the JAX package sums routing statistics with
``lax.psum``, the port sums over the rank axis; where it scatters with
``.at[...].set(mode="drop")``, the port scatters into a dump row that is cut
off.

Shared experts are dense SwiGLU applied to every token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding import logical_constraint


def init_moe(gen, cfg, device) -> dict:
    mo = cfg.moe
    d = cfg.d_model
    pd = cfg.parameter_dtype
    p = {
        "router": layers.trunc_normal(gen, (d, mo.num_experts), 1.0,
                                      torch.float32, device),
        "wi": layers.trunc_normal(gen, (mo.num_experts, d, 2 * mo.d_ff_expert),
                                  1.0, pd, device),
        "wo": layers.trunc_normal(gen, (mo.num_experts, mo.d_ff_expert, d),
                                  1.0, pd, device),
    }
    if mo.n_shared:
        p["shared"] = layers.init_swiglu(gen, d, mo.d_ff_shared, pd, device)
    return p


def moe_spec(cfg) -> dict:
    p = {
        "router": ("embed", None),
        "wi": ("expert", "embed", "mlp_expert"),
        "wo": ("expert", "mlp_expert", "embed"),
    }
    if cfg.moe.n_shared:
        p["shared"] = layers.swiglu_spec()
    return p


#: the leaves :func:`_experts` reads cast whole to the compute dtype (the
#: router is read in float32; the shared expert is a SwiGLU,
#: ``layers.SWIGLU_COMPUTE_DTYPE``)
MOE_COMPUTE_DTYPE = frozenset({"wi", "wo"})


def _route(xt: torch.Tensor, router: torch.Tensor, mo):
    """Router probabilities, top-k gates and expert ids (float32)."""
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, mo.top_k, dim=-1)
    if mo.renorm_gates:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, eidx


def _experts(buf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, dt
             ) -> torch.Tensor:
    """Batched expert SwiGLU over ``buf`` (..., E, C, d) with weights (...,
    E, d, 2ff) and (..., E, ff, d), in the compute dtype ``dt``."""
    h = torch.matmul(buf.to(dt), wi.to(dt))
    gate_h, up_h = h.chunk(2, dim=-1)
    h = F.silu(gate_h.float()).to(dt) * up_h
    return torch.matmul(h, wo.to(dt))


def combine_sorted(vals: torch.Tensor, order: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """Sum each token's ``k`` assignment results: ``vals`` (..., T·k, d)
    holds them in the dispatch's sorted order (``order`` (..., T·k), the
    stable argsort that sorted the flat assignments; leading dims are
    ranks).  A token's terms are added in float32 one at a time in that
    order and the sum is rounded to ``vals.dtype`` once — what
    ``index_add`` computes on the CPU, but in a fixed order on the card
    too, where ``index_add`` adds with atomics in whatever order they
    land."""
    pos = torch.argsort(order, dim=-1)
    pos = pos.view(pos.shape[:-1] + (-1, k)).sort(dim=-1).values.flatten(-2)
    parts = torch.take_along_dim(vals, pos[..., None], dim=-2)
    parts = parts.view(pos.shape[:-1] + (-1, k, vals.shape[-1]))
    out = parts[..., 0, :].float()       # (..., T, k, d): each token's terms
    for j in range(1, k):
        out = out + parts[..., j, :]
    return out.to(vals.dtype)


def moe_apply(params: dict, x: torch.Tensor, cfg, *, return_aux: bool = False,
              ep_mode: str | None = None, ep_ranks: int = 1):
    """Apply the MoE layer to ``x`` (B, S, d).  Returns ``(out, aux)``.

    ``ep_mode``: per-call override of ``cfg.moe.ep_mode`` — ``"gspmd"``
    (single-program dispatch) or ``"rma"`` (expert-parallel over
    ``ep_ranks`` stacked ranks through the one-sided all-to-all; with
    ``ep_ranks == 1`` the exchanges are identity).  ``ep_ranks`` must
    divide ``num_experts``."""
    del return_aux
    mode = ep_mode if ep_mode is not None else cfg.moe.ep_mode
    if mode not in ("gspmd", "rma"):
        raise ValueError(f"unknown ep_mode {mode!r}; expected 'gspmd' or 'rma'")
    if mode == "rma":
        return _moe_apply_rma(params, x, cfg, ep_ranks)
    mo = cfg.moe
    B, S, d = x.shape
    dt = x.dtype
    T = B * S
    E, k = mo.num_experts, mo.top_k
    xt = x.reshape(T, d)

    probs, gates, eidx = _route(xt, params["router"], mo)
    # load-balancing auxiliary loss (Switch-style)
    density = torch.zeros(E, dtype=torch.float32, device=x.device).index_add(
        0, eidx.reshape(-1), torch.ones(T * k, device=x.device)) / (T * k)
    aux = E * torch.sum(density * probs.mean(dim=0))

    # sort-based dispatch
    C = mo.capacity(T)
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tok_of = order // k
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    pos_in_e = torch.arange(T * k, device=x.device) - starts[sorted_e]
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e, E * C)   # E*C: dropped

    buf = xt.new_zeros((E * C + 1, d)).index_put((dest,), xt[tok_of])
    buf = buf[:E * C].reshape(E, C, d)
    buf = logical_constraint(buf, "expert", None, "embed")
    yb = _experts(buf, params["wi"], params["wo"], dt)
    yb = logical_constraint(yb, "expert", None, "embed")

    y_flat = yb.reshape(E * C, d)
    safe_dest = torch.where(keep, dest, 0)
    y_sorted = y_flat[safe_dest] * keep[:, None].to(dt)
    gates_sorted = gates.reshape(-1)[order].to(dt)
    out = combine_sorted(y_sorted * gates_sorted[:, None], order, k)
    if mo.n_shared:
        out = out + layers.swiglu(xt, params["shared"])
    return out.reshape(B, S, d), aux


def _pair_capacity(mo, tokens_local: int, n: int) -> int:
    """Row capacity of one (source rank → destination rank) exchange block:
    the expected per-peer share of the local assignments scaled by the
    capacity factor, rounded up to 8 and capped at the all-to-one-peer
    worst case.  Under a tight ``capacity_factor`` with skewed routing this
    drops assignments the gspmd path would deliver (the JAX package's
    trade, kept)."""
    c = math.ceil(tokens_local * mo.top_k * mo.capacity_factor / n)
    return min(tokens_local * mo.top_k, max(8, -(-c // 8) * 8))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank row gather: ``out[r, i] = x[r, idx[r, i]]``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _scatter_rows(shape, idx: torch.Tensor, vals: torch.Tensor,
                  dtype) -> torch.Tensor:
    """``zeros(shape)`` with ``out[r, idx[r, i]] = vals[r, i]``; an index
    equal to ``shape[1]`` lands in a dump row that is cut off (the JAX
    package's ``mode="drop"``)."""
    n, rows = shape[0], shape[1]
    buf = torch.zeros((n, rows + 1) + tuple(shape[2:]), dtype=dtype,
                      device=vals.device)
    ar = torch.arange(n, device=vals.device)[:, None]
    return buf.index_put((ar.expand_as(idx), idx), vals.to(dtype))[:, :rows]


def _moe_ep_shard(params: dict, xt: torch.Tensor, cfg, *, n: int,
                  t_valid: int | None = None):
    """The expert-parallel MoE over stacked ranks: ``xt`` is ``(n, Tl, d)``,
    row r rank r's tokens.  Route → first-level (per-destination) sort →
    ``plan_all_to_all`` dispatch → second-level (per-local-expert) sort →
    expert matmuls → ``op="sum"`` all-to-all combine → gate-weighted merge.
    ``t_valid``: global count of real tokens — rows past it are
    divisibility padding, excluded from statistics, dispatch and capacity.
    Returns ``(out (n, Tl, d), aux)``."""
    from repro_torch.core.rma.alltoall import plan_all_to_all
    from repro_torch.core.rma.topology import default_topology

    mo = cfg.moe
    ep_backend = mo.ep_backend
    if ep_backend not in ("auto", "rma", "gspmd"):
        raise ValueError(
            f"ep_backend={ep_backend!r} invalid for the expert-parallel "
            "dispatch; expected 'auto', 'rma', or 'gspmd'")
    topo = default_topology(n) if n > 1 else None
    _, Tl, d = xt.shape
    dev = xt.device
    E, k = mo.num_experts, mo.top_k
    El = E // n
    T = Tl * n if t_valid is None else t_valid
    ranks = torch.arange(n, device=dev)
    tok_ok = (ranks[:, None] * Tl + torch.arange(Tl, device=dev)[None]) < T

    # routing (float32); aux from the statistics of all ranks
    probs, gates, eidx = _route(xt, params["router"], mo)
    w = tok_ok.float()
    density = torch.zeros(E, dtype=torch.float32, device=dev).index_add(
        0, eidx.reshape(-1), w[..., None].expand(n, Tl, k).reshape(-1))
    prob_sum = (probs * w[..., None]).sum(1).sum(0)
    aux = E * torch.sum((density / (T * k)) * (prob_sum / T))

    # first-level sort: pack assignments per destination rank
    Cp = _pair_capacity(mo, Tl, n)
    L = Tl * k
    flat_e = eidx.reshape(n, L)
    dd = torch.where(tok_ok.repeat_interleave(k, dim=1), flat_e // El, n)
    send_order = torch.argsort(dd, dim=1, stable=True)
    sorted_dd = torch.gather(dd, 1, send_order)
    tok_of = send_order // k
    starts = torch.searchsorted(
        sorted_dd, torch.arange(n + 1, device=dev).expand(n, n + 1)
        .contiguous())
    pos_in_d = torch.arange(L, device=dev)[None] - torch.gather(
        starts, 1, sorted_dd)
    keep_s = (pos_in_d < Cp) & (sorted_dd < n)
    slot = torch.where(keep_s, sorted_dd * Cp + pos_in_d, n * Cp)
    send_counts = torch.clamp(starts[:, 1:] - starts[:, :-1],
                              max=Cp).to(torch.int32)
    # payload rows: [token features | local expert id].  The wire dtype is
    # the model dtype; the id column must stay exact, so wide expert counts
    # fall back to float32 (bf16 holds integers to 256, f16 to 2048).
    id_exact = {torch.bfloat16: 256, torch.float16: 2048}
    wire_dt = (torch.float32 if El > id_exact.get(xt.dtype, 2 ** 24)
               else xt.dtype)
    eid_local = torch.gather(flat_e % El, 1, send_order).to(wire_dt)
    rows = torch.cat([_rows(xt, tok_of).to(wire_dt), eid_local[..., None]],
                     dim=-1)
    payload = _scatter_rows((n, n * Cp, d + 1), slot, rows, wire_dt)

    # dispatch: the declared one-sided all-to-all
    if n > 1:
        res = plan_all_to_all(payload, "expert", n, counts=send_counts,
                              order=True, declare=True, topology=topo,
                              backend=ep_backend)
        recv, recv_counts = res.data, res.counts
    else:
        recv, recv_counts = payload, send_counts

    # second-level sort: received rows -> local (El, C, d) buffer
    C = mo.capacity(T)
    R = n * Cp
    j = torch.arange(R, device=dev)
    slot_src = j // Cp
    valid = (j % Cp)[None] < recv_counts[:, slot_src]
    re = torch.where(valid, recv[..., d].detach().to(torch.int64), El)
    order2 = torch.argsort(re, dim=1, stable=True)
    sorted_re = torch.gather(re, 1, order2)
    starts2 = torch.searchsorted(
        sorted_re, torch.arange(El + 1, device=dev).expand(n, El + 1)
        .contiguous())
    pos2 = j[None] - torch.gather(starts2, 1, torch.clamp(sorted_re, max=El))
    keep2 = (sorted_re < El) & (pos2 < C)
    dest2 = torch.where(keep2, sorted_re * C + pos2, El * C)
    buf = _scatter_rows((n, El * C, d), dest2,
                        _rows(recv[..., :d], order2), torch.float32)
    buf = buf.reshape(n, El, C, d)

    # local experts: rank r holds experts [r*El, (r+1)*El)
    dt = xt.dtype
    wi = params["wi"].reshape((n, El) + tuple(params["wi"].shape[1:]))
    wo = params["wo"].reshape((n, El) + tuple(params["wo"].shape[1:]))
    yb = _experts(buf, wi, wo, dt).float()

    # back to exchange-slot order and home to the origins
    y_flat = yb.reshape(n, El * C, d)
    y_sorted = _rows(y_flat, torch.where(keep2, dest2, 0)) * keep2[..., None]
    y_back = _scatter_rows((n, R, d), order2, y_sorted, wire_dt)
    if n > 1:
        y_ret = plan_all_to_all(y_back, "expert", n, counts=recv_counts,
                                op="sum", order=True, declare=True,
                                topology=topo, backend=ep_backend).data
    else:
        y_ret = y_back

    # combine: the origin weighs each assignment's result by its gate
    y_assign = (_rows(y_ret, torch.where(keep_s, slot, 0)).float()
                * keep_s[..., None])
    gates_sorted = torch.gather(gates.reshape(n, L), 1, send_order)
    out = combine_sorted(y_assign * gates_sorted[..., None], send_order, k)
    return out.to(xt.dtype), aux


def _moe_apply_rma(params: dict, x: torch.Tensor, cfg, n: int):
    """The ``ep_mode="rma"`` entry: split the tokens over ``n`` stacked
    expert-parallel ranks (padding to a multiple of n) and run
    :func:`_moe_ep_shard`; the shared expert is added to every token."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    if n < 1 or mo.num_experts % n:
        raise ValueError(
            f"ep_mode='rma' needs num_experts={mo.num_experts} divisible by "
            f"ep_ranks={n}")
    pad = (-T) % n
    xt_in = torch.cat([xt, xt.new_zeros((pad, d))]) if pad else xt
    out, aux = _moe_ep_shard(params, xt_in.reshape(n, -1, d), cfg, n=n,
                             t_valid=T if pad else None)
    out = out.reshape(-1, d)[:T]
    if mo.n_shared:
        out = out + layers.swiglu(xt, params["shared"])
    return out.reshape(B, S, d), aux


def moe_ref(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Oracle: dense per-token loop over selected experts (no capacity
    drops)."""
    mo = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    _, gates, eidx = _route(xt, params["router"], mo)
    out = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    for e in range(mo.num_experts):
        y = _experts(xt, params["wi"][e], params["wo"][e], xt.dtype)
        w_e = torch.where(eidx == e, gates, 0.0).sum(-1)
        out = out + y.float() * w_e[:, None]
    if mo.n_shared:
        out = out + layers.swiglu(xt, params["shared"]).float()
    return out.reshape(B, S, d).to(x.dtype)


__all__ = ["init_moe", "moe_spec", "moe_apply", "moe_ref",
           "MOE_COMPUTE_DTYPE"]
