"""Plain-PyTorch oracles: the materialized-softmax attention oracle, the
exact sequential SSD recurrence, and the RMA kernels' oracles in the stacked
``(n, ...)`` layout (row r = rank r's shard).  Each mirrors one kernel's
contract."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import is_integer

NEG_INF = -2.0**30


def flash_attention_ref(q, k, v, *, causal=True, sm_scale=None):
    """q/k/v (B, H, S, hd) — materialized-softmax oracle."""
    hd = q.shape[-1]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, s.new_full((), NEG_INF))
    w = torch.softmax(s, dim=-1)
    return (w @ v.float()).to(q.dtype)


def ssd_scan_ref(xdt, a, Bm, Cm, *, initial_state=None):
    """Sequential SSD recurrence (exact, O(L) steps): xdt (B, L, H, P), a
    (B, L, H), Bm/Cm (B, L, N) → (y (B, L, H, P), final state (B, H, P,
    N)), both in xdt's dtype — the JAX package's ``models.ssm.ssd_ref``."""
    b, length, h, p = xdt.shape
    n = Bm.shape[-1]
    state = (initial_state.float() if initial_state is not None else
             xdt.new_zeros((b, h, p, n), dtype=torch.float32))
    ys = []
    for t in range(length):
        decay = torch.exp(a[:, t].float())                       # (B, H)
        state = state * decay[:, :, None, None] + (
            xdt[:, t].float()[..., None] * Bm[:, t].float()[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t].float()))
    return torch.stack(ys, 1).to(xdt.dtype), state.to(xdt.dtype)


def accumulate_ref(buffer: torch.Tensor, update: torch.Tensor, *,
                   op: str = "sum") -> torch.Tensor:
    u = update.to(buffer.dtype)
    if op == "sum":
        return buffer + u
    if op == "min":
        return torch.minimum(buffer, u)
    if op == "max":
        return torch.maximum(buffer, u)
    if op == "prod":
        return buffer * u
    if op == "replace":
        return u.clone()
    if op in ("band", "bor", "bxor"):
        if not is_integer(buffer.dtype):
            return u.clone()
        return {"band": buffer & u, "bor": buffer | u, "bxor": buffer ^ u}[op]
    raise KeyError(op)


def ring_accumulate_ref(buffer_global, update_global, *, axis_size, shift=1,
                        op="sum", offset=0):
    """buffer/update (n, ...) stacked → what each rank's window holds after
    every rank accumulates its update into rank (r+shift) % n at
    ``offset``."""
    landed = torch.roll(update_global, shift, 0)
    m = landed.shape[1]
    out = buffer_global.clone()
    out[:, offset:offset + m] = accumulate_ref(
        buffer_global[:, offset:offset + m], landed, op=op)
    return out


def ring_put_ref(x_global, *, axis_size, shift=1):
    """x_global (n, ...) stacked → what each rank holds after every rank
    puts its shard to (r+shift) % n."""
    return torch.roll(x_global, shift, 0)


def ring_all_reduce_ref(x_global):
    """x_global (n, m, ...) → every rank holds the sum over ranks."""
    s = x_global.sum(0, keepdim=True)
    return s.expand_as(x_global).clone()


__all__ = ["flash_attention_ref", "ssd_scan_ref", "accumulate_ref", "ring_accumulate_ref", "ring_put_ref",
           "ring_all_reduce_ref"]
