"""Public wrappers that compose a kernel with its host-side glue (the JAX
package's ``kernels/ops.py`` layer): the full SSD scan, K8 plus the
inter-chunk recurrence and read-out."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_intra_chunk


def ssd_scan(xdt, a, Bm, Cm, *, chunk: int, nheads: int, headdim: int,
             initial_state=None):
    """Full SSD scan = K8 (intra-chunk) + the inter-chunk combine.

    xdt (B, L, H, P); a (B, L, H); Bm/Cm (B, L, N); ``initial_state`` (B,
    H, P, N) or None.  Returns (y (B, L, H, P), final_state (B, H, P, N)),
    both in xdt's dtype.

    L need not divide by ``chunk``: the inputs are zero-padded at the end as
    ``models.ssm.ssd_chunked`` pads them (a = 0 is a decay of 1 and x = 0
    adds nothing, so the final state is exact) and the padded rows are
    sliced off.  ``y_intra`` is rounded to xdt's dtype before ``y_inter`` is
    added, as the JAX glue does (``ssd_chunked`` rounds once)."""
    b, length, h, p = xdt.shape
    n = Bm.shape[-1]
    pad = (-length) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    lp = length + pad
    nc = lp // chunk
    y_intra, states, cum = ssd_intra_chunk(
        xdt.reshape(b, lp, h * p), a, Bm, Cm, chunk=chunk, nheads=nheads,
        headdim=headdim)

    # inter-chunk recurrence over the per-chunk input states (linear, cheap)
    cum_c = cum.reshape(b, nc, chunk, h)
    total_decay = torch.exp(cum_c[:, :, -1, :])[..., None, None]  # (b,c,h,1,1)
    states = states.reshape(b, nc, h, p, n)
    carry = (initial_state.float() if initial_state is not None else
             states.new_zeros((b, h, p, n)))
    entering = []                     # the state entering each chunk
    for c in range(nc):
        entering.append(carry)
        carry = carry * total_decay[:, c] + states[:, c]
    entering = torch.stack(entering, 1)                     # (b, c, h, p, n)

    # read-out: y_inter[t] = exp(cum_t) · C_t · state_entering(chunk of t)
    Cc = Cm.reshape(b, nc, chunk, n).float()
    readout = torch.einsum("bctn,bchpn->bcthp", Cc, entering)
    y_inter = (readout * torch.exp(cum_c)[..., None]).reshape(
        b, lp, h, p).to(xdt.dtype)
    y = y_intra.reshape(b, lp, h, p) + y_inter
    return y[:, :length], carry.to(xdt.dtype)


__all__ = ["ssd_scan", "ssd_intra_chunk"]
