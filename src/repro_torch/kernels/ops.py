"""Public wrappers that compose kernels (the JAX package's ``kernels/ops.py``
layer): the full SSD scan, K8 (intra-chunk) then the SSD state pass (the
inter-chunk recurrence and read-out)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import common as _common
from repro_torch.kernels.ssd_pass import launch_pass, ssd_pass_plain
from repro_torch.kernels.ssd_scan import (check_shapes, launch_intra_chunk,
                                          refuse_grad, ssd_intra_chunk_plain)


def ssd_scan_plain(xdt, a, Bm, Cm, *, chunk: int, nheads: int, headdim: int,
                   initial_state=None):
    """The plain composition on either device: the inputs zero-padded at
    the end to whole chunks as ``models.ssm.ssd_chunked`` pads them (a = 0
    is a decay of 1 and x = 0 adds nothing, so the final state is exact),
    K8's plain version, the pass's plain version (the JAX glue), and the
    padded rows sliced off."""
    b, length, h, p = xdt.shape
    pad = (-length) % chunk
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    lp = length + pad
    y_intra, states, cum = ssd_intra_chunk_plain(
        xdt.reshape(b, lp, h * p), a, Bm, Cm, chunk=chunk, nheads=nheads,
        headdim=headdim)
    y, final = ssd_pass_plain(y_intra, states, cum, Cm, chunk=chunk,
                              nheads=nheads, headdim=headdim,
                              initial_state=initial_state)
    return y[:, :length], final


def ssd_scan(xdt, a, Bm, Cm, *, chunk: int, nheads: int, headdim: int,
             initial_state=None):
    """Full SSD scan = K8 (intra-chunk) + the SSD pass (inter-chunk).

    xdt (B, L, H, P); a (B, L, H); Bm/Cm (B, L, N); ``initial_state`` (B,
    H, P, N) or None.  Returns (y (B, L, H, P), final_state (B, H, P, N)),
    both in xdt's dtype.  ``y_intra`` is rounded to xdt's dtype before
    ``y_inter`` is added, as the JAX glue does (``ssd_chunked`` rounds
    once).  L need not divide by ``chunk``.

    CPU tensors take :func:`ssd_scan_plain`.  CUDA tensors make two
    launches, K8 then the pass kernel, on the unpadded tensors (B and C may
    be slices of a wider projection), or raise."""
    b, length, h, p = xdt.shape
    check_shapes(xdt.reshape(b, length, h * p), a, Bm, Cm, chunk, nheads,
                 headdim)
    ins = (xdt, a, Bm, Cm) + (
        () if initial_state is None else (initial_state,))
    if not _common.on_device(*ins):
        return ssd_scan_plain(xdt, a, Bm, Cm, chunk=chunk, nheads=nheads,
                              headdim=headdim, initial_state=initial_state)
    refuse_grad("the SSD scan", *ins)
    y_intra, states, cum = launch_intra_chunk(
        xdt.reshape(b, length, h * p), a, Bm, Cm, chunk=chunk, nheads=nheads,
        headdim=headdim)
    return launch_pass(y_intra, states, cum, Cm, chunk=chunk, nheads=nheads,
                       headdim=headdim, initial_state=initial_state)


__all__ = ["ssd_scan", "ssd_scan_plain"]
