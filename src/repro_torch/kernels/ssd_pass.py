"""The SSD state pass and read-out: the inter-chunk half of the Mamba2 SSD
scan, the kernel that runs after K8.

Given K8's outputs — y_intra, the per-chunk input states and the cumsums of
the log-decays — it carries the state entering each chunk through the chunks
in order (``carry = carry · exp(cum_last) + states[c]``, from the initial
state or zeros), reads each chunk out against the state entering it
(``y_inter[t] = exp(cum_t) · C_t · carry``) and returns y = y_intra + y_inter
and the final state.  y_intra and y_inter are each rounded to the input type
before they are added, as the JAX glue does.

Replaces the XLA glue of ``repro/kernels/ops.py::ssd_scan`` (lines 39-63:
the ``lax.scan`` recurrence and the einsum read-out), which has no
``pallas_call``; its plain version, :func:`ssd_pass_plain`, is that glue.
CUDA source: ``csrc/ssd_pass.cu`` — one CTA per (batch, head, tile of 16
headdim rows) walking the chunks with the float32 carry in registers, the
read-out on the tensor cores (the carry split into bf16 hi and lo parts),
each chunk's operands arriving by ``cp.async`` two chunks ahead.
:func:`pass_program` is that walk in PyTorch, tile by tile and chunk by
chunk with the kernel's splits, which ``tests/test_torch_ssd_pass.py`` holds to
the plain version.  Bound on an H100: bytes (reading the float32 states).

L need not divide by the chunk: the last chunk's rows past L read C = 0, and
its decay is the one to row L − 1 (the pad rows of K8 add a = 0).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import (DTYPE_CODES, LaunchCounter, cdiv,
                                        check_launch)
from repro_torch.kernels.ssd_scan import (MAX_CHUNK, MAX_STATE, refuse_grad,
                                          row_view)

COUNTER = LaunchCounter("ssd_pass")

#: headdim rows per CTA of the kernel
TILE = 16


def _check(y_intra, states, cum, Cm, chunk, nheads, headdim,
           initial_state) -> None:
    b, length, hp = y_intra.shape
    n = Cm.shape[-1]
    want = {"states": (b, cdiv(length, chunk), hp, n),
            "cum": (b, length, nheads), "Cm": (b, length, n)}
    got = {"states": tuple(states.shape), "cum": tuple(cum.shape),
           "Cm": tuple(Cm.shape)}
    if initial_state is not None:
        want["initial_state"] = (b, nheads, headdim, n)
        got["initial_state"] = tuple(initial_state.shape)
    if hp != nheads * headdim or got != want:
        raise ValueError(f"the SSD pass wants y_intra (B, L, H·P) with H·P = "
                         f"{nheads}·{headdim} and {want}; got y_intra "
                         f"{tuple(y_intra.shape)} and {got}")
    if not (1 <= chunk <= MAX_CHUNK and 1 <= n <= MAX_STATE):
        raise ValueError(f"the SSD pass takes chunk <= {MAX_CHUNK} and "
                         f"d_state <= {MAX_STATE}; got chunk={chunk}, "
                         f"d_state={n}")


def ssd_pass_plain(y_intra, states, cum, Cm, *, chunk: int, nheads: int,
                   headdim: int, initial_state=None):
    """The plain PyTorch version: the JAX package's glue — the inter-chunk
    recurrence over the chunk states, then the read-out, every chunk at
    once.  A ragged last chunk is padded as K8 pads it (cum flat, C zero)."""
    b, length, _ = y_intra.shape
    h, p, n = nheads, headdim, Cm.shape[-1]
    pad = (-length) % chunk
    if pad:
        y_intra = F.pad(y_intra, (0, 0, 0, pad))
        cum = torch.cat([cum, cum[:, -1:].expand(b, pad, h)], 1)
        Cm = F.pad(Cm, (0, 0, 0, pad))
    lp = length + pad
    nc = lp // chunk
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
        b, lp, h, p).to(y_intra.dtype)
    y = y_intra.reshape(b, lp, h, p) + y_inter
    return y[:, :length], carry.to(y_intra.dtype)


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = bf16(v), lo = bf16(v − hi), as float32 values."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def pass_program(y_intra, states, cum, Cm, *, chunk: int, nheads: int,
                 headdim: int, initial_state=None):
    """``ssd_pass_kernel``'s walk in PyTorch, with its arithmetic: for each
    tile of 16 headdim rows (all CTAs of the tile at once), the carry from
    the initial state, then chunk by chunk in order — split the carry into
    bf16 hi and lo, read the chunk's rows out as C·hiᵀ + C·loᵀ (float32
    inputs: hi(C)·hiᵀ + hi(C)·loᵀ + lo(C)·hiᵀ), scale by exp(cum_t), round
    y_inter and y_intra + y_inter to the input type, then carry =
    carry · exp(cum of the chunk's last row below L) + the chunk's state.
    Returns (y (B, L, H, P), final state (B, H, P, N)) like the kernel."""
    b, length, _ = y_intra.shape
    h, p, n = nheads, headdim, Cm.shape[-1]
    dt = y_intra.dtype
    nc = cdiv(length, chunk)
    st = states.reshape(b, nc, h, p, n).float()
    yi = y_intra.reshape(b, length, h, p)
    s0 = (initial_state.float() if initial_state is not None else
          st.new_zeros((b, h, p, n)))
    y = torch.empty((b, length, h, p), dtype=dt, device=y_intra.device)
    final = torch.empty((b, h, p, n), dtype=dt, device=y_intra.device)
    for p0 in range(0, p, TILE):
        rows = slice(p0, min(p0 + TILE, p))
        carry = s0[:, :, rows]
        for c in range(nc):
            t = slice(c * chunk, min(c * chunk + chunk, length))
            ct = Cm[:, t].float()                               # (b, nv, n)
            hi, lo = _split(carry)                              # (b, h, 16, n)
            parts = [(ct, hi), (ct, lo)]
            if dt == torch.float32:
                chi, clo = _split(ct)
                parts = [(chi, hi), (chi, lo), (clo, hi)]
            readout = sum(torch.einsum("btn,bhpn->bthp", u, v)
                          for u, v in parts)
            inter = (torch.exp(cum[:, t].float())[..., None] * readout).to(dt)
            y[:, t, :, rows] = (yi[:, t, :, rows].float()
                                + inter.float()).to(dt)
            decay = torch.exp(cum[:, t.stop - 1].float())       # (b, h)
            carry = carry * decay[:, :, None, None] + st[:, c, :, rows]
        final[:, :, rows] = carry.to(dt)
    return y, final


def launch_pass(y_intra: torch.Tensor, states: torch.Tensor,
                cum: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                nheads: int, headdim: int, initial_state=None):
    """Launch the pass kernel on card tensors (shapes as
    :func:`ssd_pass`); ``Cm`` may be a row-strided view."""
    refuse_grad("the SSD pass", y_intra, states, cum, Cm, initial_state)
    dt = y_intra.dtype
    if dt not in (torch.float32, torch.bfloat16) or Cm.dtype != dt or \
            states.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError(f"the SSD pass takes float32 or bfloat16 y_intra "
                        f"and C of one dtype with float32 states and cum, "
                        f"got {dt}/{Cm.dtype}, {states.dtype}, {cum.dtype}")
    b, length, _ = y_intra.shape
    h, p, n = nheads, headdim, Cm.shape[-1]
    y_intra, states, cum = (t.contiguous() for t in (y_intra, states, cum))
    Cm, ldc = row_view(Cm)
    s0 = None
    if initial_state is not None:
        s0 = initial_state.contiguous()
        if s0.dtype not in (torch.float32, torch.bfloat16):
            s0 = s0.float()
    y = torch.empty((b, length, h, p), dtype=dt, device=y_intra.device)
    final = torch.empty((b, h, p, n), dtype=dt, device=y_intra.device)
    fn = _build.lib("ssd_pass")
    rc = fn(y_intra.data_ptr(), states.data_ptr(), cum.data_ptr(),
            Cm.data_ptr(), None if s0 is None else s0.data_ptr(),
            0 if s0 is None else DTYPE_CODES[s0.dtype], y.data_ptr(),
            final.data_ptr(), b, length, chunk, h, p, n, ldc,
            DTYPE_CODES[dt], _common.stream_ptr(y_intra.device))
    check_launch("ssd_pass", rc)
    COUNTER.bump()
    return y, final


def ssd_pass(y_intra: torch.Tensor, states: torch.Tensor, cum: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int, nheads: int, headdim: int,
             initial_state=None):
    """y_intra (B, L, H·P), states (B, cdiv(L, chunk), H·P, N) float32, cum
    (B, L, H) float32 (K8's outputs), Cm (B, L, N), ``initial_state`` (B, H,
    P, N) or None → (y (B, L, H, P), final state (B, H, P, N)), both in
    y_intra's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check(y_intra, states, cum, Cm, chunk, nheads, headdim, initial_state)
    ins = (y_intra, states, cum, Cm) + (
        () if initial_state is None else (initial_state,))
    fn = launch_pass if _common.on_device(*ins) else ssd_pass_plain
    return fn(y_intra, states, cum, Cm, chunk=chunk, nheads=nheads,
              headdim=headdim, initial_state=initial_state)


__all__ = ["ssd_pass", "ssd_pass_plain", "pass_program", "launch_pass",
           "COUNTER", "TILE"]
