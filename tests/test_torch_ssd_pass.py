"""The SSD state pass (``kernels.ssd_pass``), the second kernel of the card's
SSD scan: its plain version (the JAX glue, lifted out of ``ops.ssd_scan``)
on K8's plain outputs against the JAX package's ``ops.ssd_scan`` and, at a
ragged length, against ``ssd_chunked``; ``pass_program`` — the kernel's walk
over headdim tiles and chunks with its bf16 hi/lo splits — against the
plain version; and the card route of ``ops.ssd_scan``, run here with the
kernel library replaced by a recorder: exactly two C entries (K8, then the
pass) on the unpadded tensors, no pad, no plain version and no per-chunk
operator around them.  Inputs are numpy arrays from a seed, handed to both
packages."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ops import ssd_scan as j_ssd_scan
from repro.models import ssm as j_ssm

from repro_torch import _build
from repro_torch.kernels import common, ops
from repro_torch.kernels.ssd_pass import (COUNTER as PASS_COUNTER,
                                          pass_program, ssd_pass,
                                          ssd_pass_plain)
from repro_torch.kernels.ssd_scan import COUNTER as K8_COUNTER
from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain

#: the full scan in float32: the JAX kernel test's tolerance
#: (tests/test_kernels.py), as tests/test_torch_ssm.py holds the scan to
SCAN_TOL = dict(atol=2e-4, rtol=1e-3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(seed, B, L, H, P, N, *, init=False):
    """xdt (B, L, H, P), a (B, L, H) < 0, Bm/Cm (B, L, N) and an initial
    state, as float32 numpy arrays (tests/test_torch_ssm.py's)."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, L, H, P)).astype(np.float32) * 0.5
    a = -np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, L, N)).astype(np.float32) * 0.5
    s0 = (rng.standard_normal((B, H, P, N)).astype(np.float32) * 0.3
          if init else None)
    return xdt, a, Bm, Cm, s0


def _k8_outputs(xdt, a, Bm, Cm, chunk):
    """K8's outputs as the card's kernel leaves them at any L: the plain
    version on the end-padded inputs, y_intra and cum cut back to L (the
    kernel writes no row past L; its states cover the ragged chunk)."""
    b, length, h, p = xdt.shape
    pad = (-length) % chunk
    x2 = F.pad(xdt.reshape(b, length, h * p), (0, 0, 0, pad))
    y_intra, states, cum = ssd_intra_chunk_plain(
        x2, F.pad(a, (0, 0, 0, pad)), F.pad(Bm, (0, 0, 0, pad)),
        F.pad(Cm, (0, 0, 0, pad)), chunk=chunk, nheads=h, headdim=p)
    return y_intra[:, :length], states, cum[:, :length]


# ---------------------------------------------------------------------------
# the plain version against the JAX glue and ssd_chunked
# ---------------------------------------------------------------------------

GLUE_CASES = [(2, 64, 4, 16, 32, 16, False), (1, 128, 2, 32, 16, 32, False),
              (1, 48, 8, 8, 64, 8, False),  # tests/test_kernels.py:148-152
              (1, 32, 2, 8, 16, 8, True)]   # tests/test_kernels.py:163


@pytest.mark.parametrize("B,L,H,P,N,chunk,init", GLUE_CASES)
def test_plain_pass_matches_the_jax_glue(B, L, H, P, N, chunk, init):
    """K8's plain outputs through the pass's plain version equal the JAX
    package's ops.ssd_scan (its Pallas K8 in interpret mode, then its
    lax.scan glue)."""
    xdt, a, Bm, Cm, s0 = _inputs(L + 11, B, L, H, P, N, init=init)
    ts0 = _t(s0) if init else None
    y_intra, states, cum = _k8_outputs(_t(xdt), _t(a), _t(Bm), _t(Cm), chunk)
    y, fs = ssd_pass(y_intra, states, cum, _t(Cm), chunk=chunk, nheads=H,
                     headdim=P, initial_state=ts0)
    wy, wfs = j_ssd_scan(*(jnp.asarray(v) for v in (xdt, a, Bm, Cm)),
                         chunk=chunk, nheads=H, headdim=P,
                         initial_state=jnp.asarray(s0) if init else None)
    assert tuple(y.shape) == (B, L, H, P) and tuple(fs.shape) == (B, H, P, N)
    np.testing.assert_allclose(_np(y), _np(wy), **SCAN_TOL)
    np.testing.assert_allclose(_np(fs), _np(wfs), **SCAN_TOL)


@pytest.mark.parametrize("B,L,H,P,N,chunk,init", [
    (2, 45, 3, 8, 16, 8, False), (1, 70, 2, 16, 32, 16, True),
    (1, 100, 2, 24, 32, 64, True)])
def test_ragged_pass_matches_ssd_chunked(B, L, H, P, N, chunk, init):
    """At a length no multiple of the chunk — what the card's kernels take,
    unpadded — the pass's plain version and its program equal the JAX
    package's ssd_chunked (the JAX glue needs whole chunks)."""
    xdt, a, Bm, Cm, s0 = _inputs(L, B, L, H, P, N, init=init)
    ts0 = _t(s0) if init else None
    outs = _k8_outputs(_t(xdt), _t(a), _t(Bm), _t(Cm), chunk)
    assert outs[0].shape[1] == L and outs[2].shape[1] == L
    wy, wfs = j_ssm.ssd_chunked(*(jnp.asarray(v) for v in (xdt, a, Bm, Cm)),
                                chunk=chunk,
                                initial_state=jnp.asarray(s0) if init else None)
    for fn in (ssd_pass_plain, pass_program):
        y, fs = fn(*outs, _t(Cm), chunk=chunk, nheads=H, headdim=P,
                   initial_state=ts0)
        np.testing.assert_allclose(_np(y), _np(wy), **SCAN_TOL)
        np.testing.assert_allclose(_np(fs), _np(wfs), **SCAN_TOL)


# ---------------------------------------------------------------------------
# the kernel's walk against the plain version
# ---------------------------------------------------------------------------

PROGRAM_CASES = [
    (1, 128, 2, 64, 128, 64, True),    # the model's head and state widths
    (2, 45, 3, 8, 16, 8, False),       # ragged; headdim under one tile
    (1, 70, 2, 24, 40, 16, True),      # ragged; a partial tile; N % 16 != 0
    (1, 16, 4, 16, 32, 64, False),     # one chunk, shorter than the chunk
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,N,chunk,init", PROGRAM_CASES)
def test_pass_program_matches_the_plain_glue(B, L, H, P, N, chunk, init,
                                             dtype):
    """The kernel's walk — 16 headdim rows at a time, chunks in order, the
    carry split into bf16 hi and lo for the read-out (float32 inputs split
    C too) — against the glue.  float32: the scan's tolerance (the splits
    keep ~2^-16).  bfloat16: both round y_inter, then y_intra + y_inter, to
    bf16, from y_inter values ~2^-16 apart, so each rounding may land one
    bf16 step (2^-7 of the value rounded) apart:
    |d| <= 2^-7 (|y_inter| + |y|) <= 2^-6 (|y_intra| + |y_inter|)."""
    dt = getattr(torch, dtype)
    xdt, a, Bm, Cm, s0 = _inputs(3 * L + H, B, L, H, P, N, init=init)
    tin = [_t(xdt).to(dt), _t(a), _t(Bm).to(dt), _t(Cm).to(dt)]
    ts0 = _t(s0) if init else None
    y_intra, states, cum = _k8_outputs(*tin, chunk)
    kw = dict(chunk=chunk, nheads=H, headdim=P, initial_state=ts0)
    gy, gfs = pass_program(y_intra, states, cum, tin[3], **kw)
    wy, wfs = ssd_pass_plain(y_intra, states, cum, tin[3], **kw)
    assert gy.dtype == wy.dtype == gfs.dtype == wfs.dtype == dt
    if dt == torch.float32:
        np.testing.assert_allclose(_np(gy), _np(wy), **SCAN_TOL)
        np.testing.assert_allclose(_np(gfs), _np(wfs), **SCAN_TOL)
        return
    yi = _np(y_intra).reshape(wy.shape)
    scale = np.abs(yi) + np.abs(_np(wy) - yi)
    assert np.all(np.abs(_np(gy) - _np(wy)) <= 1e-3 + 2.0 ** -6 * scale)
    np.testing.assert_allclose(_np(gfs), _np(wfs), atol=1e-3, rtol=2.0 ** -7)


# ---------------------------------------------------------------------------
# the card route of ops.ssd_scan, with the kernel libraries recorded
# ---------------------------------------------------------------------------

def _recorder(monkeypatch):
    """Replace the kernel libraries by a recorder of (library, entry,
    arguments) that reports success, and every operator the card route
    must not run by one that raises."""
    calls = []

    def lib(name, symbol=None):
        symbol = symbol or next(iter(_build.SIGNATURES[name]))

        def entry(*args):
            calls.append((name, symbol, args))
            return 0
        return entry

    def forbidden(what):
        def run(*a, **k):
            raise AssertionError(f"the card route ran {what}")
        return run

    monkeypatch.setattr(common, "on_device", lambda *ts: True)
    monkeypatch.setattr(common, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(_build, "lib", lib)
    for mod, names in ((F, ("pad",)), (torch, ("stack", "einsum", "exp",
                                               "cumsum", "cat")),
                       (ops, ("ssd_scan_plain", "ssd_intra_chunk_plain",
                              "ssd_pass_plain")),
                       (sys.modules["repro_torch.kernels.ssd_scan"],
                        ("ssd_intra_chunk_plain",)),
                       (sys.modules["repro_torch.kernels.ssd_pass"],
                        ("ssd_pass_plain", "pass_program"))):
        for name in names:
            monkeypatch.setattr(mod, name, forbidden(f"{mod.__name__}.{name}"))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
def test_card_route_is_two_launches_on_unpadded_tensors(monkeypatch, dtype,
                                                        init):
    B, L, H, P, N, chunk = 2, 45, 3, 8, 16, 8
    dt = getattr(torch, dtype)
    xdt, a, Bm, Cm, s0 = _inputs(1, B, L, H, P, N, init=True)
    # B and C as the model hands them over: slices of one wider projection
    xbc = torch.cat([_t(Bm), _t(Cm), torch.zeros((B, L, 5))], -1).to(dt)
    bv, cv = xbc[..., :N], xbc[..., N:2 * N]
    ts0 = _t(s0).to(dt) if init else None
    calls = _recorder(monkeypatch)
    k8_before, pass_before = K8_COUNTER.count, PASS_COUNTER.count
    y, fs = ops.ssd_scan(_t(xdt).to(dt), _t(a), bv, cv, chunk=chunk,
                         nheads=H, headdim=P, initial_state=ts0)
    assert [(c[0], c[1]) for c in calls] == [
        ("ssd_scan", "rt_ssd_intra_chunk"), ("ssd_pass", "rt_ssd_pass")]
    (_, _, k8), (_, _, pas) = calls
    # K8: x, a, B, C, y, st, cum, then B, L, Q, H, P, N, ldb, ldc, dtype
    assert k8[7:16] == (B, L, chunk, H, P, N, 2 * N + 5, 2 * N + 5,
                        common.DTYPE_CODES[dt])
    assert k8[2] == bv.data_ptr() and k8[3] == cv.data_ptr()  # no copies
    # the pass: y_intra, st, cum, C, s0, s0 dtype, y, final, then B, L, Q,
    # H, P, N, ldc, dtype — K8's outputs in, the same C view
    assert pas[:3] == k8[4:7] and pas[3] == cv.data_ptr()
    assert pas[4] == (ts0.data_ptr() if init else None)
    assert pas[8:16] == (B, L, chunk, H, P, N, 2 * N + 5,
                         common.DTYPE_CODES[dt])
    assert pas[6] == y.data_ptr() and pas[7] == fs.data_ptr()
    assert (K8_COUNTER.count - k8_before, PASS_COUNTER.count - pass_before) \
        == (1, 1)
    assert tuple(y.shape) == (B, L, H, P) and tuple(fs.shape) == (B, H, P, N)
    assert y.dtype == fs.dtype == dt


def test_card_route_raises_without_a_card_or_on_grad(monkeypatch):
    xdt, a, Bm, Cm, s0 = _inputs(2, 1, 20, 2, 8, 16, init=True)
    args = [_t(xdt), _t(a), _t(Bm), _t(Cm)]
    kw = dict(chunk=8, nheads=2, headdim=8, initial_state=_t(s0))
    monkeypatch.setattr(common, "on_device", lambda *ts: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.ssd_scan(*args, **kw)
    y_intra, states, cum = _k8_outputs(*args, 8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ssd_pass(y_intra, states, cum, args[3], **kw)
    for t in (args[0], kw["initial_state"]):
        t.requires_grad_(True)
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            ops.ssd_scan(*args, **kw)
        t.requires_grad_(False)
    states.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ssd_pass(y_intra, states, cum, args[3], **kw)


@pytest.mark.parametrize("what", ["states", "cum", "initial_state",
                                  "chunk"])
def test_pass_rejects_shapes_it_does_not_take(what):
    xdt, a, Bm, Cm, s0 = _inputs(4, 1, 24, 2, 8, 16, init=True)
    y_intra, states, cum = _k8_outputs(_t(xdt), _t(a), _t(Bm), _t(Cm), 8)
    kw = dict(chunk=8, nheads=2, headdim=8, initial_state=_t(s0))
    if what == "states":
        states = states[:, :-1]
    elif what == "cum":
        cum = cum[..., :1]
    elif what == "initial_state":
        kw["initial_state"] = kw["initial_state"][:, :, :4]
    else:                       # one chunk of 128: past the kernel's 64
        kw["chunk"], states = 128, states[:, :1]
    with pytest.raises(ValueError, match="chunk <= 64" if what == "chunk"
                       else "the SSD pass wants"):
        ssd_pass(y_intra, states, cum, _t(Cm), **kw)
