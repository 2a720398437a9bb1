"""K3 — one-sided put with thread-scope completion (P1).

Every sending rank writes its rows into a receiving rank's row of a stacked
``(n, ...)`` window; each write bumps the sender's per-(rank, stream)
completion counter.  The substrate lowers put, send, ring hops and the
response half of get to :func:`put_rows`.  Its flush of one stream is
:func:`wait_counters`: a launch that waits, on the card, for that stream's
counters to reach what its puts owe — one column of counters, never a
device-wide synchronisation.  The wait is a programmatic dependent launch:
it may start while the put before it still runs, and its acquire spin is
the completion test.

The P5 path: a displacement may be a per-origin int32 vector in device
memory, and a memory handle table ``[epoch, offset, size, slot]`` with the
registration tables it must match may guard the operation (a stale put is
dropped, a stale read's response is zeros, each counted), so a handle put
is one launch, as an allocated put is, and the host reads nothing.

A window buffer (``src`` of a read, ``dst`` of a put) may also lie in pinned
host memory beside control tensors on the card — the tiered KV pool's cold
tier: K3 then reads or writes it at its device-mapped address
(:func:`map_host`), and the launch counts as a ``-host`` variant.  Its
launch is the device path's: the SMs' reads over the link stop at a rate
set by the host machine once ~130 KB are in flight, and a page's launch
keeps 589,824 bytes in flight (PERF.md §6, the K3 host row).

Replaces ``repro/kernels/rma_put.py::ring_put`` (the ``pallas_call`` at
``rma_put.py:47``; ``rdma.start()`` is the put, ``rdma.wait()`` the flush).
CUDA source: ``csrc/rma_put.cu``.  Bound on an H100: bytes (one read and
one write of the payload, in 16-byte words where the addresses allow); the
wait reads 4 bytes per rank and is bound by its launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import common as _common
from repro_torch.kernels.common import LaunchCounter, cdiv, check_launch

#: put launches by variant: "static" (host offsets), "device" (a
#: displacement or handle from device memory), "guarded" (with the
#: lifetime guard); "-host" appended when an operand is a pinned host
#: window buffer
COUNTER = LaunchCounter("ring_put")
#: wait launches (one variant: programmatic stream serialization)
WAIT_COUNTER = LaunchCounter("put_wait")

#: ranks one wait launch can cover (RT_MAX_WAIT_RANKS in csrc/rma_put.cu)
MAX_WAIT_RANKS = 256

#: threads of a K3 block (blockDim.x of every launch in csrc/rma_put.cu)
PUT_THREADS = 256
#: payload bytes a K3 block copies (HBM's grain: 4 x 16-byte units a thread)
BLOCK_BYTES = 16 * 1024
#: the most blocks of one launch, all senders together
MAX_BLOCKS = 512

#: (n, device) -> completion counters for callers that keep none
_SCRATCH_COUNTERS: dict = {}



def targets_tensor(targets, n: int, device) -> torch.Tensor:
    """``targets`` as the kernel takes it: int32 of length n, -1 where a
    rank sends nothing (a host sequence is copied to ``device``; callers on
    a hot path keep the tensor, as the substrate does)."""
    if isinstance(targets, torch.Tensor):
        t = targets
    else:
        t = torch.tensor(list(targets), dtype=torch.int32)
    if t.shape != (n,):
        raise ValueError(f"targets must have length {n}, got {tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int32)   # no copy if already there


def shift_targets(n: int, shift: int, device) -> torch.Tensor:
    """The ring map ``r -> (r + shift) % n``, made where the kernel reads
    it (on the card, no host-to-device copy)."""
    return (torch.arange(n, dtype=torch.int32, device=device) + shift) % n


def perm_targets(perm, n: int) -> list[int]:
    """The origin → target map of a permutation given as (src, tgt) pairs."""
    out = [-1] * n
    for s, t in perm:
        if out[s] != -1:
            raise ValueError(f"rank {s} appears twice as an origin in {perm}")
        out[s] = t
    return out


def _row_contiguous(x: torch.Tensor) -> bool:
    expect = 1
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _check(src, dst, offset: int, read: bool, dynamic: bool) -> None:
    if src.dim() < 2 or dst.dim() != src.dim() or src.shape[2:] != dst.shape[2:]:
        raise ValueError(f"put needs stacked (n, m, ...) operands of equal "
                         f"trailing shape, got {tuple(src.shape)} -> "
                         f"{tuple(dst.shape)}")
    if src.dtype != dst.dtype:
        raise TypeError(f"put payload {src.dtype} into a {dst.dtype} window")
    m, span = (dst.shape[1], src.shape[1]) if read else (src.shape[1],
                                                          dst.shape[1])
    if m > span or (not dynamic and not 0 <= offset <= span - m):
        raise ValueError(f"{'read' if read else 'put'} of {m} rows at "
                         f"offset {offset} overruns the {span}-row window "
                         "shard")


def _check_address(n: int, device, disp, handles, regs, err) -> None:
    """Device-memory address operands: int32, contiguous, on ``device``;
    ``disp`` and ``err`` ``(n,)``, ``handles`` ``(n, 4)`` at a 16-byte
    boundary (a block loads a row as one word), ``regs`` ``(n, slots, 3)``
    and only with handles to guard."""
    for name, t, shape in (("disp", disp, (n,)), ("handles", handles, (n, 4)),
                           ("err", err, (n,)), ("regs", regs, None)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.device != device or \
                not t.is_contiguous() or (
                    t.shape != shape if shape is not None else
                    t.dim() != 3 or t.shape[0] != n or t.shape[2] != 3
                    or t.shape[1] < 1):
            raise ValueError(f"{name} must be a contiguous int32 "
                             f"{shape or f'({n}, slots, 3)'} tensor on "
                             f"{device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if handles is not None and handles.data_ptr() % 16:
        raise ValueError("handles must start at a 16-byte boundary")
    if regs is not None and handles is None:
        raise ValueError("the lifetime guard (regs) checks memory handles; "
                         "give handles too")


def resolve_rows(o: int, w: int, *, offset: int, disp, disp_unit: int,
                 handles, regs, span: int, m: int) -> tuple[int, bool]:
    """The row an operation of origin ``o`` on rank ``w``'s window
    addresses, and whether its handle is fresh — the kernels' address
    rule, on host values (the plain versions' arithmetic).  A row with a
    device part is placed as ``lax.dynamic_update_slice`` places it: a
    negative row counts from the end of the ``span``-row window row once,
    then it is clamped to ``[0, span - m]``.  The guard compares the
    origin's handle epoch with the live entry of the slot that ``w``'s own
    handle names, as the reference's guard reads ``self.handle[3]`` on the
    rank that owns the window."""
    rows, fresh = offset, True
    if disp is not None:
        rows += int(disp[o]) * disp_unit
    if handles is not None:
        epoch, hoff = int(handles[o, 0]), int(handles[o, 1])
        rows += hoff
        if regs is not None:
            slot = min(max(int(handles[w, 3]), 0), regs.shape[1] - 1)
            live = int(regs[w, slot, 0])
            fresh = epoch == live and live > 0
    if disp is not None or handles is not None:
        rows = min(max(rows + span if rows < 0 else rows, 0), span - m)
    return rows, fresh


def put_rows_plain(src, dst, targets, *, offset: int = 0, counters=None,
                   stream: int = 0, disp=None, disp_unit: int = 1,
                   handles=None, regs=None, err=None,
                   read: bool = False) -> int:
    """The plain PyTorch version of K3: same contract.  Returns the
    completion ticks each sending rank added to its counter (1)."""
    dynamic = disp is not None or handles is not None
    _check(src, dst, offset, read, dynamic)
    control = [t for t in (disp, handles, regs, err) if t is not None]
    _check_address(src.shape[0], control[0].device if control else None,
                   disp, handles, regs, err)
    m, span = (dst.shape[1], src.shape[1]) if read else (src.shape[1],
                                                          dst.shape[1])
    for r, t in enumerate(targets_tensor(targets, src.shape[0], "cpu").tolist()):
        if t < 0:
            continue
        o, w = (t, r) if read else (r, t)
        rows, fresh = resolve_rows(o, w, offset=offset, disp=disp,
                                   disp_unit=disp_unit, handles=handles,
                                   regs=regs, span=span, m=m)
        if not fresh and err is not None:
            err[w] += 1
        if read:
            dst[t, :m] = src[r, rows:rows + m] if fresh else 0
        elif fresh:
            dst[t, rows:rows + m] = src[r]
        if counters is not None:
            counters[r, stream] += 1
    return 1


def launch_blocks(nbytes: int, n: int = 1) -> int:
    """Blocks a sender of a K3 launch gets (``gridDim.x``; the ``n``
    senders ride ``gridDim.y``) for ``nbytes`` bytes a sender: one per
    ``BLOCK_BYTES``, at most ``MAX_BLOCKS`` over all senders, never none.
    The kernel's grid-stride loop copies every unit once for any count."""
    if nbytes < 1 or n < 1:
        raise ValueError(f"{nbytes} bytes a sender over {n} senders")
    return max(1, min(cdiv(nbytes, BLOCK_BYTES), MAX_BLOCKS // n))


def map_host(t: torch.Tensor) -> int:
    """The device-visible address of the pinned host tensor ``t``: the one
    ``cudaHostGetDevicePointer`` gives for its storage (asked once per
    storage, when a window over it is made; raises if the card cannot map
    it) plus ``t``'s offset in it."""
    if not _common.pinned_host(t):
        raise ValueError("only pinned host memory has a device-mapped "
                         f"address, got a tensor on {t.device} that is not")
    base = t.untyped_storage().data_ptr()
    mapped = _common.MAPPED_HOST.get(base)
    if mapped is None:
        out = ctypes.c_void_p()
        rc = _build.lib("rma_put", "rt_host_device_pointer")(
            base, ctypes.byref(out))
        if rc != 0 or not out.value:
            raise RuntimeError(f"cudaHostGetDevicePointer refused the pinned "
                               f"buffer at {base:#x} (code {rc})")
        mapped = _common.MAPPED_HOST[base] = out.value
    return mapped + (t.data_ptr() - base)


def device_pointer(t: torch.Tensor) -> int:
    """The address K3 is given for an operand: a CUDA tensor's own, a
    pinned host tensor's device-mapped one (:func:`map_host`)."""
    return t.data_ptr() if t.is_cuda else map_host(t)


def _scratch_counters(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    c = _SCRATCH_COUNTERS.get(key)
    if c is None:
        c = _SCRATCH_COUNTERS[key] = torch.zeros((n, 1), dtype=torch.int32,
                                                 device=device)
    return c


def put_rows(src: torch.Tensor, dst: torch.Tensor, targets, *,
             offset: int = 0, counters: torch.Tensor | None = None,
             stream: int = 0, disp: torch.Tensor | None = None,
             disp_unit: int = 1, handles: torch.Tensor | None = None,
             regs: torch.Tensor | None = None, err: torch.Tensor | None = None,
             read: bool = False) -> int:
    """For every rank r with ``t = targets[r] >= 0``: a put writes
    ``dst[t, rows:rows+m] = src[r]``; a read's response (``read=True``)
    writes ``dst[t, :m] = src[r, rows:rows+m]``.  Then it adds to
    ``counters[r, stream]``.

    ``rows`` is ``offset + disp[o] * disp_unit + handles[o, 1]`` for the
    operation's origin ``o`` (r for a put, t for a read), placed as
    :func:`resolve_rows` says when a device part is given; a static
    ``offset`` alone must fit or raises.  With ``regs`` (the (n, max_attach, 3) registration
    tables) a handle whose epoch is not the live one of its slot on the
    addressed rank ``w`` is stale: a put writes nothing, a read writes zeros,
    and ``err[w]`` gains one.

    Returns the ticks each sending rank's counter gained (the number of
    blocks that wrote its row), so a caller can tell when a stream's puts
    have all completed.  CPU tensors take the plain version; CUDA tensors
    launch K3 or raise.  ``src`` or ``dst`` (a window buffer) may be pinned
    host memory beside CUDA tensors: K3 then reads or writes it at its
    device-mapped address (the ``-host`` variants of the launch count); an
    unpinned CPU operand beside CUDA tensors raises."""
    dynamic = disp is not None or handles is not None
    _check(src, dst, offset, read, dynamic)
    control = [t for t in (counters, disp, handles, regs, err)
               if t is not None]
    if not (_common.host_window((src, dst), control)
            or _common.on_device(src, dst, *control)):
        return put_rows_plain(src, dst, targets, offset=offset,
                              counters=counters, stream=stream, disp=disp,
                              disp_unit=disp_unit, handles=handles,
                              regs=regs, err=err, read=read)
    if not (_row_contiguous(src) and _row_contiguous(dst)):
        raise ValueError("K3 needs operands whose rows are contiguous")
    n = src.shape[0]
    device = next((t.device for t in (*control, src, dst) if t.is_cuda),
                  src.device)
    _check_address(n, device, disp, handles, regs, err)
    m, span = (dst.shape[1], src.shape[1]) if read else (src.shape[1],
                                                          dst.shape[1])
    if m == 0:
        return 0
    if counters is None:
        counters, stream = _scratch_counters(n, device), 0
    if counters.shape[0] != n or counters.dtype != torch.int32 or \
            not counters.is_contiguous() or counters.device != device:
        raise ValueError("counters must be a contiguous (n, streams) int32 "
                         f"tensor on {device}")
    tgt = targets_tensor(targets, n, device)
    es = src.element_size()
    row_b = es
    for d in src.shape[2:]:
        row_b *= d
    blocks = launch_blocks(m * row_b, n)
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    fn = _build.lib("rma_put")
    rc = fn(device_pointer(src), src.stride(0) * es, device_pointer(dst),
            dst.stride(0) * es, row_b, m, span, offset, tgt.data_ptr(), n,
            ptr(disp), disp_unit, ptr(handles), ptr(regs),
            0 if regs is None else regs.shape[1], ptr(err), int(read),
            counters.data_ptr(), counters.shape[1], stream, blocks,
            _common.stream_ptr(device))
    check_launch("ring_put", rc)
    variant = ("guarded" if regs is not None else
               "device" if dynamic else "static")
    COUNTER.bump(variant if src.is_cuda and dst.is_cuda else
                 f"{variant}-host")
    return blocks


def _check_wait(counters, owed, stream: int, stalls) -> None:
    n = counters.shape[0] if counters.dim() == 2 else -1
    if n < 1 or counters.dtype != torch.int32 or len(owed) != n:
        raise ValueError(f"counters must be (n, streams) int32 with one owed "
                         f"count per rank, got {tuple(counters.shape)} "
                         f"{counters.dtype} and {len(owed)} counts")
    if not 0 <= stream < counters.shape[1]:
        raise ValueError(f"stream {stream} outside the counters' "
                         f"{counters.shape[1]} streams")
    if stalls.shape != (1,) or stalls.dtype != torch.int32:
        raise ValueError("stalls must be a (1,) int32 tensor")


def wait_counters_plain(counters, owed, *, stream: int, stalls) -> None:
    """The plain PyTorch version of the wait: adds to ``stalls[0]`` the
    ranks whose counter ``(r, stream)`` has not reached ``owed[r]`` (modulo
    2^32, as the kernel compares)."""
    _check_wait(counters, owed, stream, stalls)
    want = torch.tensor([o & 0xFFFFFFFF for o in owed], dtype=torch.int64,
                        device=counters.device)
    short = (counters[:, stream].long() - want) % 2**32 >= 2**31
    stalls += short.sum().to(torch.int32)


def wait_counters(counters: torch.Tensor, owed, *, stream: int,
                  stalls: torch.Tensor) -> None:
    """Thread-scope completion of one stream: wait until every rank r's
    counter ``(r, stream)`` has reached ``owed[r]``, the ticks its issued
    puts owe.  On the card the wait is a launch on the current stream that
    spins on those counters only; a count still short after a bounded spin
    adds one to ``stalls[0]`` instead of hanging.  It is launched with
    programmatic stream serialization: it may start while the put before it
    runs, and it ends only after that put has ended, so stream order holds
    across it.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check_wait(counters, owed, stream, stalls)
    if not _common.on_device(counters, stalls):
        wait_counters_plain(counters, owed, stream=stream, stalls=stalls)
        return
    n = counters.shape[0]
    if n > MAX_WAIT_RANKS or not counters.is_contiguous():
        raise ValueError(f"the wait kernel covers at most {MAX_WAIT_RANKS} "
                         f"ranks of contiguous counters, got {n}")
    fn = _build.lib("rma_put", "rt_put_wait")
    words = (ctypes.c_uint32 * n)(*(o & 0xFFFFFFFF for o in owed))
    rc = fn(counters.data_ptr(), n, counters.shape[1], stream, words,
            stalls.data_ptr(), _common.stream_ptr(counters.device))
    check_launch("put_wait", rc)
    WAIT_COUNTER.bump()


def ring_put(x: torch.Tensor, *, axis_size: int, shift: int = 1
             ) -> torch.Tensor:
    """Every rank puts its shard into its ring neighbour's window; returns
    the stacked received buffers (row r = what rank r-shift put into rank
    r's window).  ``x`` is the stacked ``(axis_size, ...)`` shards."""
    n = axis_size
    if x.shape[0] != n:
        raise ValueError(f"ring_put expects {n} stacked shards, got "
                         f"{tuple(x.shape)}")
    if x.dim() == 1:
        return ring_put(x.view(n, 1), axis_size=n, shift=shift).view(n)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    put_rows(x, out, shift_targets(n, shift, x.device))
    return out


__all__ = ["ring_put", "put_rows", "put_rows_plain", "wait_counters",
           "wait_counters_plain", "perm_targets", "targets_tensor",
           "shift_targets", "resolve_rows", "map_host", "device_pointer",
           "launch_blocks", "COUNTER", "WAIT_COUNTER", "MAX_WAIT_RANKS",
           "PUT_THREADS", "BLOCK_BYTES", "MAX_BLOCKS"]
