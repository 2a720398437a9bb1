"""P5 — MPI memory handles (paper §4.2): zero-overhead dynamic windows.

Instead of sending a peer the virtual address of attached memory (which
forces the query / AM slow paths of ``dynamic.py``), the application ships
the registration itself as an opaque fixed-size handle.  A window created
from a handle addresses the remote segment directly: a handle put is one K3
launch that reads the handle and the target's live registration on the
card, exactly as many launches as an allocated put (paper Fig. 12: "the
difference between allocated windows and windows created from memory
handles is negligible").

The port of ``repro/core/rma/memhandle.py``.  Ranks are rows: a handle is a
stacked ``(n, 4)`` int32 tensor ``[epoch, offset, size, slot]`` on the
window's device, row s the handle origin s holds (:func:`memhandle_create`
gives each rank its own registration; permute the rows to hand peers'
handles around).  Lifetime guarantees, at two levels as in the reference:

* **On the card** (always): the kernels compare the origin's handle epoch
  with the target's live ``regs[t, slot, 0] > 0``, ``slot`` the one the
  target's own handle row names (as the reference reads ``handle[3]`` on
  the rank that owns the window).  A stale put or accumulate is
  dropped, a stale read returns zeros, and each adds one to the target's
  entry of :attr:`MemhandleWindow.err_count`.
* **At call time** (with ``slot=``): :func:`win_from_memhandle` records the
  slot's release count from the dup family's
  :class:`~repro_torch.core.rma.substrate.FlushQueues`; an operation after
  a later :func:`memhandle_release` raises ``RuntimeError`` (the reference
  raises at trace time).

Only put / get / accumulate / flush are allowed on a handle window;
synchronization goes through the parent dynamic window (``fence`` raises).
Creation and destruction are local and cheap.  Phases, as the reference's
collective permutes: put 2 (payload + ``[addr, epoch]`` header), get 2
(header request + response), accumulate 2 (+1 ack on the software path).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.rma.dynamic import DynamicWindow

Perm = Sequence[tuple[int, int]]

#: ``MPI_MAX_MEMHANDLE_SIZE`` — implementation-specific handle size (int32s).
MAX_MEMHANDLE_SIZE = 4


def memhandle_create(win: DynamicWindow, slot: int) -> torch.Tensor:
    """``MPIX_Memhandle_create``: every rank's registration of ``slot`` as
    its handle, ``(n, 4)`` int32 ``[epoch, offset, size, slot]`` on the
    window's device.  Local; no communication."""
    win._check_slot(slot)
    h = torch.empty((win.axis_size, MAX_MEMHANDLE_SIZE), dtype=torch.int32,
                    device=win.regs.device)
    h[:, :3].copy_(win.regs[:, slot])
    h[:, 3].fill_(slot)
    return h


def memhandle_release(win: DynamicWindow, slot: int) -> DynamicWindow:
    """``MPIX_Memhandle_release``: end the exposure — every rank's epoch
    advances and the slot's entry goes invalid, so outstanding handles are
    stale (dropped and counted on the card); the release is also recorded
    in the dup family's queues, so handle windows built with ``slot=`` raise
    on a later use."""
    win._check_slot(slot)
    win.epoch += 1
    win.regs[:, slot, 0].zero_()
    win.group.note_release(slot)
    return win


def win_from_memhandle(parent: DynamicWindow, memhandle: torch.Tensor, *,
                       disp_unit: int = 1, slot: int | None = None
                       ) -> "MemhandleWindow":
    """``MPIX_Win_from_memhandle``: local creation of a window from the
    stacked handles each origin received.  ``slot``: an optional statement
    of the registration slot the handles name, which arms the call-time
    use-after-release check."""
    n = parent.axis_size
    if memhandle.shape != (n, MAX_MEMHANDLE_SIZE):
        raise ValueError(
            f"memhandle must be a stacked ({n}, {MAX_MEMHANDLE_SIZE}) int32 "
            f"tensor, got {tuple(memhandle.shape)}")
    handle = memhandle.to(device=parent.regs.device,
                          dtype=torch.int32).contiguous()
    births = parent.group.release_count(slot) if slot is not None else 0
    return MemhandleWindow(
        parent=parent, handle=handle, disp_unit=disp_unit,
        err_count=torch.zeros(n, dtype=torch.int32, device=handle.device),
        slot_hint=slot, birth_releases=births)


@dataclasses.dataclass
class MemhandleWindow:
    """A window created from memory handles (paper Listing 5): a view over
    the parent dynamic window's substrate (pool, completion counters, flush
    queues, ledger).  ``err_count[t]`` counts the stale operations target t
    dropped (or answered with zeros).  Operations update in place and
    return the window."""

    parent: DynamicWindow
    handle: torch.Tensor
    disp_unit: int
    err_count: torch.Tensor
    slot_hint: int | None = None
    birth_releases: int = 0

    def _check_lifetime(self) -> None:
        """The call-time half of the P5 lifetime guarantee."""
        if self.slot_hint is None:
            return
        now = self.parent.group.release_count(self.slot_hint)
        if now != self.birth_releases:
            raise RuntimeError(
                f"memory handle for slot {self.slot_hint} used after "
                f"memhandle_release ({now - self.birth_releases} release(s) "
                "since the window was created) — erroneous per paper §4.2; "
                "create a fresh handle after re-attaching")

    def _address(self, offset) -> dict:
        """The address K3/K2 resolve on the card: ``handle[o, 1] + offset *
        disp_unit`` (``offset`` an int or a per-rank tensor), and the guard
        against the target's live registration."""
        p = self.parent
        addr = dict(handles=self.handle, disp_unit=self.disp_unit,
                    regs=p.regs, err=self.err_count)
        if isinstance(offset, int) and not isinstance(offset, bool):
            addr["offset"] = offset * self.disp_unit
        else:
            addr["disp"] = p.substrate.disp(offset)
        return addr

    def _begin(self, stream: int) -> None:
        self._check_lifetime()
        self.parent._check_stream(stream)

    def _end(self, kind: str, phases: int, perm: Perm, stream: int) -> None:
        """Bill the operation and enter it into the family's flush ledger —
        unless the parent's topology makes ``perm`` node-local, which owes
        no flush epoch."""
        shm = self.parent._shm(perm)
        self.parent.ledger.bill(kind, phases, shm=shm)
        if not shm:
            self.parent.group.note_op(stream, perm)

    def put(self, data: torch.Tensor, perm: Perm, *, offset=0,
            stream: int = 0) -> "MemhandleWindow":
        """Direct put through the handles: one K3 launch (the same as an
        allocated put); a stale handle's write is dropped and counted.  2
        phases."""
        self._begin(stream)
        sub = self.parent.substrate
        sub._write_rows(sub._payload(data), sub.buffer, perm, stream,
                        **self._address(offset))
        self._end("put", 2, perm, stream)
        return self

    def get(self, perm: Perm, *, offset=0, size: int, stream: int = 0
            ) -> tuple["MemhandleWindow", torch.Tensor]:
        """Direct read through the handles: one K3 launch; a stale handle's
        response is zeros and is counted.  2 phases."""
        self._begin(stream)
        data = self.parent.substrate._read_rows(perm, size, stream,
                                                **self._address(offset))
        self._end("get", 2, perm, stream)
        return self, data

    def accumulate(self, data: torch.Tensor, perm: Perm, *, op: str = "sum",
                   offset=0, stream: int = 0) -> "MemhandleWindow":
        """Accumulate through the handles, routed as ``Window.accumulate``
        (intrinsic: one K2 launch; tiled and software: K3 read, K1 fold,
        K3 write-back), under the same guard as :meth:`put`.  2 phases, and
        the software path's completion ack."""
        from repro_torch.core.rma import accumulate as _engine

        self._begin(stream)
        p = self.parent
        path = _engine.route(op, int(data[0].numel()), data.dtype, p.config)
        sub = p.substrate
        sub.rmw_rows(sub._payload(data), perm, op, path=path, stream=stream,
                     **self._address(offset))
        self._end("accumulate", 3 if path == _engine.PATH_SOFTWARE else 2,
                  perm, stream)
        return self

    def flush(self, stream: int | None = None) -> "MemhandleWindow":
        """Flush through the parent's synchronization state (the dup
        family's scope-aware epoch engine)."""
        self.parent.flush(stream)
        return self

    def fence(self):
        raise RuntimeError(
            "memory handle windows are restricted to passive-target "
            "synchronization; fence/lock must be applied to the parent "
            "dynamic window (paper §4.2)")

    def free(self) -> DynamicWindow:
        """``MPI_Win_free`` on the handle window: returns the parent."""
        return self.parent


__all__ = ["MAX_MEMHANDLE_SIZE", "memhandle_create", "memhandle_release",
           "win_from_memhandle", "MemhandleWindow"]
