"""Dynamic windows (paper §4) — attach/detach with the two slow paths.

``MPI_Win_create_dynamic`` windows let a process expose memory locally,
after collective window creation.  The origin then has no registration
information for the target memory, so every operation either

* **queries** it from the target first (Fig. 3b): :meth:`DynamicWindow.
  put_query` / :meth:`get_query` — a request, the registration entry back,
  then the operation at the resolved address; or
* falls back to **active-message emulation** (Fig. 3c): :meth:`put_am`
  lands the payload in the target's AM queue, and only the target's
  :meth:`progress` applies it (no one-sided progress, the paper's Fig. 5).

Memory handles (``memhandle.py``) remove both penalties.

The port of ``repro/core/rma/dynamic.py``.  Ranks are the rows of stacked
tensors, all on the window's device and all updated in place:

* the pool is the substrate's ``(n, P)`` buffer;
* ``regs`` ``(n, max_attach, 3)`` int32 — each rank's registration table,
  ``[epoch (0 = invalid), offset, size]`` per slot;
* ``epoch`` ``(n,)`` int32 — each rank's registration epoch;
* the AM queue: ``am_data`` ``(n, am_slots, am_msg)``, ``am_meta``
  ``(n, am_slots, 3)`` int32 ``[slot + 1, offset, size]``, ``am_count``
  ``(n,)`` int32.  One more row of each, never drained, takes messages past
  a full queue, which the reference's scatter drops.

Every address and epoch the operations use is read on the card: the query's
response lands in a device handle table that the guarded K3 put or read
then takes (``kernels.rma_put``), the AM enqueue writes at a device index,
and ``progress`` drains with masked device writes.  The host reads nothing.

Phases: each method bills the collective permutes the reference issues —
``put_query`` 5 (request, response, payload, address, epoch), ``get_query``
4 (request, response, address, data), ``put_am`` 3 (payload, header, size),
``flush_am`` 2 (one ack round trip); ``progress`` none.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.rma.window import Window, WindowConfig

Perm = Sequence[tuple[int, int]]


@dataclasses.dataclass
class DynamicWindow(Window):
    """``MPI_Win_create_dynamic`` analogue with query and AM slow paths.
    A dup (``dup_with_info``) shares every tensor below with its parent."""

    regs: torch.Tensor = None
    epoch: torch.Tensor = None
    am_queue: torch.Tensor = None       # (n, am_slots + 1, am_msg)
    am_info: torch.Tensor = None        # (n, am_slots + 1, 3)
    am_count: torch.Tensor = None
    #: the query's landing words: a request word and a handle table per rank
    query_req: torch.Tensor = None      # (n, 1) int32
    query_entry: torch.Tensor = None    # (n, 4) int32

    @classmethod
    def create_dynamic(cls, pool: torch.Tensor, axis: str, axis_size: int,
                       config: WindowConfig | None = None, *,
                       max_attach: int = 8, am_slots: int = 16,
                       am_msg: int | None = None,
                       device=None) -> "DynamicWindow":
        """A dynamic window over ``pool``, the stacked ``(n, P)`` attachable
        memory of every rank.  ``am_msg`` (default P) is one AM message's
        capacity.  ``device``: where the registration tables, epochs, AM
        queue and counters live (default the pool's).  A pool in pinned
        host memory under tables on the card is reached by K3 alone:
        handle puts and gets, and their flushes."""
        if pool.dim() != 2:
            raise ValueError(f"a dynamic window's pool is the stacked (n, P) "
                             f"memory of every rank, got {tuple(pool.shape)}")
        am_msg = pool.shape[1] if am_msg is None else am_msg
        if not 1 <= am_msg <= pool.shape[1] or max_attach < 1 or am_slots < 1:
            raise ValueError(f"need 1 <= am_msg <= {pool.shape[1]}, "
                             "max_attach >= 1 and am_slots >= 1")
        base = Window.allocate(pool, axis, axis_size, config, device=device)
        n, dev = axis_size, base.device
        i32 = dict(dtype=torch.int32, device=dev)
        return cls(base.substrate, base.config,
                   regs=torch.zeros((n, max_attach, 3), **i32),
                   epoch=torch.zeros(n, **i32),
                   am_queue=torch.zeros((n, am_slots + 1, am_msg),
                                        dtype=pool.dtype, device=dev),
                   am_info=torch.zeros((n, am_slots + 1, 3), **i32),
                   am_count=torch.zeros(n, **i32),
                   query_req=torch.zeros((n, 1), **i32),
                   query_entry=torch.zeros((n, 4), **i32))

    @property
    def max_attach(self) -> int:
        return self.regs.shape[1]

    @property
    def am_data(self) -> torch.Tensor:
        """The queued AM payloads ``(n, am_slots, am_msg)``."""
        return self.am_queue[:, :-1]

    @property
    def am_meta(self) -> torch.Tensor:
        """``[slot + 1, offset, size]`` of each queued AM ``(n, am_slots, 3)``."""
        return self.am_info[:, :-1]

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.max_attach:
            raise ValueError(f"registration slot {slot} outside the "
                             f"{self.max_attach} this window has")

    # -- attach / detach (local operations) ----------------------------------
    def attach(self, slot: int, offset: int, size: int) -> "DynamicWindow":
        """``MPI_Win_attach``: every rank registers ``pool[offset:offset +
        size]`` in ``slot`` under a new epoch."""
        self._check_slot(slot)
        self.epoch += 1
        self.regs[:, slot, 0].copy_(self.epoch)
        self.regs[:, slot, 1].fill_(offset)
        self.regs[:, slot, 2].fill_(size)
        return self

    def detach(self, slot: int) -> "DynamicWindow":
        """``MPI_Win_detach``: invalidate the slot; cached registrations of
        it go stale (epoch mismatch)."""
        self._check_slot(slot)
        self.regs[:, slot, 0].zero_()
        return self

    # -- slow path 1: query the registration from the target (Fig. 3b) ------
    def _query(self, perm: Perm, slot: int, stream: int) -> torch.Tensor:
        """The registration round trip: each origin's request word lands at
        its target (K3), the target's entry for ``slot`` comes back (K3 from
        the registration table) into the origin's handle row
        ``[epoch, offset, size, slot]``."""
        sub = self.substrate
        self.query_entry[:, 3].fill_(slot)
        sub._write_rows(self.query_entry[:, 3:], self.query_req, perm, stream)
        sub._write_rows(self.regs[:, slot], self.query_entry[:, :3],
                        [(t, s) for s, t in perm], stream)
        return self.query_entry

    def put_query(self, data: torch.Tensor, perm: Perm, *, slot: int,
                  seg_offset: int = 0, stream: int = 0) -> "DynamicWindow":
        """Put into an attached segment after querying its registration:
        the put lands at the entry's offset + ``seg_offset`` where the entry
        is still live (epoch unchanged and non-zero), and is dropped
        otherwise.  Three launches; five phases."""
        self._check_stream(stream)
        self._check_slot(slot)
        sub = self.substrate
        entry = self._query(perm, slot, stream)
        sub._write_rows(sub._payload(data), self.buffer, perm, stream,
                        offset=seg_offset, handles=entry, regs=self.regs)
        self._note(perm, stream, "put", 5)
        return self

    def get_query(self, perm: Perm, *, slot: int, seg_offset: int = 0,
                  size: int, stream: int = 0
                  ) -> tuple["DynamicWindow", torch.Tensor]:
        """Get from an attached segment via a registration query (no epoch
        check, as the reference): three launches; four phases."""
        self._check_stream(stream)
        self._check_slot(slot)
        entry = self._query(perm, slot, stream)
        data = self.substrate._read_rows(perm, size, stream,
                                         offset=seg_offset, handles=entry)
        self._note(perm, stream, "get", 4)
        return self, data

    # -- slow path 2: active-message emulation (Fig. 3c) ----------------------
    def put_am(self, data: torch.Tensor, perm: Perm, *, slot: int,
               seg_offset: int = 0, stream: int = 0) -> "DynamicWindow":
        """Put emulated with an active message: the payload (padded to one
        message) lands in the target's AM queue at its count, a device index
        (K3), with its header; the write happens only when the target
        :meth:`progress`-es.  Three phases."""
        self._check_stream(stream)
        self._check_slot(slot)
        sub = self.substrate
        n, am_msg = self.axis_size, self.am_queue.shape[2]
        size = data.shape[1]
        if data.dim() != 2 or data.shape[0] != n or size > am_msg:
            raise ValueError(f"AM payloads are stacked (n={n}, size <= "
                             f"{am_msg}), got {tuple(data.shape)}")
        payload = torch.nn.functional.pad(sub._payload(data),
                                          (0, am_msg - size))
        full = self.am_queue.shape[1] - 1
        tmap = sub._targets(perm).long().clamp(min=0)
        at = self.am_count.index_select(0, tmap).clamp(max=full)
        sub._write_rows(payload.view(n, 1, am_msg), self.am_queue, perm,
                        stream, disp=at.to(torch.int32))
        tg = sub.index([t for _, t in perm])
        row = self.am_count.index_select(0, tg).clamp(max=full).long()
        head = torch.empty((len(perm), 3), dtype=torch.int32,
                           device=self.regs.device)
        head[:, 0].fill_(slot + 1)
        head[:, 1].fill_(seg_offset)
        head[:, 2].fill_(size)
        self.am_info.index_put_((tg, row), head)
        self.am_count.index_add_(0, tg, torch.ones_like(tg, dtype=torch.int32))
        self._note(perm, stream, "put", 3)
        return self

    def progress(self) -> "DynamicWindow":
        """Target-side progress: drain the AM queue into the pool, slot by
        slot, each message at its registration's offset + its own, placed
        as the reference's dynamic slices place it (a negative offset counts
        from the end once, then clamps); then empty the queue.  Masked
        device writes; no phase."""
        buf = self.buffer
        n, am_msg = self.axis_size, self.am_queue.shape[2]
        ranks = torch.arange(n, device=buf.device)
        elem = torch.arange(am_msg, device=buf.device)
        for i in range(self.am_queue.shape[1] - 1):
            info = self.am_info[:, i].long()
            valid = (self.am_count > i) & (info[:, 0] > 0)
            slot = (info[:, 0] - 1).clamp(0, self.max_attach - 1)
            off = self.regs[ranks, slot, 1].long() + info[:, 1]
            off = torch.where(off < 0, off + buf.shape[1], off).clamp(
                0, buf.shape[1] - am_msg)
            idx = off[:, None] + elem
            cur = buf.gather(1, idx)
            keep = valid[:, None] & (elem < info[:, 2:3])
            buf.scatter_(1, idx, torch.where(keep, self.am_queue[:, i], cur))
        self.am_info.zero_()
        self.am_count.zero_()
        return self

    def flush_am(self, perm: Perm, stream: int = 0) -> "DynamicWindow":
        """Flush for AM-path operations: one ack round trip that completes
        only after the target progressed (2 phases); on the card, the wait
        on the stream's completion counters."""
        self.substrate._wait(stream)
        self.ledger.bill("flush", 2)
        return self

    def _note(self, perm: Perm, stream: int, kind: str, phases: int) -> None:
        """Bill the method's phases (to the tier its perm rides) and queue
        it for the next flush — the reference queues every dynamic-window
        operation, node-local or not."""
        self.ledger.bill(kind, phases, shm=self._shm(perm))
        self.group.note_op(stream, perm)


__all__ = ["DynamicWindow"]
