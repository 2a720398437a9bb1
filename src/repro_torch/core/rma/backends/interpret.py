"""The plan walker — a compiled schedule run on stacked tensors by plain
indexing, as the conformance suite's independent second opinion.

``CompiledPlan.execute`` replays a schedule on the substrate (kernels
K1–K6, the completion counters, the phase ledger).  This module runs the
**same schedule** with none of that: every window buffer and binding is
the stacked ``(n, ...)`` tensor of all ranks, and each op is applied in
schedule order with the transport semantics the substrate documents, by
plain torch indexing on the tensors' own device.  It imports nothing from
the substrate or the kernels.

* ``put``      — targets receive the origin's payload cast to the buffer
  dtype at the origin's displacement.
* ``get``      — origins receive the target's rows (buffer dtype); ranks
  that are no origin read zeros.
* ``send``     — a raw transfer, no cast; non-targets read zeros.
* ``hop``      — ``send``, then ``cur op= received`` at every rank.
* ``accumulate``/``signal`` — read-modify-write with the op's combine,
  cast to the buffer dtype (a signal's default payload is the op-aware
  flag value).
* ``fetch_op`` — the old rows are captured per origin, then folded.
* ``compute``  — the recorded closure, run once on the stacked env
  (``env.ranks`` is the rank vector, as on the substrate).
* flush and entry epochs — nothing: a walked write is complete at once.
* ``gspmd`` steps — :func:`~repro_torch.core.rma.backends.gspmd.host_macro`.
* ``put_handle``/``get_handle`` — only with ``regs`` (stacked ``(n, slots,
  3)`` registration tables, one per handle window): the slot comes from the
  origin's handle, its epoch is checked against the target's live
  registration, a stale put is dropped and a stale get reads zeros, each
  counted in the target's ``err_count``.  Without ``regs`` they raise
  ``NotImplementedError``.

A displacement is placed as ``lax.dynamic_update_slice`` places one: a
negative one counts from the end of the window row once, then it is
clamped to the row.

:func:`vmapped_execute` is the other side of the comparison: the real
``CompiledPlan.execute`` on windows allocated over the same stacked
buffers.  The tests hold the two to each other bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.rma.plan import OpRef, PlanError


@dataclasses.dataclass
class InterpretResult:
    """Final stacked window buffers, named outputs, and the per-rank
    stale-handle counter (counted at the target; nonzero only for handle
    ops walked with ``regs``)."""

    buffers: dict[str, torch.Tensor]
    outputs: dict[str, torch.Tensor]
    err_count: torch.Tensor


def _combine(cur: torch.Tensor, upd: torch.Tensor, op: str) -> torch.Tensor:
    upd = upd.to(cur.dtype)
    if op == "sum":
        return cur + upd
    if op == "min":
        return torch.minimum(cur, upd)
    if op == "max":
        return torch.maximum(cur, upd)
    if op == "prod":
        return cur * upd
    if op == "band":
        return cur & upd
    if op == "bor":
        return cur | upd
    if op == "bxor":
        return cur ^ upd
    if op == "replace":
        return upd.clone()
    raise ValueError(f"unsupported accumulate op {op!r}")


def _flag_value(op: str, dtype: torch.dtype, device) -> torch.Tensor:
    """The op-aware default flag word: -1 for min on a signed dtype, else
    1."""
    signed = dtype.is_floating_point or dtype.is_signed
    return torch.full((1,), -1 if op == "min" and signed else 1,
                      dtype=dtype, device=device)


def _static(offset) -> bool:
    return isinstance(offset, int) and not isinstance(offset, bool)


def _place(start: int, rows: int, span: int) -> int:
    """Where ``rows`` rows at ``start`` land in a ``span``-row window row."""
    if start < 0:
        start += span
    return min(max(start, 0), span - rows)


class _StackedEnv:
    """What a recorded closure sees (duck-types ``PlanEnv``): earlier
    results by :class:`OpRef`, bindings by name, window buffers, and the
    rank vector."""

    def __init__(self, bindings, values, buffers, n: int, device):
        self.bindings = bindings
        self.values = values
        self._buffers = buffers
        self.n = n
        self.ranks = torch.arange(n, device=device)

    def __getitem__(self, key):
        if isinstance(key, OpRef):
            return self.values[key.idx]
        return self.bindings[key]

    def buffer(self, window: str) -> torch.Tensor:
        return self._buffers[window]


class _Walker:
    def __init__(self, compiled, buffers, bindings, regs=None):
        self.c = compiled
        self.buffers = {k: v.clone() for k, v in buffers.items()}
        self.bindings = dict(bindings or {})
        self.regs = dict(regs or {})
        wnames = list(compiled.windows)
        for wname in wnames:
            if wname not in self.buffers:
                raise PlanError(f"interpret() missing window buffer {wname!r}")
        first = self.buffers[wnames[0]]
        self.n = int(first.shape[0])
        for bname, (shape, dt) in compiled.bindings.items():
            if bname not in self.bindings:
                raise PlanError(f"interpret() missing binding {bname!r}")
            got = self.bindings[bname]
            if tuple(got.shape) != (self.n,) + shape or got.dtype != dt:
                raise PlanError(
                    f"binding {bname!r} expects stacked shape="
                    f"{(self.n,) + shape} dtype={dt}, got "
                    f"shape={tuple(got.shape)} dtype={got.dtype}")
        self.values: dict[int, torch.Tensor] = {}
        self.env = _StackedEnv(self.bindings, self.values, self.buffers,
                               self.n, first.device)
        self.errs = torch.zeros(self.n, dtype=torch.int32,
                                device=first.device)

    def resolve(self, spec):
        if isinstance(spec, OpRef):
            return self.values[spec.idx]
        if isinstance(spec, str):
            return self.bindings[spec]
        if callable(spec):
            return spec(self.env)
        return spec

    def _off_at(self, off, rank: int) -> int:
        """The displacement origin ``rank`` computed."""
        if _static(off):
            return off
        return int(torch.as_tensor(off).reshape(self.n, -1)[rank, 0])

    def _write(self, wname, perm, data, off):
        buf = self.buffers[wname]
        for s, t in perm:
            d = data[s].to(buf.dtype)
            at = _place(self._off_at(off, s), d.shape[0], buf.shape[1])
            buf[t, at:at + d.shape[0]] = d

    def _exec_comm(self, o):
        decl = self.c.windows[o.window]
        buf = self.buffers[o.window]
        off = o.offset if _static(o.offset) else self.resolve(o.offset)
        span = buf.shape[1]
        if o.kind == "put":
            self._write(o.window, o.perm, self.resolve(o.source), off)
        elif o.kind == "get":
            res = buf.new_zeros((self.n, o.size) + tuple(buf.shape[2:]))
            for s, t in o.perm:
                at = _place(self._off_at(off, s), o.size, span)
                res[s] = buf[t, at:at + o.size]
            self.values[o.idx] = res
        elif o.kind in ("send", "hop"):
            data = self.resolve(o.source)
            recvd = torch.zeros_like(data)
            for s, t in o.perm:
                recvd[t] = data[s]
            self.values[o.idx] = (recvd if o.kind == "send" else
                                  _combine(self.resolve(o.cur), recvd, o.op))
        elif o.kind in ("accumulate", "signal"):
            if o.kind == "signal":
                op_name = decl.same_op if decl.same_op is not None else "sum"
                data = self.resolve(o.value)
                if data is None:
                    data = _flag_value(op_name, buf.dtype, buf.device
                                       ).expand(self.n, 1)
            else:
                op_name, data = o.op, self.resolve(o.source)
            for s, t in o.perm:
                m = data.shape[1]
                at = _place(self._off_at(off, s), m, span)
                cur = buf[t, at:at + m]
                buf[t, at:at + m] = _combine(cur, data[s], op_name)
        elif o.kind == "fetch_op":
            data = self.resolve(o.source)
            old = buf.new_zeros((self.n,) + tuple(data.shape[1:]))
            for s, t in o.perm:
                m = data.shape[1]
                at = _place(self._off_at(off, s), m, span)
                cur = buf[t, at:at + m].clone()
                old[s] = cur
                buf[t, at:at + m] = _combine(cur, data[s], o.op)
            self.values[o.idx] = old
        elif o.kind in ("put_handle", "get_handle"):
            regs = self.regs.get(o.window)
            if regs is None:
                raise NotImplementedError(
                    "the interpret backend does not model P5 memory-handle "
                    "headers (live registration state); execute "
                    f"{o.kind} plans on the rma backend, or pass "
                    "regs={window: stacked (n, slots, 3) registration "
                    "tables} to interpret() to model them")
            handle = self.resolve(o.handle)              # stacked (n, 4)
            if o.kind == "put_handle":
                data = self.resolve(o.source).to(buf.dtype)
                size = data.shape[1]
            else:
                size = o.size
                res = buf.new_zeros((self.n, size) + tuple(buf.shape[2:]))
            for s, t in o.perm:
                epoch, hoff, _, slot = (int(v) for v in handle[s])
                slot = min(max(slot, 0), regs.shape[1] - 1)
                live = int(regs[t, slot, 0])
                fresh = epoch == live and live > 0
                at = _place(hoff + self._off_at(off, s), size, span)
                if fresh and o.kind == "put_handle":
                    buf[t, at:at + size] = data[s]
                elif fresh:
                    res[s] = buf[t, at:at + size]
                if not fresh:
                    self.errs[t] += 1
            if o.kind == "get_handle":
                self.values[o.idx] = res
        else:
            raise AssertionError(o.kind)

    def run(self) -> InterpretResult:
        from repro_torch.core.rma.backends.gspmd import host_macro

        for step in self.c.steps:
            if step.kind in ("entry", "flush"):
                continue
            if step.kind == "gspmd":
                self.values.update(host_macro(step.macro, self.resolve))
                continue
            if step.kind == "fused":
                for o in step.group:
                    self._write(o.window, o.perm, self.resolve(o.source),
                                o.offset)
                continue
            o = step.op
            if o.kind == "compute":
                self.values[o.idx] = o.fn(self.env)
                continue
            self._exec_comm(o)
        outputs = {name: self.resolve(spec) for name, spec in self.c.outputs}
        return InterpretResult(buffers=dict(self.buffers), outputs=outputs,
                               err_count=self.errs)


def interpret_plan(compiled, buffers, bindings=None, *, axis: str = "x",
                   regs=None) -> InterpretResult:
    """Walk ``compiled`` on stacked tensors (see the module docstring).

    ``buffers`` maps every plan window to its stacked ``(n, ...)`` initial
    contents (copied, never written); ``bindings`` fills the declared
    placeholders with stacked ``(n, *shape)`` tensors.  ``axis`` is the
    plan's axis name (the stacked closures read ``env.ranks``, not it).
    ``regs`` maps handle windows to stacked ``(n, slots, 3)``
    registration tables and enables the handle ops' lifetime model."""
    del axis
    return _Walker(compiled, buffers, bindings, regs).run()


def vmapped_execute(compiled, buffers, bindings=None, *,
                    axis: str = "x") -> InterpretResult:
    """The real ``CompiledPlan.execute`` — substrate, kernels, ledger — on
    windows allocated over copies of the stacked ``buffers``: the oracle
    :func:`interpret_plan` is held to (the JAX package runs its substrate
    under ``vmap`` for the same purpose)."""
    from repro_torch.core.rma.window import Window

    wnames = list(compiled.windows)
    n = int(buffers[wnames[0]].shape[0])
    views = {w: Window.allocate(buffers[w].clone().contiguous(), axis, n,
                                decl.config())
             for w, decl in compiled.windows.items()}
    res = compiled.execute(views, dict(bindings or {}))
    return InterpretResult(
        buffers={w: v.buffer for w, v in res.windows.items()},
        outputs=dict(res.outputs), err_count=res.err_count.reshape(n))


__all__ = ["InterpretResult", "interpret_plan", "vmapped_execute"]
