"""Spans of the program's own host work, kept in memory.

``with span("serve.decode", rows=32): ...`` records ``Span(name, t0, t1,
parent, attrs)``: ``t0`` and ``t1`` are ``time.perf_counter()`` readings,
``parent`` the index (in :func:`spans`) of the span open on this thread
when it began, ``attrs`` host values only (request ids, token counts).

Spans record while someone traces: inside :func:`recording`, or while a
``torch.profiler`` profile records (one check a span).  Otherwise
:func:`span` returns one shared no-op context, which reads no clock and
keeps nothing.  A span never synchronizes the device, reads no device
value and emits no profiler range or NVTX mark, so a device trace holds
nothing of it; since the profiler stamps its events on the same
monotonic clock, spans and the device's intervals can be laid side by
side.  Records stay in memory until :func:`clear`; nothing is written
out.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

_profiling = getattr(torch.autograd, "_profiler_enabled", lambda: False)
_records: list = []
_local = threading.local()
_lock = threading.Lock()
_forced = 0


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    parent: int | None
    attrs: dict


class _Open:
    """A span being recorded: enter stamps ``t0`` and pushes it on this
    thread's stack, exit stamps ``t1``.  ``attrs`` may be filled inside
    the span."""

    __slots__ = ("name", "attrs", "t0", "t1", "parent")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.t1 = name, attrs, None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        _records.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        _local.stack.pop()
        return False


class _Off:
    """The shared no-op span; false, so ``if sp:`` skips work for attrs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context that records one span while recording is on, else the
    shared no-op."""
    if _forced or _profiling():
        return _Open(name, attrs)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with or without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def spans() -> list[Span]:
    """Every finished span since the last :func:`clear`, in the order they
    began; a parent still open (or cleared) reads as ``None``."""
    done = [r for r in list(_records) if r.t1 is not None]
    index = {id(r): i for i, r in enumerate(done)}
    return [Span(r.name, r.t0, r.t1,
                 index.get(id(r.parent)) if r.parent is not None else None,
                 r.attrs) for r in done]


def clear() -> None:
    """Drop every record (spans still open are closed but not kept)."""
    _records.clear()


__all__ = ["Span", "span", "recording", "spans", "clear"]
