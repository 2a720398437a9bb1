"""P3 — hardware-accumulate capability model and query (paper §2.3).

``win_op_intrinsic`` answers: will this set of accumulate operations, on up
to ``max_count`` elements of this datatype, be executed by hardware intrinsic
to the origin (NIC atomics — on one card, the atomics of kernel K2)?

The envelope is the JAX package's, unchanged: 32/64-bit integral and
floating types only (no bf16/f16 atomics, although Hopper has some), a small
op set, and a small element-count threshold beyond which the bandwidth path
wins.  The numbers are configuration: tests and the runtime share them.
"""
from __future__ import annotations

from repro_torch.kernels.common import as_dtype

#: Ops the "NIC" executes natively (second half of MPI_Op names, paper §2.3).
INTRINSIC_OPS = frozenset(
    {"sum", "min", "max", "replace", "cas", "band", "bor", "bxor", "no_op"}
)

#: 32/64-bit types only: hardware atomics do not cover short floats.
INTRINSIC_DTYPES = frozenset(
    {"int32", "uint32", "int64", "uint64", "float32", "float64"}
)

#: Element-count threshold for the latency->bandwidth switch.
INTRINSIC_MAX_COUNT = 8


def _dtype_name(dtype) -> str | None:
    try:
        return str(as_dtype(dtype)).removeprefix("torch.")
    except TypeError:
        return None


def op_is_intrinsic(op: str, count: int, dtype,
                    max_count: int = INTRINSIC_MAX_COUNT) -> bool:
    """Single-op form of the envelope predicate — the one definition the
    public query and the engine's routing/assert checks all share.
    ``max_count``: the count threshold in effect (the platform envelope by
    default, or a window's resolved crossover)."""
    name = _dtype_name(dtype)
    return (op in INTRINSIC_OPS and name in INTRINSIC_DTYPES
            and count <= max_count)


def win_op_intrinsic(ops: str, max_count: int, dtype, win=None) -> bool:
    """``MPI_Win_op_intrinsic`` (paper Listing 3).

    ``ops``: comma-delimited operations (e.g. ``"sum,replace,cas"``);
    ``max_count``: the largest element count per accumulate; ``win``:
    optional window whose declared atomic envelope (``max_atomic_elems``)
    replaces the platform-wide one.  True iff all listed operations on up to
    ``max_count`` elements of ``dtype`` run as origin-intrinsic hardware
    operations."""
    parsed = [o.strip() for o in ops.split(",") if o.strip()]
    if not parsed:
        raise ValueError("empty operation list")
    threshold = INTRINSIC_MAX_COUNT
    if win is not None:
        from repro_torch.core.rma.accumulate import declared_envelope

        threshold = declared_envelope(win.config)
    return all(op_is_intrinsic(o, max_count, dtype, threshold) for o in parsed)


__all__ = ["win_op_intrinsic", "op_is_intrinsic", "INTRINSIC_OPS",
           "INTRINSIC_DTYPES", "INTRINSIC_MAX_COUNT"]
