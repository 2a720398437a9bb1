"""The op-specialized accumulate engine — crossover routing over the substrate.

Applications that *declare* their accumulate usage let the implementation
specialize the dispatch (paper §2.3).  Every ``Window.accumulate`` and every
routed ring hop flows through :func:`route`, which picks one of three paths:

``intrinsic``
    Declared single-op usage, count at or below the **crossover**: origin
    atomics on the target row (kernel K2), one phase.
``tiled``
    Declared usage above the crossover, or a dtype/op outside the atomic
    envelope: the bandwidth path — the update lands (K3) and K1 folds it
    into the target rows, one phase.
``software``
    Undeclared usage: the conservative path, the target runtime folds the
    update and the origin pays a completion ack (two phases).

The crossover resolves in the JAX package's order: ``RMA_ACC_CROSSOVER`` >
``WindowConfig.max_atomic_elems`` > this port's own calibration file
(``benchmarks_torch/results/BENCH_acc_latency_h100.json``, or
``$RMA_TORCH_ACC_BENCH_JSON``) > the hardware envelope.  The port never
reads the JAX package's calibration artifact: a crossover measured for
another machine says nothing about this card.
"""
from __future__ import annotations

import functools
import json
import os
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.core.rma.intrinsic import INTRINSIC_MAX_COUNT, op_is_intrinsic
from repro_torch.kernels.accumulate import accumulate_rows
from repro_torch.kernels.common import ACC_OPS, ATOMIC_KERNEL_OPS, combine_op

Perm = Sequence[tuple[int, int]]

PATH_INTRINSIC = "intrinsic"
PATH_TILED = "tiled"
PATH_SOFTWARE = "software"

#: Ops the tiled kernel (K1) implements.
TILED_OPS = frozenset(ACC_OPS)

_calibration_cache: dict[str, int | None] = {}


def apply_op(current: torch.Tensor, update: torch.Tensor, op: str
             ) -> torch.Tensor:
    """Element-wise combine for one accumulate op (the kernels' shared op
    table, with the update cast to the current value's dtype)."""
    return combine_op(current, update.to(current.dtype), op)


@functools.cache
def _repo_bench_json() -> str:
    """The calibration artifact's path in this checkout, resolved once (a
    resolution is a few filesystem calls, which every routed accumulate and
    doorbell would otherwise pay)."""
    root = Path(__file__).resolve().parents[4]
    return str(root / "benchmarks_torch" / "results"
               / "BENCH_acc_latency_h100.json")


def _default_bench_json() -> str:
    return os.environ.get("RMA_TORCH_ACC_BENCH_JSON") or _repo_bench_json()


def calibrated_crossover(path: str | None = None) -> int | None:
    """The crossover parsed from an ``acc_latency`` artifact: the largest
    count at which the intrinsic path is still within 10% of the tiled one
    (0: measured, and intrinsic never wins; ``None``: no artifact).  The
    default path's parse is cached per resolved path for the process."""
    if path is not None:
        return _parse_crossover(path)
    resolved = _default_bench_json()
    if resolved not in _calibration_cache:
        _calibration_cache[resolved] = _parse_crossover(resolved)
    return _calibration_cache[resolved]


def _parse_crossover(path: str) -> int | None:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    by_path: dict[str, dict[int, float]] = {PATH_INTRINSIC: {}, PATH_TILED: {}}
    for row in doc.get("rows", []):
        parts = str(row.get("name", "")).split("/")
        if len(parts) != 3 or parts[0] != "acc_latency":
            continue
        variant, count = parts[1], parts[2]
        if variant in by_path and count.isdigit():
            by_path[variant][int(count)] = float(row["us_per_call"])
    common = sorted(set(by_path[PATH_INTRINSIC]) & set(by_path[PATH_TILED]))
    if not common:
        return None
    crossover = 0
    for count in common:
        if by_path[PATH_INTRINSIC][count] <= 1.1 * by_path[PATH_TILED][count]:
            crossover = count
        else:
            break
    return crossover


def crossover_elems(config=None) -> int:
    """The element count at or below which declared accumulates route to the
    intrinsic path: env override > declared ``max_atomic_elems`` >
    calibration > hardware envelope.  A performance threshold only; the
    capability threshold is :func:`declared_envelope`."""
    env = os.environ.get("RMA_ACC_CROSSOVER")
    if env:
        return int(env)
    if config is not None and config.max_atomic_elems is not None:
        return config.max_atomic_elems
    calibrated = calibrated_crossover()
    return calibrated if calibrated is not None else INTRINSIC_MAX_COUNT


def declared_envelope(config=None) -> int:
    """The atomic-envelope capability threshold: the declared
    ``max_atomic_elems``, else the hardware envelope.  ``win_op_intrinsic``
    answers with it and ``assert_accumulate_intrinsic`` checks against it."""
    if config is not None and config.max_atomic_elems is not None:
        return config.max_atomic_elems
    return INTRINSIC_MAX_COUNT


def route(op: str, count: int, dtype, config) -> str:
    """Pick the path for one accumulate.  Raises on declaration violations:
    an op other than the declared ``same_op``, or an asserted-intrinsic
    accumulate outside the envelope."""
    if config.same_op is not None and op != config.same_op:
        raise ValueError(
            f"window declares same_op={config.same_op!r} but an accumulate "
            f"with op={op!r} was issued — declaration violation (undefined "
            "behaviour per paper §2.3); dup the window with the right hint")
    if config.assert_accumulate_intrinsic:
        if not op_is_intrinsic(op, count, dtype, declared_envelope(config)):
            raise ValueError(
                "window asserts accumulate-intrinsic usage but "
                f"op={op!r} count={count} dtype={dtype} is outside the "
                "hardware envelope (undefined behaviour per paper §2.3); "
                "query win_op_intrinsic() first")
        return PATH_INTRINSIC
    if config.same_op is None:
        return PATH_SOFTWARE
    return (PATH_INTRINSIC
            if op_is_intrinsic(op, count, dtype, crossover_elems(config))
            else PATH_TILED)


#: Package-level alias.
route_accumulate = route


def path_combine(path: str, op: str):
    """The fold a routed path applies at the target: ``combine(region,
    landed)`` updates ``region`` (rows of a window) in place.  ``tiled``
    folds through K1; the software path's target runtime folds with plain
    tensor ops.  (The intrinsic path has no target-side fold: K2's atomics
    come from the origin.)"""
    if path == PATH_TILED:
        return lambda region, landed: accumulate_rows(region, landed, op=op)

    def combine(region, landed):
        region.copy_(apply_op(region, landed, op))
        return region

    return combine


def routed_accumulate(win, data: torch.Tensor, perm: Perm, *,
                      op: str = "sum", offset=0, stream: int = 0):
    """Dispatch one accumulate through the router; ``data`` is stacked, so
    the count routed on is one rank's payload size."""
    path = route(op, int(data[0].numel()), data.dtype, win.config)
    return win._accumulate_path(path, data, perm, op=op, offset=offset,
                                stream=stream)


def default_flag_value(op: str, dtype) -> torch.Tensor:
    """A one-element flag payload that observably changes a zeroed flag word
    under ``op`` where one exists: −1 for min on signed/float dtypes, else
    1 (prod and band have none; callers pre-set the word)."""
    from repro_torch.kernels.common import as_dtype

    dt = as_dtype(dtype)
    if op == "min" and (dt.is_floating_point or dt.is_signed):
        return torch.full((1,), -1, dtype=dt)
    return torch.ones((1,), dtype=dt)


def accumulate_signal(win, data: torch.Tensor, perm: Perm, *,
                      op: str = "sum", data_offset=0, flag_offset: int,
                      flag_value=None, stream: int = 0):
    """Fused accumulate-with-signal: land an update and then its completion
    flag, both routed through the engine (on a ``same_op`` window the flag
    uses the declared op).  Under P2 the flag follows the update on the
    ordered stream with no flush, and an op of the atomic set runs as one
    K6 launch (``kernels.ordered_put_signal``) billed as the two routed
    accumulates; without P2 a flush separates them.  ``flag_value``:
    stacked ``(n, 1)``, default :func:`default_flag_value` for every
    rank."""
    flag_op = win.config.same_op if win.config.same_op is not None else "sum"
    if flag_value is None:
        one = default_flag_value(flag_op, win.buffer.dtype)
        flag_value = one.to(win.buffer.device).expand(win.axis_size, 1)
    if win.config.order and op in ATOMIC_KERNEL_OPS:
        win._check_stream(stream)
        path = route(op, int(data[0].numel()), data.dtype, win.config)
        flag_path = route(flag_op, int(flag_value[0].numel()),
                          win.buffer.dtype, win.config)
        win.substrate.acc_signal(
            data, perm, op, path=path, offset=data_offset, flag=flag_value,
            flag_offset=flag_offset, flag_op=flag_op, flag_path=flag_path,
            stream=stream, shm=win._shm(perm))
        return win
    win = routed_accumulate(win, data, perm, op=op, offset=data_offset,
                            stream=stream)
    if not win.config.order:
        win = win.flush(stream if win.config.scope == "thread" else None)
    return routed_accumulate(win, flag_value, perm, op=flag_op,
                             offset=flag_offset, stream=stream)


def acc_hop(sub, config, cur: torch.Tensor, piece: torch.Tensor, perm: Perm,
            *, op: str = "sum", stream: int = 0):
    """One reduce-ring hop routed through the engine: send ``piece`` along
    ``perm`` and combine what each rank receives into ``cur``.  A declared
    same-op ring is one data phase; an undeclared one also pays the per-hop
    completion ack.  Returns ``(substrate, new)``."""
    path = route(op, int(piece[0].numel()), piece.dtype, config)
    sub, recvd = sub.channel_send(piece, perm, stream=stream)
    if path == PATH_SOFTWARE:
        sub = sub.target_ack(perm, stream=stream)
    return sub, apply_op(cur, recvd, op)


__all__ = [
    "PATH_INTRINSIC", "PATH_TILED", "PATH_SOFTWARE", "TILED_OPS", "apply_op",
    "route", "route_accumulate", "path_combine", "routed_accumulate",
    "accumulate_signal", "default_flag_value", "acc_hop", "crossover_elems",
    "declared_envelope", "calibrated_crossover",
]
