"""Calibrated backend selection for plan lowering (``backend="auto"``).

The paper's declare-and-specialize loop closed at the pattern level: each
recognized macro (ring all-reduce, all-to-all) is measured on every backend
that can lower it, and ``compile(backend="auto")`` picks the fastest target
per macro from that table.

The table is this port's own, measured on the card:
``benchmarks_torch/results/BENCH_backends_h100.json``, or the file named by
``RMA_TORCH_BACKEND_BENCH_JSON``.  Its rows are named
``backend_matrix/<pattern>/<backend>`` with a ``us_per_call`` each (the
JAX package's artifact format).  The port never reads the JAX package's
``benchmarks/results/BENCH_backends.json``: latencies of another machine
say nothing about this card.

Robustness contract: a missing, corrupt or incomplete table never fails a
compile — :func:`choose` falls back to the RMA substrate and emits one
:class:`UserWarning` per table path per process.
"""
from __future__ import annotations

import functools
import json
import os
import warnings
from pathlib import Path

#: Backends ``auto`` may pick between.  The interpret backend is excluded:
#: it is a conformance harness, not a lowering target.
AUTO_CANDIDATES = ("rma", "gspmd")

_cache: dict[str, dict | None] = {}
_warned: set[str] = set()


@functools.cache
def _repo_bench_json() -> str:
    root = Path(__file__).resolve().parents[5]
    return str(root / "benchmarks_torch" / "results"
               / "BENCH_backends_h100.json")


def _default_bench_json() -> str:
    return os.environ.get("RMA_TORCH_BACKEND_BENCH_JSON") or \
        _repo_bench_json()


def _parse(path: str) -> dict | None:
    """``{pattern: {backend: us_per_call}}`` from the table, or None."""
    try:
        with open(path) as f:
            doc = json.load(f)
        table: dict[str, dict[str, float]] = {}
        for row in doc["rows"]:
            parts = row["name"].split("/")
            if len(parts) != 3 or parts[0] != "backend_matrix":
                continue
            _, pattern, backend = parts
            table.setdefault(pattern, {})[backend] = float(row["us_per_call"])
        return table
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


def load_table(path: str | None = None) -> dict | None:
    """The parsed latency table, cached per resolved path."""
    resolved = path if path is not None else _default_bench_json()
    if resolved not in _cache:
        _cache[resolved] = _parse(resolved)
    return _cache[resolved]


def _warn_once(path: str, why: str) -> None:
    if path in _warned:
        return
    _warned.add(path)
    warnings.warn(
        f"backend='auto' falling back to the RMA substrate: {why} ({path}) "
        "— measure the backend matrix on the card to calibrate (ROADMAP "
        "queue 1, item 6)", UserWarning, stacklevel=3)


def choose(pattern: str, path: str | None = None) -> tuple[str, str]:
    """Pick the lowering target of one macro ``pattern`` ("ring"/"a2a").

    Returns ``(target, reason)`` with ``target in AUTO_CANDIDATES``.  Never
    raises: a missing, corrupt or incomplete table yields ``("rma", ...)``
    with one warning per path."""
    resolved = path if path is not None else _default_bench_json()
    table = load_table(resolved)
    if table is None:
        _warn_once(resolved, "no readable BENCH_backends_h100.json")
        return "rma", "no calibration artifact; rma is the safe default"
    row = table.get(pattern, {})
    missing = [b for b in AUTO_CANDIDATES if b not in row]
    if missing:
        _warn_once(resolved, f"pattern {pattern!r} lacks rows for {missing}")
        return "rma", f"incomplete calibration for {pattern!r}"
    best = min(AUTO_CANDIDATES, key=lambda b: row[b])
    return best, (f"measured {row[best]:.1f}us on {best} vs " +
                  ", ".join(f"{row[b]:.1f}us on {b}"
                            for b in AUTO_CANDIDATES if b != best))


__all__ = ["AUTO_CANDIDATES", "choose", "load_table"]
