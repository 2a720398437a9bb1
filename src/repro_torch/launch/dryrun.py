"""Dry-run of every (arch × shape × mesh) cell on the ``meta`` device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --both-meshes --out out.jsonl

A cell is built shape-only (``specs.build_cell``: parameters, optimizer
state, batch and cache as ``meta`` tensors with their shardings over the
16×16 or 2×16×16 mesh of ``launch.mesh``), and its step runs once on
``meta`` at global shapes.  The record keeps the JAX package's keys, and its
numbers differ from the reference's in three ways.  Per-device values are
global values divided by ``chips`` (``per_device``): the port has no SPMD
partitioner, so nothing says how a step's work and temporaries split over
the devices except the even split; only ``bytes_per_device.arguments`` is
exact — the sum of each argument leaf's ``shard_shape`` bytes — and
``peak`` (arguments plus the run's transient high-water mark over
``chips``) is an estimate.  FLOPs are the dot FLOPs that
``torch.utils.flop_counter.FlopCounterMode`` counts (the rule
``hlo_analysis.analyze`` applies to HLO), and traffic is eager PyTorch's:
each dispatched op's operand and result bytes, views excluded — no fusion.
And with no partitioner there are no placed collectives: under
``--grad-sync gspmd`` ``collectives`` is ``null`` (its reason beside it) and
the roofline's collective term unknown; under ``--grad-sync rma_ring`` the
ring's phases and bytes come from the port's compiled plan for the
data-parallel ranks (``CompiledPlan.phases``, the reference cost model),
without executing the substrate on ``meta``.  ``--save-hlo`` is refused:
there is no HLO.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
import weakref

import torch
from torch.utils._mode_utils import no_dispatch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (SHAPES, ShapeConfig, cell_is_runnable,
                                 get_config, list_archs)
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.launch.specs import build_cell, meta_tensors, sds_leaves
from repro_torch.sharding import Mesh, use_rules

#: the optimizer's update slice on ``meta`` is this many devices' slices
#: (one device's slice on a 16×16 mesh), so the run's transient over
#: ``chips`` is one device's; the two production meshes share one run
SLICE_DEVICES = 256

NO_COLLECTIVES = ("no SPMD partitioner: a gspmd step's collectives are not "
                  "placed, so neither counted nor timed")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _meta_key(x):
    """A hashable key of an op's arguments: a ``meta`` tensor by its shape,
    strides and dtype (no values exist; a storage offset shapes no
    result); ``TypeError`` for anything else that cannot be a key (a
    tensor off ``meta`` included)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError("not a meta tensor")
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in sorted(x.items()))
    hash(x)
    return x


def _spec_of(out):
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return ("L", type(out), tuple(_spec_of(v) for v in out))
    return ("V", out)


def _from_spec(spec):
    """Fresh ``meta`` tensors of a remembered result (made below every
    dispatch mode: they are no op of the program)."""
    with no_dispatch():
        return _build(spec)


def _build(spec):
    if spec[0] == "T":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3],
                                   device="meta")
    if spec[0] == "L":
        return spec[1](_build(v) for v in spec[2])
    return spec[1]


class TrafficMode(TorchDispatchMode):
    """Eager traffic and live memory of a run: every dispatched op adds its
    tensor operands' and results' bytes to ``traffic`` (a view op moves
    nothing; an allocation without a fill writes nothing), and each new
    storage counts into ``live`` until its tensor dies; ``high`` is
    ``live``'s high-water mark.  A kernel wrapper's plain version on
    ``meta`` (``kernels.common.plain``) counts as the kernel the card
    runs: its operands and results once, none of its temporaries."""

    def __init__(self, flop_counter: FlopCounterMode | None = None):
        super().__init__()
        self._flops = (flop_counter.get_total_flops if flop_counter
                       is not None else (lambda: 0))
        self.traffic = 0
        self.live = 0
        self.high = 0
        self.ops = 0
        self.kernels = 0
        self._inside = 0
        self._memo: dict = {}

    def __enter__(self):
        from repro_torch.kernels import common

        common.META_KERNEL_OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import common

        common.META_KERNEL_OBSERVERS.remove(self)
        return super().__exit__(*exc)

    def kernel_enter(self) -> None:
        self._inside += 1

    def kernel_exit(self, operands, results) -> None:
        self._inside -= 1
        if self._inside or results is None:
            return
        self.kernels += 1
        self.traffic += sum(_nbytes(t) for t in _tensors(operands)) + sum(
            _nbytes(t) for t in _tensors(results))
        self._allocated(results)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _allocated(self, out) -> None:
        for t in _tensors(out):
            nb = t.untyped_storage().nbytes()
            self.live += nb
            self.high = max(self.high, self.live)
            weakref.finalize(t, self._free, nb)

    def _run(self, func, args, kwargs, aliased: bool, writes: bool):
        """``func`` on ``meta`` tensors, its result shapes remembered: a
        functional op seen before with the same operand shapes, strides and
        arguments is answered by fresh ``meta`` tensors of the remembered
        shapes, an in-place one by its ``self`` (the same shape check
        passed before) — a ``meta`` kernel costs ~0.1 ms of Python a call
        and a full-depth step runs ~10^5 of them.  An op the FLOP counter
        below counted is never answered from the memo."""
        if aliased and not writes:
            with no_dispatch():                      # a view: no FLOPs
                return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
        except TypeError:                            # unhashable argument
            return func(*args, **kwargs)
        spec = self._memo.get(key)
        if spec is None:
            before = self._flops()
            out = func(*args, **kwargs)
            if self._flops() != before:
                pass                                 # a dot: always run
            elif not writes:
                self._memo[key] = _spec_of(out)
            elif func._schema.name.endswith("_") and len(
                    func._schema.returns) == 1:
                self._memo[key] = "self"
            return out
        if spec == "self":
            return args[0]
        return _from_spec(spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rets = func._schema.returns
        aliased = any(r.alias_info is not None for r in rets)
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in rets)
        out = self._run(func, args, kwargs, aliased, writes)
        if self._inside:
            return out                   # inside a kernel's plain version
        self.ops += 1
        if aliased and not writes:
            return out                   # a view: no bytes move
        if "empty" not in func.__name__:
            self.traffic += sum(_nbytes(t) for t in _tensors(args)) + sum(
                _nbytes(t) for t in _tensors(kwargs or {})) + sum(
                _nbytes(t) for t in _tensors(out))
        if not aliased:
            self._allocated(out)
        return out


def meta_run(step, args, *, slice_devices: int = 1) -> dict:
    """Run ``step`` once on the ``meta`` tensors of ``args`` under the FLOP
    counter and :class:`TrafficMode`: global dot FLOPs, traffic, the
    transient high-water mark, the bytes of outputs that are not
    arguments, the op count and the seconds taken.  The optimizer updates
    ``slice_devices`` devices' slices at a time."""
    from repro_torch.train import optimizer

    t0 = time.perf_counter()
    tensors = meta_tensors(args)
    arg_ids = {id(t) for t in _tensors(tensors)}
    old = optimizer.SLICE
    optimizer.SLICE = old * slice_devices
    try:
        # the traffic counter sees each op as the program dispatches it
        # (the FLOP counter below may decompose it)
        with FlopCounterMode(display=False) as fc, TrafficMode(fc) as tm:
            out = step(*tensors)
            output = sum(_nbytes(t) for t in _tensors(out)
                         if id(t) not in arg_ids)
    finally:
        optimizer.SLICE = old
    return {"flops": float(fc.get_total_flops()),
            "traffic": float(tm.traffic), "high": tm.high, "output": output,
            "ops": tm.ops, "kernels": tm.kernels,
            "run_s": time.perf_counter() - t0}


def ring_report(n_params: int, ranks: int) -> dict:
    """The data-parallel gradient ring of a ``ranks``-way ``rma_ring`` step
    over ``n_params`` gradients, from the port's compiled plan: the train
    step lays the float32 gradients out as one vector padded to whole
    vector-aligned chunks and runs the declared sum ring on a lent window
    (``train.trainstep``), which this plan is."""
    from repro_torch.core.rma.collectives import all_reduce_plan
    from repro_torch.core.rma.topology import default_topology

    width = -(-n_params // (4 * ranks)) * (4 * ranks)
    plan = all_reduce_plan("data", ranks, (width,), torch.float32,
                           order=True, declare_op=True, lent=True,
                           topology=default_topology(ranks), backend="rma")
    ring_bytes = 2 * (ranks - 1) * (width // ranks) * 4
    return {"bytes_by_kind": {"ring": float(ring_bytes)},
            "count_by_kind": {"ring": 1.0},
            "total_bytes": float(ring_bytes), "ranks": ranks,
            "phases": plan.phases, "phase_table": plan.phase_table(),
            "lowering": [list(r) for r in plan.lowering]}


def _mesh_name(mesh: Mesh) -> str:
    return "x".join(str(n) for n in mesh.axis_sizes)


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             grad_sync: str = "gspmd", rules_override=None,
             cfg_overrides: dict | None = None,
             rules_updates: dict | None = None, save_hlo: str | None = None,
             tag: str = "", accum_steps: int = 1,
             mesh: Mesh | None = None, meta_runs: dict | None = None
             ) -> dict:
    """One cell's record.  ``shape_name`` names a shape of ``SHAPES`` (or is
    a :class:`ShapeConfig`); ``mesh`` replaces the production mesh.  A
    ``meta_runs`` dict the caller keeps across cells lets cells that differ
    only in their mesh share one meta run (the step's global work is the
    same on every mesh)."""
    if save_hlo:
        raise ValueError("save_hlo: the port compiles no HLO")
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    name = _mesh_name(mesh)
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "tag": tag, "mesh": name,
                "status": "skipped", "why": why}
    chips = mesh.size
    rules = rules_override or rules_for(cfg, shape)
    if rules_updates:
        rules = dict(rules, **rules_updates)
    t0 = time.perf_counter()
    slice_devices = min(chips, SLICE_DEVICES)
    with use_rules(mesh, rules) as R:
        step, args, _ = build_cell(cfg, shape, R, grad_sync=grad_sync,
                                   accum_steps=accum_steps)
        arguments = sum(s.shard_bytes for s in sds_leaves(args))
        n_params = sum(s.meta.numel() for s in sds_leaves(args[0]))
        batch = R.rules.get("batch")
        batch_ways = math.prod(mesh.shape[a] for a in (
            () if batch is None else (batch,) if isinstance(batch, str)
            else batch))
        t_build = time.perf_counter() - t0
        key = (cfg, shape, grad_sync, accum_steps, slice_devices)
        runs = meta_runs if meta_runs is not None else {}
        if key not in runs:
            runs[key] = meta_run(step, args, slice_devices=slice_devices)
        run = runs[key]
    del step, args

    if shape.kind == "train" and grad_sync == "rma_ring" and batch_ways > 1:
        coll, coll_why = ring_report(n_params, batch_ways), None
    elif grad_sync == "rma_ring":
        coll, coll_why = None, ("no gradient ring: " + (
            "a serving step" if shape.kind != "train"
            else "one data-parallel rank"))
    else:
        coll, coll_why = None, NO_COLLECTIVES
    flops = run["flops"] / chips
    hbm_bytes = run["traffic"] / chips
    roof = hlo_analysis.Roofline(
        flops=flops, hbm_bytes=hbm_bytes,
        coll_bytes=None if coll is None else coll["total_bytes"],
        chips=chips)
    mflops = hlo_analysis.model_flops(
        cfg.replace(dtype="bfloat16", param_dtype="bfloat16"), shape)
    temp = run["high"] // chips
    rec = {
        "arch": arch,
        "tag": tag,
        "shape": shape.name,
        "mesh": name,
        "chips": chips,
        "status": "ok",
        "grad_sync": grad_sync,
        # the cell's shape-only build, and its one step on meta
        "lower_s": round(t_build, 2),
        "compile_s": round(run["run_s"], 2),
        "per_device": "global / chips (no partitioner); arguments exact",
        "bytes_per_device": {
            "peak": int(arguments + temp),
            "arguments": int(arguments),
            "output": int(run["output"] // chips),
            "temp": int(temp),
            "peak_is_estimate": True,
        },
        "hlo_flops": flops,
        "hlo_bytes": hbm_bytes,
        "meta_ops": run["ops"],
        "meta_kernel_calls": run["kernels"],
        "collectives": coll,
        "xla_cost_flops_per_dev": None,
        "model_flops": mflops,
        "useful_flops_ratio": (mflops / run["flops"]) if run["flops"] else None,
        "roofline": roof.as_dict(),
    }
    if coll is None:
        rec["collectives_why"] = coll_why
    return rec


def cell_line(tag: str, rec: dict) -> str:
    """One printed line of a cell's record."""
    if rec["status"] == "skipped":
        return f"[dryrun] {tag}: SKIP ({rec['why']})"
    if rec["status"] != "ok":
        return f"[dryrun] {tag}: FAILED {rec['error']}"
    r, b = rec["roofline"], rec["bytes_per_device"]
    n = ("-" if r["collective_s"] is None
         else f"{r['collective_s'] * 1e3:.2f}ms")
    coll = ("-" if rec["collectives"] is None
            else f"{rec['collectives']['total_bytes']:.3g}B "
                 f"{rec['collectives']['phases']} phases")
    ratio = rec["useful_flops_ratio"]
    return (f"[dryrun] {tag}: OK args={b['arguments'] / 2**30:.2f}GiB/dev "
            f"peak~{b['peak'] / 2**30:.2f}GiB/dev "
            f"flops/dev={rec['hlo_flops']:.3g} "
            f"useful={'-' if ratio is None else f'{ratio:.3f}'} "
            f"coll/dev={coll} dominant={r['dominant']} "
            f"(c={r['compute_s'] * 1e3:.2f}ms m={r['memory_s'] * 1e3:.2f}ms "
            f"n={n}) run={rec['compile_s']}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="all", help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {sorted(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--grad-sync", default="gspmd",
                    choices=["gspmd", "rma_ring"])
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--save-hlo", default=None,
                    help="refused: the port compiles no HLO")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="model-config override, e.g. --set n_layers=2")
    ap.add_argument("--rule", action="append", default=[],
                    metavar="NAME=AXES",
                    help="sharding-rule override, e.g. --rule seq=model or "
                         "--rule batch=pod,data,model or --rule embed=none")
    ap.add_argument("--tag", default="", help="label recorded with results")
    ap.add_argument("--accum", type=int, default=1,
                    help="grad-accum microbatches")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port compiles no HLO (a step runs eagerly "
                 "on the meta device), so there is no module to save")

    def parse_v(v):
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        try:
            return int(v)
        except ValueError:
            try:
                return float(v)
            except ValueError:
                return v
    cfg_overrides = {k: parse_v(v) for k, v in
                     (kv.split("=", 1) for kv in args.set)}
    rules_updates = {}
    for kv in args.rule:
        k, v = kv.split("=", 1)
        if v.lower() in ("none", ""):
            rules_updates[k] = None
        elif "," in v:
            rules_updates[k] = tuple(v.split(","))
        else:
            rules_updates[k] = v

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = sorted(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = time.perf_counter()
    records, failures = [], 0
    for arch in archs:
        for shape in shapes:
            meta_runs: dict = {}         # both meshes of a cell, one run
            for mp in meshes:
                tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   grad_sync=args.grad_sync,
                                   cfg_overrides=cfg_overrides or None,
                                   rules_updates=rules_updates or None,
                                   tag=args.tag, accum_steps=args.accum,
                                   meta_runs=meta_runs)
                except Exception as e:  # a failure here is a bug in the port
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "FAILED",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                records.append(rec)
                print(cell_line(tag, rec), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    print(f"[dryrun] done: {len(records)} cells, {failures} failures in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failures else 0


__all__ = ["run_cell", "meta_run", "ring_report", "cell_line", "TrafficMode",
           "main",
           "NO_COLLECTIVES", "SLICE_DEVICES"]


if __name__ == "__main__":
    sys.exit(main())
