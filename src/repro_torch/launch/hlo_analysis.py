"""Loop-aware analysis of HLO text — FLOPs, HBM traffic, collective bytes —
and the three-term roofline on the H100's data sheet.

The text analysis (``parse_module``, ``analyze``, ``collective_bytes``) is
the JAX package's, copied: a pure function of the HLO text, so both packages
read one compiled module to the same numbers (``dot`` FLOPs
2·prod(result)·prod(contracting) through fusions and calls, × trip count
through ``while`` loops; fusion-level HBM traffic; collective operand
bytes).  The port compiles no HLO itself: its dry-run
(``repro_torch.launch.dryrun``) counts the same dot FLOPs of a step run on
the ``meta`` device, and feeds them to :class:`Roofline`.

``model_flops`` / ``active_params`` / ``total_params`` read the port's
parameter shapes from ``build_model(cfg).init(0, device="meta")``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Iterable

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "token": 0, "opaque": 0,
}

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str) -> list[list[int]]:
    """All array shapes in a type string (tuples give several)."""
    out = []
    for _, dims in _SHAPE_RE.findall(type_str):
        out.append([int(d) for d in dims.split(",")] if dims else [])
    return out


@dataclasses.dataclass
class Op:
    name: str
    result_type: str
    kind: str
    operands: list[str]
    attrs: str
    args: str = ""  # raw text inside the op's parentheses


@dataclasses.dataclass
class Computation:
    name: str
    params: dict  # name -> type string
    ops: dict     # name -> Op
    root: str = ""  # name of the ROOT op


_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\(?[^=]*?\)?)\s+([a-z][a-z0-9\-]*)\((.*)$"
)
_PARAM_RE = re.compile(r"%?([\w\.\-]+)\s*:\s*((?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?))")


def parse_module(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    current: Computation | None = None
    name_re = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)")
    comment_re = re.compile(r"/\*[^*]*\*/")
    for line in text.splitlines():
        stripped = comment_re.sub("", line).strip()  # kill /*index=N*/ etc.
        if current is None:
            if stripped.endswith("{"):
                m = name_re.match(stripped)
                if not m:
                    continue
                params = {pn: pt for pn, pt in _PARAM_RE.findall(stripped)}
                current = Computation(m.group(1), params, {})
        else:
            if stripped == "}" or stripped.startswith("} "):
                comps[current.name] = current
                current = None
                continue
            m = _OP_RE.match(stripped)
            if m:
                name, rtype, kind, rest = m.groups()
                if stripped.startswith("ROOT "):
                    current.root = name
                # split operands (up to closing paren at depth 0)
                depth, end = 1, len(rest)
                for i, ch in enumerate(rest):
                    if ch == "(":
                        depth += 1
                    elif ch == ")":
                        depth -= 1
                        if depth == 0:
                            end = i
                            break
                opnames = re.findall(r"%([\w\.\-]+)", rest[:end])
                current.ops[name] = Op(name, rtype.strip(), kind, opnames,
                                       rest[end:], rest[:end])
    return comps


def _entry_name(text: str, comps) -> str:
    m = re.search(r"ENTRY\s+%?([\w\.\-]+)", text)
    if m and m.group(1) in comps:
        return m.group(1)
    return max(comps, key=lambda c: len(comps[c].ops)) if comps else ""


@dataclasses.dataclass
class HloStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    coll_count: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    dots: int = 0
    convs: int = 0
    whiles: list = dataclasses.field(default_factory=list)

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def add(self, other: "HloStats", scale: float = 1.0):
        self.flops += scale * other.flops
        self.hbm_bytes += scale * other.hbm_bytes
        for k in COLLECTIVE_KINDS:
            self.coll_bytes[k] += scale * other.coll_bytes[k]
            self.coll_count[k] += scale * other.coll_count[k]
        self.dots += int(scale * other.dots)
        self.convs += int(scale * other.convs)


def _operand_type(comp: Computation, comps, name: str) -> str:
    if name in comp.ops:
        return comp.ops[name].result_type
    if name in comp.params:
        return comp.params[name]
    return ""


_CONST_IN_LINE = re.compile(r"constant\((\d+)\)")


def _fusion_traffic(comp: Computation, comps, op: Op,
                    callee: Computation | None) -> int:
    """HBM traffic of one fusion op, aliasing- and slice-aware.

    Scan-of-layers bodies produce fusions whose operands are the giant
    stacked (L, ...) buffers but whose *actual* reads are one
    ``dynamic-slice`` per iteration, and whose root is (a tuple of)
    ``dynamic-update-slice`` writing one layer's slice in place.  Counting
    full operand/result sizes there overstates traffic ~L× — so:

    * a fusion parameter whose only uses are ``dynamic-slice`` contributes
      the slice sizes, not the buffer size;
    * a parameter consumed as the aliased (operand 0) buffer of a root
      ``dynamic-update-slice`` contributes nothing (in-place);
    * each dus root element contributes 2·update bytes instead of the
      full result element.
    """
    reads = sum(_shape_bytes(_operand_type(comp, comps, on))
                for on in op.operands)
    writes = _shape_bytes(op.result_type)
    if callee is None:
        return reads + writes
    # root (possibly a tuple of) dynamic-update-slice → in-place writes
    root = callee.ops.get(callee.root)
    dus_roots: list[Op] = []
    if root is not None:
        elems = ([callee.ops[on] for on in root.operands if on in callee.ops]
                 if root.kind == "tuple" else [root])
        dus_roots = [r for r in elems if r.kind == "dynamic-update-slice"]
    for r in dus_roots:
        full = _shape_bytes(r.result_type)
        upd = (_shape_bytes(_operand_type(callee, comps, r.operands[1]))
               if len(r.operands) > 1 else 0)
        writes += 2 * upd - full  # in-place: only the slice moves (r+w)
    # parameter-wise read refinement
    params = list(callee.params)
    uses: dict[str, list[Op]] = {pn: [] for pn in params}
    for o2 in callee.ops.values():
        for j, on in enumerate(o2.operands):
            if on in uses:
                uses[on].append(o2)
    dus_alias_params = {r.operands[0] for r in dus_roots if r.operands}
    for j, pn in enumerate(params):
        if j >= len(op.operands):
            break
        outer = _shape_bytes(_operand_type(comp, comps, op.operands[j]))
        pu = uses.get(pn, [])
        effective = None
        if pn in dus_alias_params:
            # aliased in-place buffer: reads only via explicit slices
            effective = sum(2 * _shape_bytes(u.result_type) for u in pu
                            if u.kind == "dynamic-slice")
        elif pu and all(u.kind == "dynamic-slice" for u in pu):
            effective = sum(_shape_bytes(u.result_type) for u in pu)
        if effective is not None and effective < outer:
            reads += effective - outer
    return max(reads, 0) + max(writes, 0)


def analyze(text: str) -> HloStats:
    comps = parse_module(text)

    # constants per computation (for trip counts): name -> int value
    const_vals: dict[str, dict[str, int]] = {}
    for cname, comp in comps.items():
        vals = {}
        for op in comp.ops.values():
            if op.kind == "constant":
                m = re.match(r"\s*(\d+)\s*$", op.args)
                if m:
                    vals[op.name] = int(m.group(1))
        const_vals[cname] = vals

    def trip_count(cond_name: str) -> int:
        comp = comps.get(cond_name)
        if comp is None:
            return 1
        best = 1
        for op in comp.ops.values():
            if op.kind == "compare":
                for on in op.operands:
                    if on in const_vals[cond_name]:
                        best = max(best, const_vals[cond_name][on])
                    # constant inlined in operand list: compare(%x, s32[] constant(5))?
        if best == 1:  # fallback: any constant in the condition
            vals = const_vals[cond_name].values()
            best = max(vals) if vals else 1
        return best

    FUSION_LIKE = {"fusion"}
    CALL_LIKE = {"call", "custom-call", "map", "reduce", "reduce-window",
                 "scatter", "sort", "select-and-scatter"}

    memo_full: dict[str, HloStats] = {}   # flops+colls, recursing into fusions
    memo_flops_only: dict[str, HloStats] = {}

    def analyze_comp(cname: str, *, inside_fusion: bool) -> HloStats:
        memo = memo_flops_only if inside_fusion else memo_full
        if cname in memo:
            return memo[cname]
        stats = HloStats()
        memo[cname] = stats
        comp = comps.get(cname)
        if comp is None:
            return stats
        for op in comp.ops.values():
            kind = op.kind
            base = kind.replace("-start", "").replace("-done", "")
            if base in COLLECTIVE_KINDS and not kind.endswith("-done"):
                obytes = sum(
                    _shape_bytes(_operand_type(comp, comps, on))
                    for on in op.operands) or _shape_bytes(op.result_type)
                stats.coll_bytes[base] += obytes
                stats.coll_count[base] += 1
                if not inside_fusion:
                    stats.hbm_bytes += obytes + _shape_bytes(op.result_type)
                continue
            if kind == "dot":
                res = _shape_dims(op.result_type)
                res_n = 1
                for d in (res[0] if res else []):
                    res_n *= d
                lhs_t = _operand_type(comp, comps, op.operands[0]) if op.operands else ""
                lhs_dims = (_shape_dims(lhs_t) or [[]])[0]
                m = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", op.attrs)
                k = 1
                if m and m.group(1):
                    for di in m.group(1).split(","):
                        if int(di) < len(lhs_dims):
                            k *= lhs_dims[int(di)]
                stats.flops += 2.0 * res_n * k
                stats.dots += 1
                if not inside_fusion:
                    stats.hbm_bytes += (_shape_bytes(op.result_type) + sum(
                        _shape_bytes(_operand_type(comp, comps, on))
                        for on in op.operands))
                continue
            if kind == "convolution":
                stats.convs += 1
                # rough: 2 * prod(result) * prod(kernel spatial+in-features)
                res = _shape_dims(op.result_type)
                res_n = 1
                for d in (res[0] if res else []):
                    res_n *= d
                rhs_t = _operand_type(comp, comps, op.operands[1]) if len(op.operands) > 1 else ""
                rhs_dims = (_shape_dims(rhs_t) or [[]])[0]
                k = 1
                for d in rhs_dims[:-1]:
                    k *= d
                stats.flops += 2.0 * res_n * k
                if not inside_fusion:
                    stats.hbm_bytes += _shape_bytes(op.result_type)
                continue
            if kind == "while":
                mb = re.search(r"body=%?([\w\.\-]+)", op.attrs)
                mc = re.search(r"condition=%?([\w\.\-]+)", op.attrs)
                trips = trip_count(mc.group(1)) if mc else 1
                if mb:
                    sub = analyze_comp(mb.group(1), inside_fusion=inside_fusion)
                    stats.add(sub, scale=trips)
                    stats.whiles.append((mb.group(1), trips))
                continue
            if kind == "conditional":
                branches = re.findall(r"%([\w\.\-]+)", op.attrs)
                subs = [analyze_comp(b, inside_fusion=inside_fusion)
                        for b in branches if b in comps]
                if subs:
                    biggest = max(subs, key=lambda s: s.flops + s.hbm_bytes)
                    stats.add(biggest)
                continue
            if kind in FUSION_LIKE:
                mcalls = re.search(r"calls=%?([\w\.\-]+)", op.attrs)
                callee = comps.get(mcalls.group(1)) if mcalls else None
                if callee is not None:
                    sub = analyze_comp(callee.name, inside_fusion=True)
                    stats.add(sub)  # dots/colls inside the fusion
                if not inside_fusion:
                    stats.hbm_bytes += _fusion_traffic(comp, comps, op, callee)
                continue
            if kind in CALL_LIKE:
                mcalls = re.search(r"(?:calls|to_apply)=%?([\w\.\-]+)", op.attrs)
                if mcalls:
                    sub = analyze_comp(mcalls.group(1), inside_fusion=inside_fusion)
                    stats.add(sub)
                if not inside_fusion:
                    stats.hbm_bytes += (_shape_bytes(op.result_type) + sum(
                        _shape_bytes(_operand_type(comp, comps, on))
                        for on in op.operands))
                continue
            # other top-level ops that move memory
            if not inside_fusion:
                if kind in ("tuple", "get-tuple-element", "bitcast", "reshape",
                            "parameter", "constant", "after-all"):
                    continue  # views / no traffic
                res = _shape_bytes(op.result_type)
                if kind == "dynamic-update-slice":
                    upd = _shape_bytes(
                        _operand_type(comp, comps, op.operands[1])
                        if len(op.operands) > 1 else "")
                    stats.hbm_bytes += 2 * upd  # in-place
                elif kind in ("dynamic-slice", "slice", "gather", "pad",
                              "broadcast", "iota", "reverse", "concatenate",
                              "transpose", "copy", "copy-start"):
                    stats.hbm_bytes += 2 * res  # reads ≈ writes ≈ result
                else:
                    stats.hbm_bytes += res + sum(
                        _shape_bytes(_operand_type(comp, comps, on))
                        for on in op.operands)
        return stats

    entry = _entry_name(text, comps)
    return analyze_comp(entry, inside_fusion=False)


# Backwards-compatible wrapper used by dryrun/benchmarks
@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def collective_bytes(text: str) -> CollectiveStats:
    st = analyze(text)
    return CollectiveStats(bytes_by_kind=st.coll_bytes, count_by_kind=st.coll_count)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

#: NVIDIA H100 SXM data-sheet constants, one card ("NVIDIA H100 80GB HBM3,
#: 700.00 W" as nvidia-smi reports it on the card host): dense bfloat16
#: tensor-core FLOP/s, HBM bytes/s, and NVLink 4 bytes/s in one direction
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


@dataclasses.dataclass
class Roofline:
    """Three-term roofline.  Inputs are PER-DEVICE; ``coll_bytes=None``
    means the collective term is unknown (no partitioner placed
    collectives), and ``dominant`` picks among the known terms."""
    flops: float        # per-device FLOPs per step
    hbm_bytes: float    # per-device HBM traffic per step
    coll_bytes: float | None  # per-device collective bytes per step
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float | None:
        return None if self.coll_bytes is None else self.coll_bytes / NVLINK_BW

    def _terms(self) -> dict:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    @property
    def compute_fraction(self) -> float:
        """Fraction of roofline: useful-compute time / bound time."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "compute_fraction": self.compute_fraction,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token/sequence


def _param_leaves(cfg):
    """(path string, shape) of every parameter, from a shape-only build;
    the path reads as JAX's ``keystr`` (``['stack']['prefix'][0]...``)."""
    from repro_torch.models import build_model
    from repro_torch.tree import leaves_with_paths

    params = build_model(cfg).init(0, device="meta")
    return [("".join(f"[{k!r}]" for k in path), tuple(t.shape))
            for path, t in leaves_with_paths(params)]


def active_params(cfg) -> float:
    """Parameters active per token: the JAX package's rule — a leaf named
    ``wi``/``wo`` under a ``moe`` node (the routed experts, and with them a
    shared expert's) counts ``top_k / num_experts`` of its size."""
    total = 0.0
    moe = cfg.moe
    for p, shape in _param_leaves(cfg):
        n = 1
        for d in shape:
            n *= d
        if moe is not None and "moe" in p and ("'wi'" in p or "'wo'" in p):
            n = n * moe.top_k / moe.num_experts
        total += n
    return total


def total_params(cfg) -> float:
    total = 0
    for _, shape in _param_leaves(cfg):
        n = 1
        for d in shape:
            n *= d
        total += n
    return float(total)


__all__ = [
    "analyze", "HloStats", "parse_module",
    "collective_bytes", "CollectiveStats", "Roofline",
    "model_flops", "active_params", "total_params",
    "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "COLLECTIVE_KINDS",
]
