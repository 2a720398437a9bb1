"""The collective lowering target for recognized plan macros.

A plan brackets the op ranges of ``RmaPlan.ring_all_reduce`` and
``RmaPlan.all_to_all`` as macros; this backend replaces a whole bracketed
range with the collective the pattern computes and bills it **zero**
phases.  In the JAX package that collective is ``lax.psum`` /
``lax.all_to_all`` inside the mesh; on the stacked layout, where the n
ranks are the rows of one tensor, it is one library operation:

* ring(op="sum") → ``x.sum(0)`` in the macro dtype, broadcast back to
  ``(n, ...)`` as a view.  A float sum may reassociate against the ring's
  order (kernel K5's), so bit-identity is claimed for integer-valued
  payloads only.
* a2a(op=None) → the ``[src, dst]`` block axes swapped: block j of rank
  r's result is what rank j sent to r.
* a2a(op="sum") → the same: the RMA lowering lands every block with an
  accumulate into a zeroed slot, which a plain exchange reproduces.
* a2a counts → the count matrix transposed; bells → every remote peer's
  doorbell 1, one's own 0.

:func:`macro_lowerable` is the gate: a macro whose interior results leak
(an outside op consumes an intermediate, or an output exposes one) stays
on the RMA substrate with the reason recorded.
"""
from __future__ import annotations

import torch

from repro_torch.core.rma.plan import OpRef


def macro_lowerable(plan, macro) -> tuple[bool, str]:
    """Whether ``macro`` may be replaced by its collective: ``(ok,
    reason)``, the reason recorded in ``CompiledPlan.lowering`` when it
    declines."""
    if macro.kind == "ring":
        if macro.op != "sum":
            return False, (f"ring op {macro.op!r} has no psum equivalent")
    elif macro.kind == "a2a":
        if macro.op not in (None, "sum"):
            return False, (f"a2a landing op {macro.op!r} has no "
                           "all_to_all equivalent")
    else:
        return False, f"unrecognized macro kind {macro.kind!r}"
    interior = set(range(macro.lo, macro.hi)) - {r.idx for r in macro.results}
    for o in plan._ops:
        if macro.lo <= o.idx < macro.hi:
            continue
        vrefs = {r.idx for r in o.reads}
        vrefs.update(plan._refs_in(o.source, o.cur, o.offset, o.handle,
                                   o.value))
        hit = sorted(vrefs & interior)
        if hit:
            return False, (f"op {o.label or o.kind}#{o.idx} consumes macro "
                           f"intermediates {hit}")
    for name, spec in plan._outputs:
        if isinstance(spec, OpRef) and spec.idx in interior:
            return False, (f"output {name!r} exposes macro intermediate "
                           f"#{spec.idx}")
    return True, ""


def execute_macro(macro, resolve) -> dict[int, torch.Tensor]:
    """Run one selected macro on the stacked layout; ``{result_idx:
    value}`` for its declared results."""
    dt = macro.dtype
    n = macro.n
    if macro.kind == "ring":
        x = resolve(macro.source).to(dt)
        out = torch.sum(x, 0, dtype=dt)
        return {macro.results[0].idx: out.unsqueeze(0).expand(x.shape)}
    if macro.kind == "a2a":
        x = resolve(macro.source).to(dt)
        cv = resolve(macro.counts).to(torch.int32)
        m = macro.shape[0] // n
        rest = tuple(x.shape[2:])
        blocks = x.reshape((n, n, m) + rest)          # [src, dst, block]
        out = blocks.transpose(0, 1).reshape((n, n * m) + rest)
        bells = (torch.ones((n, n), dtype=torch.int32, device=x.device)
                 - torch.eye(n, dtype=torch.int32, device=x.device))
        return {macro.results[0].idx: out,
                macro.results[1].idx: cv.T.contiguous(),
                macro.results[2].idx: bells}
    raise AssertionError(macro.kind)


#: The interpret walker's name for the same function: on the stacked
#: layout the in-mesh and host-side realizations coincide.
host_macro = execute_macro


__all__ = ["macro_lowerable", "execute_macro", "host_macro"]
