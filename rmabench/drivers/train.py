"""The training loop: ``make_train_step(grad_sync="rma_ring")`` over stacked
data-parallel ranks, one fresh batch a step, the host synchronized at the
end of every step (as a trainer that logs its loss is).

Set-up builds the step, its model and its optimizer state once, from the
seed, and drives that same object through the first ``check.steps``
steps with the window's own call and feed; those steps are also the
warm-up (every kernel is built and every shape seen).  It keeps the
program's readings of them: each step's loss, every leaf's gradient as the
optimizer got it (from the first moment after step 1: m = (1 - b1) g) and
every leaf's change over the steps.  The window then runs whole steps until
``--seconds`` have passed.  After the window and after the program's state
is freed, the reference re-makes the weights and the batches from the seed
and follows the same steps in float32.
"""
from __future__ import annotations

import math

from rmabench import harness, weights
from rmabench.traffic.generate import TrainFeed, as_train_batch


def _build(run, device):
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step

    cfg = harness.model_config(run.model)
    model = build_model(cfg)
    layout = model.init(0, device="meta")
    params = weights.make_params(layout, run.seed, device)
    opt_cfg = OptimizerConfig(**run.workload["optimizer"])
    ranks = run.workload["traffic_params"]["ranks"]
    step = make_train_step(model, opt_cfg, grad_sync="rma_ring",
                           data_axis_size=ranks,
                           backend=run.workload["backend"])
    return layout, params, init_opt_state(params), step


def leaf_norms(pairs, tensors) -> dict:
    """Named float norms of ``tensors`` (in the order of ``pairs``, the
    ``(path, leaf)`` list): a leaf stacked on a layer axis (under
    ``scan``) gives one norm a layer."""
    import torch

    out = {}
    with torch.no_grad():
        for (path, _), t in zip(pairs, tensors):
            name = "/".join(map(str, path))
            if "scan" in path:
                rows = t.reshape(t.shape[0], -1).double().norm(dim=1)
                for c, x in enumerate(rows.tolist()):
                    out[f"{name}[{c}]"] = x
            else:
                out[name] = float(t.double().norm())
    return out


def setup(run) -> None:
    import torch

    device = run.device
    layout, params, opt_state, step = _build(run, device)
    pairs = list(weights.walk(params))
    feed = TrainFeed(run.workload["traffic_params"], run.seed,
                     run.model["vocab"], device)
    b1 = run.workload["optimizer"]["b1"]
    losses, grads = [], None
    for i in range(run.workload["check"]["steps"]):
        params, opt_state, m = step(params, opt_state,
                                    as_train_batch(feed.next()))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = leaf_norms(pairs, (mo / (1 - b1) for _, mo in
                                       weights.walk(opt_state["m"])))
    start = weights.make_params(layout, run.seed, device)
    change = leaf_norms(pairs, (t - s for (_, t), (_, s) in
                                zip(pairs, weights.walk(start))))
    del start
    if device == "cuda":
        torch.cuda.synchronize()
    run.records["program"] = {"loss": losses, "grad": grads,
                              "change": change}
    run.program.update(params=params, opt_state=opt_state, step=step,
                       feed=feed)
    run.records["layout"] = layout


def window(run, seconds: float) -> None:
    import torch

    p = run.program
    on_card = run.device == "cuda"
    steps, failed = [], 0
    t_open = harness.now()
    while True:
        t0 = harness.now()
        with torch.profiler.record_function("bench:step"):
            p["params"], p["opt_state"], m = p["step"](
                p["params"], p["opt_state"], as_train_batch(p["feed"].next()))
            loss = float(m["loss"])          # the host waits for the step
        t1 = harness.now()
        rec = {"t0": t0, "t1": t1, "tokens": p["feed"].tokens_per_batch}
        if on_card:
            for part, (a, b) in m["events"].items():
                rec[f"{part}_ms"] = a.elapsed_time(b)
        failed += not math.isfinite(loss)
        steps.append(rec)
        if t1 - t_open >= seconds:
            break
    run.records.update(steps=steps, attempted=len(steps), failed=failed,
                       window_s=steps[-1]["t1"] - steps[0]["t0"])


def release(run) -> None:
    pass


def _gap(prog: float, ref: float, floor: float) -> float:
    return abs(prog - ref) / max(abs(ref), floor)


def compare(prog: dict, ref: dict) -> dict:
    """The compared numbers: the largest relative gap of the steps'
    losses; and, by the worst leaf, the gap between the program's norm
    and the reference's of the first gradient and of the change, over the
    larger of the reference's norm of that leaf and of the median leaf.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding) are left out of both."""
    import statistics

    loss = max(_gap(p, r, 1e-12) for p, r in zip(prog["loss"], ref["loss"]))
    g_med = statistics.median(ref["grad"].values())
    c_med = statistics.median(ref["change"].values())
    keep = [k for k, g in ref["grad"].items() if g >= 1e-3 * g_med]
    grad = max(_gap(prog["grad"][k], ref["grad"][k], g_med) for k in keep)
    change = max(_gap(prog["change"][k], ref["change"][k], c_med)
                 for k in keep)
    return {"loss": loss, "grad": grad, "change": change,
            "left_out": len(ref["grad"]) - len(keep)}


def reference(run, precision: str = "float32") -> dict:
    """The reference's readings of the checked steps: weights and batches
    re-made from the seed, float32 (or the control's precision)."""
    import torch

    from rmabench.reference.numerics import PRECISIONS, exact_float32

    device = run.device
    layout = run.records["layout"]
    feed = TrainFeed(run.workload["traffic_params"], run.seed,
                     run.model["vocab"], device)
    batches = [feed.next() for _ in range(run.workload["check"]["steps"])]
    params = weights.make_params(layout, run.seed, device)
    pairs = list(weights.walk(params))
    ref = harness.load_module("reference", run.config["reference"])
    with exact_float32():
        losses, grads, change = ref.train_steps(
            params, pairs, batches, run.model, run.workload["optimizer"],
            lambda ts: leaf_norms(pairs, ts), q=PRECISIONS[precision])
    del params, pairs, batches
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grads, "change": change}


def check(run) -> list:
    ref = reference(run)
    nums = compare(run.records["program"], ref)
    run.records["compared"] = nums
    return [(k, nums[k], lim)
            for k, lim in run.workload["check"]["limits"].items()]


def control(run) -> dict:
    """The control's compared numbers: the reference in the lower
    precision put in the program's place."""
    weights_layout(run)
    low = reference(run, run.workload["check"]["control"])
    return compare(low, reference(run))


def weights_layout(run) -> None:
    """The parameter layout alone (for a control run, which builds no
    program)."""
    if "layout" not in run.records:
        from repro_torch.models import build_model

        run.records["layout"] = build_model(
            harness.model_config(run.model)).init(0, device="meta")
