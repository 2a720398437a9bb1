"""The whole training step's share of the card's bf16 peak: model FLOPs of
every step of the window (forward and backward, nothing recomputed
counted) over the window's time, at 989 TFLOP/s."""
from rmabench import flops, peaks


def read(run):
    steps = run.records.get("steps")
    if not steps:
        return None
    t = run.workload["traffic_params"]
    per_step = flops.train_step_flops(run.model, t["ranks"] * t["rows"],
                                      t["seq_len"])
    seconds = steps[-1]["t1"] - steps[0]["t0"]
    return 100.0 * per_step * len(steps) / seconds / peaks.BF16_FLOPS
