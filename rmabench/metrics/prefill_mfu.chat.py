"""The prefill's share of the card's bf16 peak: model FLOPs of the
window's prefills, from their prompt lengths (the head on the last row),
over their summed host time, at 989 TFLOP/s."""
from rmabench import flops, peaks


def read(run):
    pre = run.records.get("prefills")
    if not pre:
        return None
    work = sum(flops.forward_flops(run.model, n, logits_rows=1)
               for _, _, _, n in pre)
    spent = sum(t1 - t0 for _, t0, t1, _ in pre)
    return 100.0 * work / spent / peaks.BF16_FLOPS
