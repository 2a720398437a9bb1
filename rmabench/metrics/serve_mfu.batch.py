"""The serving step's share of the card's bf16 peak: model FLOPs of every
token produced in the window (each prefill over its prompt, the head on
its last row; each decoded token at its position) over the window's time,
at 989 TFLOP/s."""
from rmabench import flops, peaks


def read(run):
    rec = run.records
    if "t_open" not in rec:
        return None
    lo, hi = rec["t_open"], rec["t_close"]
    plen = {rid: len(p) for rid, p in rec["prompts"].items()}
    work = 0.0
    for rid, ts in rec["tok_times"].items():
        for k, t in enumerate(ts):
            if not lo < t <= hi or rid not in plen:
                continue
            n = plen[rid]
            work += (flops.forward_flops(run.model, n, logits_rows=1)
                     if k == 0 else
                     flops.forward_flops(run.model, n + k, start=n + k - 1))
    return 100.0 * work / (hi - lo) / peaks.BF16_FLOPS
