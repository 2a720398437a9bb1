"""K5's share of its roofline in the gradient ring: the bytes the
all-reduce of the (ranks, width) float32 gradient matrix must move (each
input byte read once, each output byte written once) at the HBM's peak,
over K5's device time in the traced stretch, launch for launch."""
from rmabench import flops, peaks, weights

KERNELS = ("ring_ar_kernel",)


def read(run):
    tr = run.tr
    if tr is None:
        return None
    launches = tr.kernel_count(KERNELS)
    spent = tr.kernel_seconds(KERNELS)
    if not launches or spent <= 0:
        return None
    params = weights.count(run.records["layout"])
    ranks = run.workload["traffic_params"]["ranks"]
    bound = peaks.bound_s(flops.ring_bytes(params, ranks))
    return 100.0 * launches * bound / spent
