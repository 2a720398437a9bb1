"""The SSD scan's share of its roofline in the traced prefills: the bytes
the scan of every Mamba2 layer must move for each prefill's prompt length
(x·dt, the decays, B and C read once; y and the final state written
once) at the HBM's peak, over the device time of the kernels that run the
scan (K8 and the SSD pass) in the traced stretch."""
from rmabench import flops, peaks

KERNELS = ("ssd_intra", "ssd_pass_kernel")


def read(run):
    tr = run.tr
    if tr is None:
        return None
    spent = tr.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    layers = sum(1 for m, _ in flops.layer_kinds(run.model) if m == "mamba")
    bound = sum(peaks.bound_s(flops.ssd_scan_bytes(run.model, n),
                              flops.ssd_scan_flops(run.model, n))
                for _, t0, _, n in run.records["prefills"]
                if tr.start <= t0 < tr.end)
    return 100.0 * layers * bound / spent
