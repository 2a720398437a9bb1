"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  Every roofline share and
every ``mfu`` the benchmark reports is against these numbers."""

#: bfloat16 / float16 tensor-core rate, FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time the card could take for ``nbytes`` moved once and
    ``flops`` done in bf16: the larger of the two times."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
