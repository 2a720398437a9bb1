"""repro_torch.kernels — hand-written Hopper kernels (CUDA C++, sm_90a) with
their plain PyTorch versions and oracles (``ref``).

The RMA wrappers take the stacked ``(n, ...)`` layout (row r = rank r).
Every wrapper computes its plain version on CPU tensors, and on CUDA tensors
launches its kernel or raises.  ``ops.ssd_scan`` is K8 followed by the SSD
state pass (``ssd_pass``, the device counterpart of the JAX package's
inter-chunk glue, which has no ``pallas_call``).  Kernels build at first use
(``repro_torch._build``) from ``repro_torch/csrc/``.

Every TPU kernel of the JAX package, by its ``pallas_call``:

== ===================================== ====================== ===================================== =============
#  file:line (``pallas_call``)           function               computes / shapes / dtypes            port
== ===================================== ====================== ===================================== =============
K1 ``kernels/accumulate.py:84``          ``accumulate``         1-D buffer op= update, any float/int  ``accumulate.py`` (CUDA)
K2 ``kernels/intrinsic.py:90``           ``ring_accumulate``    per-rank update into neighbour row    ``intrinsic.py`` (CUDA)
K3 ``kernels/rma_put.py:47``             ``ring_put``           per-rank shard to the neighbour       ``rma_put.py`` (CUDA)
K4 ``kernels/ordered_put_signal.py:72``  ``put_signal``         payload + flag word, (un)ordered      ``ordered_put_signal.py`` (CUDA)
K5 ``kernels/ring_allreduce.py:108``     ``ring_all_reduce``    (n·chunk, …) f32 sum all-reduce       ``ring_allreduce.py`` (CUDA)
K6 ``kernels/ordered_put_signal.py:144`` ``accumulate_signal``  K2's fold + K4's flag fused           ``ordered_put_signal.py`` (CUDA)
K7 ``kernels/flash_attention.py:84``     ``flash_attention``    (B,H,S,D) causal forward, GQA         ``flash_attention.py`` (CUDA)
K8 ``kernels/ssd_scan.py:62``            ``ssd_intra_chunk``    per (batch, chunk) SSD intra-chunk    ``ssd_scan.py`` (CUDA)
-- ``kernels/ops.py:24`` (XLA glue)      ``ssd_scan``           inter-chunk recurrence + read-out     ``ssd_pass.py`` (CUDA)
== ===================================== ====================== ===================================== =============
"""
from repro_torch.kernels import ref
from repro_torch.kernels.accumulate import COUNTER as _K1
from repro_torch.kernels.accumulate import accumulate, op_identity
from repro_torch.kernels.flash_attention import COUNTER as _K7
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.intrinsic import COUNTER as _K2
from repro_torch.kernels.intrinsic import ring_accumulate
from repro_torch.kernels.ops import ssd_scan
from repro_torch.kernels.ordered_put_signal import ACC_COUNTER as _K6
from repro_torch.kernels.ordered_put_signal import PUT_COUNTER as _K4
from repro_torch.kernels.ordered_put_signal import (accumulate_signal,
                                                    put_signal)
from repro_torch.kernels.rma_put import COUNTER as _K3
from repro_torch.kernels.rma_put import WAIT_COUNTER as _K3_WAIT
from repro_torch.kernels.rma_put import ring_put
from repro_torch.kernels.ring_allreduce import COUNTER as _K5
from repro_torch.kernels.ring_allreduce import ring_all_reduce
from repro_torch.kernels.ssd_pass import COUNTER as _K8_PASS
from repro_torch.kernels.ssd_pass import ssd_pass
from repro_torch.kernels.ssd_scan import COUNTER as _K8
from repro_torch.kernels.ssd_scan import ssd_intra_chunk

#: the launch counter of every ported kernel, by kernel name
COUNTERS = {c.name: c for c in (_K1, _K2, _K3, _K3_WAIT, _K4, _K5,
                                 _K6, _K7, _K8, _K8_PASS)}


def launch_counts() -> dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


__all__ = [
    "ref", "accumulate", "op_identity", "ring_accumulate", "ring_put",
    "put_signal", "accumulate_signal", "ring_all_reduce", "flash_attention",
    "ssd_intra_chunk", "ssd_pass", "ssd_scan",
    "COUNTERS", "launch_counts", "reset_launch_counts",
]
