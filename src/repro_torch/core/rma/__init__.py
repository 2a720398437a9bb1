"""repro_torch.core.rma — one-sided communication windows on one card.

The PyTorch port of ``repro.core.rma`` (same public names; ranks are the
rows of stacked ``(n, ...)`` tensors):

* :class:`Substrate`, :class:`FlushQueues`, :class:`PhaseLedger` — the
  substrate every window is a view over, with the scope-aware flush engine
  and the phase ledger that holds it to the reference cost model;
  :class:`CompletionToken` — cross-window ordering (``put_signal(after=)``);
* :class:`Window`, :class:`WindowConfig` — allocated windows and info keys
  (P1 scope, P2 order, P3 accumulate declarations, P4 ``dup_with_info``);
* :class:`DynamicWindow` — dynamic windows with the query and AM slow paths;
* P5 memory handles: :func:`memhandle_create`, :func:`memhandle_release`,
  :func:`win_from_memhandle`, :class:`MemhandleWindow`;
* :func:`win_op_intrinsic` and the accumulate engine (:func:`route_accumulate`,
  :func:`routed_accumulate`, :func:`crossover_elems`, :func:`accumulate_signal`);
* :class:`Topology`, :func:`default_topology`, :func:`topology_from_mesh`
  (over ``repro_torch.sharding.Mesh``) and :func:`classify_cp` (HLO text);
* :class:`RmaPlan` / :class:`CompiledPlan` — declarative plans;
* :func:`all_reduce_plan` / :func:`plan_all_reduce` — the planned ring
  (:func:`rma_all_reduce`: its deprecated imperative form);
  :func:`ring_reduce_scatter` / :func:`ring_all_gather` — the imperative
  rings;
* :func:`put_signal` / :func:`put_signal_pipelined` — payload then doorbell;
* :func:`all_to_all_plan` / :func:`plan_all_to_all` — the planned MoE
  all-to-all (:func:`rma_all_to_all`: its deprecated imperative form;
  :func:`hier_applies`: whether a topology takes the hierarchical relay);
* the plan backends (:mod:`repro_torch.core.rma.backends`):
  :data:`BACKEND_NAMES`, the :class:`Backend` protocol, the calibrated
  picker :func:`choose_backend`, and the walker :func:`interpret_plan` with
  its oracle :func:`vmapped_execute`.
"""
from repro_torch.core.rma.substrate import (SCOPE_PROCESS, SCOPE_THREAD,
                                            CompletionToken, FlushQueues,
                                            PhaseLedger, Substrate)
from repro_torch.core.rma.window import KNOWN_ACC_OPS, Window, WindowConfig
from repro_torch.core.rma.dynamic import DynamicWindow
from repro_torch.core.rma.memhandle import (MAX_MEMHANDLE_SIZE,
                                            MemhandleWindow,
                                            memhandle_create,
                                            memhandle_release,
                                            win_from_memhandle)
from repro_torch.core.rma.intrinsic import (INTRINSIC_DTYPES,
                                            INTRINSIC_MAX_COUNT,
                                            INTRINSIC_OPS, op_is_intrinsic,
                                            win_op_intrinsic)
from repro_torch.core.rma.accumulate import (PATH_INTRINSIC, PATH_SOFTWARE,
                                             PATH_TILED, accumulate_signal,
                                             apply_op, crossover_elems,
                                             route_accumulate,
                                             routed_accumulate)
from repro_torch.core.rma.topology import (Topology, classify_cp,
                                           default_topology,
                                           topology_fingerprint,
                                           topology_from_mesh)
from repro_torch.core.rma.plan import (CompiledPlan, OpRef, PlanEnv,
                                       PlanError, PlanResult, RmaPlan)
from repro_torch.core.rma.collectives import (all_reduce_plan,
                                              plan_all_reduce, put_signal,
                                              put_signal_pipelined,
                                              ring_all_gather,
                                              ring_reduce_scatter,
                                              rma_all_reduce)
from repro_torch.core.rma.alltoall import (AllToAllResult, all_to_all_plan,
                                           hier_applies, plan_all_to_all,
                                           rma_all_to_all)
from repro_torch.core.rma.backends import (BACKEND_NAMES, Backend,
                                           InterpretResult, choose_backend,
                                           interpret_plan, vmapped_execute)

__all__ = [
    "Substrate", "CompletionToken", "FlushQueues", "PhaseLedger", "Window",
    "WindowConfig",
    "SCOPE_PROCESS", "SCOPE_THREAD", "KNOWN_ACC_OPS", "DynamicWindow",
    "MAX_MEMHANDLE_SIZE", "memhandle_create", "memhandle_release",
    "win_from_memhandle", "MemhandleWindow", "win_op_intrinsic",
    "op_is_intrinsic", "INTRINSIC_OPS", "INTRINSIC_DTYPES",
    "INTRINSIC_MAX_COUNT", "PATH_INTRINSIC", "PATH_TILED", "PATH_SOFTWARE",
    "apply_op", "route_accumulate", "routed_accumulate", "accumulate_signal",
    "crossover_elems", "Topology", "default_topology", "topology_fingerprint",
    "topology_from_mesh", "classify_cp",
    "RmaPlan", "CompiledPlan", "PlanEnv", "PlanResult", "PlanError", "OpRef",
    "all_reduce_plan", "plan_all_reduce", "put_signal",
    "put_signal_pipelined", "all_to_all_plan", "plan_all_to_all",
    "rma_all_to_all", "hier_applies", "AllToAllResult", "ring_reduce_scatter",
    "ring_all_gather", "rma_all_reduce", "BACKEND_NAMES", "Backend",
    "InterpretResult", "choose_backend", "interpret_plan", "vmapped_execute",
]
