"""Fault tolerance: straggler detection, fault injection, elastic recovery
(the port of the JAX package's ``ft``).

* :mod:`repro_torch.ft.straggler` — EMA-based slow-worker detection with
  per-source escalation (the controller's sensor).
* :mod:`repro_torch.ft.inject` — deterministic, seedable fault scripts
  (slow-step / dead-worker / lost-doorbell / rejoin) so every recovery
  path runs without real hardware failures.
* :mod:`repro_torch.ft.elastic` — the control plane: worker lifecycle
  (healthy → suspect → quarantined → evicted/rejoined), topology-targeted
  plan recompilation, live KV-page migration, sequence re-admission.

See ``docs/elastic.md`` for the state machine and the fault-script
syntax.
"""
from repro_torch.ft.elastic import (
    ElasticController,
    ElasticServing,
    MIGRATION_STREAM,
    RecoveryReport,
    Transition,
    WorkerState,
    migrate_pages,
    shrink_topology,
)
from repro_torch.ft.inject import FAULT_KINDS, Fault, FaultInjector, FaultScript
from repro_torch.ft.straggler import StragglerEvent, StragglerMonitor

__all__ = [
    "StragglerMonitor", "StragglerEvent",
    "Fault", "FaultScript", "FaultInjector", "FAULT_KINDS",
    "ElasticController", "ElasticServing", "WorkerState", "Transition",
    "RecoveryReport", "shrink_topology", "migrate_pages", "MIGRATION_STREAM",
]
