"""repro_torch.serve — the serving stack: scheduler, KV page pool, executor
and engine, dense and paged caches with copy-on-write prefix sharing, and
the tiered pool: the paged KV window, its planned page push, and the
pinned-host cold tier with its planned tier step."""
from repro_torch.serve.engine import (Completion, Executor, Request,
                                      ServeEngine)
from repro_torch.serve.paged import (RESIDENT_COLD, RESIDENT_HOT,
                                     RESIDENT_IN_FLIGHT, HostKVTier,
                                     KVPoolManager, PagedKVWindow, PageSpec,
                                     PageTier, tier_step_plan, transfer_plan)
from repro_torch.serve.scheduler import POLICIES, SchedEntry, Scheduler

__all__ = ["Completion", "Executor", "Request", "ServeEngine",
           "KVPoolManager", "PageTier", "PageSpec", "PagedKVWindow",
           "HostKVTier", "transfer_plan", "tier_step_plan", "RESIDENT_HOT",
           "RESIDENT_COLD", "RESIDENT_IN_FLIGHT", "POLICIES", "SchedEntry",
           "Scheduler"]
