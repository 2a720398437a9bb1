"""repro_torch.serve — the serving stack: scheduler, KV page pool, executor
and engine, dense and paged caches with copy-on-write prefix sharing."""
from repro_torch.serve.engine import (Completion, Executor, Request,
                                      ServeEngine)
from repro_torch.serve.paged import KVPoolManager, PageTier
from repro_torch.serve.scheduler import POLICIES, SchedEntry, Scheduler

__all__ = ["Completion", "Executor", "Request", "ServeEngine",
           "KVPoolManager", "PageTier", "POLICIES", "SchedEntry", "Scheduler"]
