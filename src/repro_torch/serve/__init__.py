from .blocks import (AdmissionRefusal, BlockManager, NULL_PAGE,
                     PoolExhausted, kv_bytes_per_block,
                     pool_pages_for_budget)
from .engine import ContinuousEngine, Engine
from .scheduler import DeadlineExceeded, Request, Scheduler

__all__ = ["Engine", "ContinuousEngine", "Request", "Scheduler",
           "BlockManager", "AdmissionRefusal", "DeadlineExceeded",
           "PoolExhausted", "NULL_PAGE", "kv_bytes_per_block",
           "pool_pages_for_budget"]
