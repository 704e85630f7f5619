"""Serving runtime of the port: the continuous-batching ``Server``
(contiguous rings or paged KV with copy-on-write prefix sharing, and
speculative decoding), the page allocator, the drafters and the
scheduling policies the server delegates to."""

from .kv import NO_PAGE, PagedKVAllocator, PagedKVSpec
from .scheduler import (SCHEDULER_KINDS, FCFSScheduler, PrefixAffinityScheduler,
                        PriorityScheduler, Scheduler, make_scheduler)
from .serve import Request, Server
from .speculate import (DRAFTER_KINDS, DraftModelDrafter, Drafter,
                        NGramDrafter, make_drafter)

__all__ = ["Server", "Request", "Scheduler", "make_scheduler",
           "FCFSScheduler", "PriorityScheduler", "PrefixAffinityScheduler",
           "SCHEDULER_KINDS", "NO_PAGE", "PagedKVSpec", "PagedKVAllocator",
           "DRAFTER_KINDS", "Drafter", "NGramDrafter", "DraftModelDrafter",
           "make_drafter"]
