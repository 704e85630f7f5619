"""Serving runtime of the port: the contiguous-cache continuous-batching
``Server`` and the scheduling policies it delegates to."""

from .scheduler import (SCHEDULER_KINDS, FCFSScheduler, PrefixAffinityScheduler,
                        PriorityScheduler, Scheduler, make_scheduler)
from .serve import Request, Server

__all__ = ["Server", "Request", "Scheduler", "make_scheduler",
           "FCFSScheduler", "PriorityScheduler", "PrefixAffinityScheduler",
           "SCHEDULER_KINDS"]
