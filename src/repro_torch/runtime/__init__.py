"""Runtime of the port: the train step and its fault-tolerant
supervisor; the continuous-batching ``Server`` (contiguous rings or paged
KV with copy-on-write prefix sharing, and speculative decoding), the
page allocator, the drafters, the scheduling policies the server
delegates to, the serving tunables with their drain harnesses, and the
seeded traffic traces the scheduler is tuned on."""

from .kv import NO_PAGE, PagedKVAllocator, PagedKVSpec
from .scheduler import (SCHEDULER_KINDS, FCFSScheduler, PrefixAffinityScheduler,
                        PriorityScheduler, Scheduler, TracingScheduler,
                        make_scheduler, register_scheduler)
from .loop import History, LoopConfig, SimulatedFailure, run_training
from .serve import Request, Server
from .speculate import (DRAFTER_KINDS, DraftModelDrafter, Drafter,
                        NGramDrafter, SpecDepthTunable, choose_spec_depth,
                        make_drafter, spec_depth_tunable)
from .train import (TrainConfig, TrainState, abstract_train_state,
                    build_train_step, init_train_state)
from .tunables import (DecodeBatchTunable, KVPageTunable, PrefillChunkTunable,
                       SchedulerTunable, choose_batch, choose_kv_page,
                       choose_prefill_chunk, choose_scheduler,
                       decode_batch_tunable, kv_page_tunable,
                       prefill_chunk_tunable, scheduler_tunable,
                       timed_server_drain, timed_trace_drain)
from .workload import (SLO_CLASSES, TraceConfig, TraceRequest, drive_trace,
                       generate_trace, summarize)

__all__ = ["Server", "Request", "Scheduler", "make_scheduler",
           "register_scheduler",
           "FCFSScheduler", "PriorityScheduler", "PrefixAffinityScheduler",
           "TracingScheduler", "SCHEDULER_KINDS", "NO_PAGE", "PagedKVSpec",
           "PagedKVAllocator",
           "DRAFTER_KINDS", "Drafter", "NGramDrafter", "DraftModelDrafter",
           "make_drafter", "SpecDepthTunable", "spec_depth_tunable",
           "choose_spec_depth",
           "DecodeBatchTunable", "PrefillChunkTunable", "KVPageTunable",
           "SchedulerTunable", "choose_batch", "choose_prefill_chunk",
           "choose_kv_page", "choose_scheduler", "decode_batch_tunable",
           "prefill_chunk_tunable", "kv_page_tunable", "scheduler_tunable",
           "timed_server_drain", "timed_trace_drain",
           "SLO_CLASSES", "TraceRequest", "TraceConfig", "generate_trace",
           "drive_trace", "summarize",
           "History", "LoopConfig", "SimulatedFailure", "run_training",
           "TrainConfig", "TrainState", "build_train_step",
           "init_train_state", "abstract_train_state"]
