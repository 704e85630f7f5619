"""repro_torch.tune — the unified auto-tuning API of the port.

* :class:`Tunable` — the protocol every tunable workload implements
  (``name``, ``space()``, ``cost(cfg)``, ``fingerprint()``, optional
  ``measure(cfg)``),
* :func:`tune` — the front door: ``tune(tunable, engine="sweep")``,
* :func:`register_engine` / :func:`get_engine` — the engine registry
  (``sweep``/``grid``/``bisect``/``measure``),
* :class:`TuningCache` — persistent store keyed by tunable fingerprint +
  platform (the card's name and capability) + engine,
* :func:`autotune` — decorator resolving a kernel's launch parameters
  from the cache at call time,
* :class:`TuningPlan` — declarative batches of tuning jobs.
"""

from ..core.autotuner import TuneResult
from .api import tune
from .cache import (TuningCache, cache_key, default_cache,
                    platform_fingerprint, set_default_cache,
                    tunable_fingerprint)
from .decorators import autotune
from .engines import (Engine, EngineError, available_engines, get_engine,
                      register_engine)
from .plan import (JobResult, PlanReport, TuningJob, TuningPlan,
                   available_tunables, build_tunable, register_tunable)
from .tunable import FunctionTunable, PlatformTunable, Tunable

__all__ = [
    "tune", "TuneResult", "Tunable", "FunctionTunable", "PlatformTunable",
    "Engine", "EngineError", "register_engine", "get_engine",
    "available_engines", "TuningCache", "cache_key", "default_cache",
    "set_default_cache", "platform_fingerprint", "tunable_fingerprint",
    "autotune", "TuningPlan", "TuningJob", "JobResult", "PlanReport",
    "register_tunable", "available_tunables", "build_tunable",
]
