"""Core of the port: the paper's search machinery on plain Python,
numpy and torch (the port's own copies of ``repro.core`` modules).

* :class:`~repro_torch.core.platform.PlatformSpec` +
  :func:`~repro_torch.core.platform.build_model` — the abstract platform
  as a Promela-like process system,
* :func:`~repro_torch.core.explorer.explore` — explicit-state
  verification,
* :class:`~repro_torch.core.properties.OverTime` / ``NonTermination`` —
  Φ_o / Φ_t,
* :func:`~repro_torch.core.bisect_search.find_minimal_time` — Fig. 1,
* :func:`~repro_torch.core.swarm.swarm_search` — Fig. 5,
* :func:`~repro_torch.core.sweep.sweep_times` — the vectorized engine,
* :func:`~repro_torch.core.wave_model.model_time_torch` — the wave model
  on a device,
* :class:`~repro_torch.core.autotuner.TuneResult` — the shared result type.
"""

from .autotuner import TuneResult
from .bisect_search import find_minimal_time
from .counterexample import Counterexample
from .explorer import ExploreResult, explore, replay
from .platform import PlatformSpec, build_model
from .properties import NonTermination, OverTime, trace_satisfies
from .search_space import Param, SearchSpace, powers_of_two, wg_ts_space
from .swarm import swarm_search
from .sweep import cex_oracle, sweep_times, sweep_times_torch
from .wave_model import WaveParams, gmt_from_spec, model_time, model_time_torch

__all__ = [
    "TuneResult", "find_minimal_time",
    "Counterexample", "ExploreResult", "explore", "replay", "PlatformSpec",
    "build_model", "NonTermination", "OverTime", "trace_satisfies", "Param",
    "SearchSpace", "powers_of_two", "wg_ts_space", "swarm_search",
    "cex_oracle", "sweep_times", "sweep_times_torch", "WaveParams",
    "gmt_from_spec", "model_time", "model_time_torch",
]
