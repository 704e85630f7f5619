"""Core of the port: the paper's search machinery on plain Python,
numpy and torch (the port's own copies of ``repro.core`` modules).

* :class:`~repro_torch.core.platform.PlatformSpec` — the abstract platform,
* :func:`~repro_torch.core.bisect_search.find_minimal_time` — Fig. 1,
* :func:`~repro_torch.core.sweep.sweep_times` — the vectorized engine,
* :func:`~repro_torch.core.wave_model.model_time_torch` — the wave model
  on a device,
* :class:`~repro_torch.core.autotuner.TuneResult` — the shared result type.
"""

from .autotuner import TuneResult
from .bisect_search import find_minimal_time
from .counterexample import Counterexample
from .platform import PlatformSpec
from .search_space import Param, SearchSpace, powers_of_two, wg_ts_space
from .sweep import cex_oracle, sweep_times, sweep_times_torch
from .wave_model import WaveParams, model_time, model_time_torch

__all__ = [
    "TuneResult", "find_minimal_time", "Counterexample", "PlatformSpec",
    "Param", "SearchSpace", "powers_of_two", "wg_ts_space", "cex_oracle",
    "sweep_times", "sweep_times_torch", "WaveParams", "model_time",
    "model_time_torch",
]
