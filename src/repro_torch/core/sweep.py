"""Vectorized configuration sweep — the beyond-paper engine.

Because the platform model's time is a pure function of the
configuration, the whole (WG, TS) lattice collapses to one data-parallel
evaluation:

* exact integer path (numpy int64, :func:`sweep_times`) — the default
  oracle of the ``sweep`` engine,
* tensor path (:func:`sweep_times_torch`) — the same formulas on a
  device, the counterpart of ``repro.core.sweep.sweep_times_jit``.

:func:`cex_oracle` answers the paper's "is there a counterexample to
Φ_o(T)?" so Fig. 1's bisection loop runs unchanged on top of the sweep.
The port's copy of ``repro.core.sweep``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .counterexample import Counterexample
from .search_space import SearchSpace, wg_ts_space
from .wave_model import WaveParams, model_time_torch


@dataclass
class SweepResult:
    best_config: dict
    t_min: int
    times: np.ndarray
    configs: dict[str, np.ndarray]
    evaluated: int


def sweep_times(p: WaveParams, space: SearchSpace | None = None) -> SweepResult:
    """Evaluate the exact model time for every lattice point (numpy)."""

    space = space or wg_ts_space(p.size)
    arrs = space.to_arrays()
    WG, TS = arrs["WG"].astype(np.int64), arrs["TS"].astype(np.int64)
    items = p.size // TS
    valid = items >= 1
    times = np.full(WG.shape, np.int64(2**62))
    # vectorized closed form (identical to wave_model.model_time)
    full = np.where(valid, items // np.maximum(WG, 1), 0)
    rem = np.where(valid, items % np.maximum(WG, 1), 0)
    short = full == 0
    full = np.where(short, 0, full)
    rem = np.where(short, items, rem)
    g_total = full + (rem > 0)
    cnt_full = np.minimum(WG, items)

    def gmt_eff(resident):
        if p.warp is None:
            return p.GMT
        n_warps = np.maximum(1, -(-resident // p.warp))
        return np.maximum(1, -(-p.GMT // n_warps))

    def wave_time(its, resident):
        g = gmt_eff(resident)
        if p.kind == "abstract":
            return its * (g * TS + TS) + g
        return g * TS

    def group_time(cnt):
        waves = -(-cnt // p.NP)
        resident = np.minimum(cnt, p.NP)
        t = waves * wave_time(items, resident)
        if p.kind == "minimum":
            t = t + (resident - 1) + gmt_eff(resident)
        return t + p.L

    U = p.ND * p.NU
    t_full = group_time(cnt_full)
    t_rem = np.where(rem > 0, group_time(np.maximum(rem, 1)), 0)
    count0 = -(-g_total // U)
    r = (g_total - 1) % U
    count_r = -(-(g_total - r) // U)
    t0 = count0 * t_full - np.where(r == 0, t_full - t_rem, 0)
    tr = count_r * t_full - (t_full - t_rem)
    device_t = np.where(rem > 0, np.maximum(t0, tr), count0 * t_full)
    host_t = g_total if p.kind == "minimum" else 0
    times = np.where(valid, device_t + host_t, times)

    i = int(np.argmin(times))
    best = {k: int(v[i]) for k, v in arrs.items()}
    return SweepResult(best_config=best, t_min=int(times[i]), times=times,
                       configs=arrs, evaluated=len(WG))


def sweep_times_torch(p: WaveParams, WG: torch.Tensor,
                      TS: torch.Tensor) -> torch.Tensor:
    """Model times for flat (WG, TS) tensors on their device (int64)."""

    return model_time_torch(p, WG, TS)


def cex_oracle(p: WaveParams, space: SearchSpace | None = None
               ) -> Callable[[int], Counterexample | None]:
    """Adapt the sweep to the paper's C_ex(T) protocol: return a
    counterexample to Φ_o(T) (a config terminating with time ≤ T), or
    None if Φ_o(T) holds over the whole lattice."""

    res = sweep_times(p, space)

    def oracle(T: int) -> Counterexample | None:
        mask = res.times <= T
        if not mask.any():
            return None
        # the strongest admissible witness (any would do; it only speeds
        # the bisection up)
        idx = int(np.argmin(np.where(mask, res.times, np.int64(2**62))))
        cfg = {k: int(v[idx]) for k, v in res.configs.items()}
        return Counterexample(time=int(res.times[idx]), config=cfg,
                              trail=(), depth=0)

    return oracle


__all__ = ["sweep_times", "sweep_times_torch", "cex_oracle", "SweepResult"]
