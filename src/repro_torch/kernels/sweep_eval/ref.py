"""Plain PyTorch version of the sweep-eval kernel: the wave model's
tensor twin in int32, the kernel's arithmetic (floor division and
remainder, wraparound on overflow)."""

from __future__ import annotations

import torch

from ...core.wave_model import WaveParams, model_time_torch

SENTINEL = torch.iinfo(torch.int32).max


def sweep_ref(p: WaveParams, WG: torch.Tensor, TS: torch.Tensor) -> torch.Tensor:
    return model_time_torch(p, WG, TS, dtype=torch.int32)


def point_ops(p: WaveParams) -> int:
    """Integer operations the Minimum model needs for one configuration,
    each compare, select, add, multiply, min/max, division and remainder
    one: 11 to test TS, clamp WG as a divisor and find items, full,
    rem, g_total and cnt = min(WG, items); 8 a group time (waves, resident, the wave's
    g·TS, the sum with resident − 1, g and L) and 3 more for the
    remainder group's clamp and select; 18 to place the groups on the
    U units, add the host's g_total and mark a configuration with no
    work item; with warp scheduling, 4 a group time for gmt_eff (two
    ceiling divisions, two clamps).  A division costs the card many
    instructions; this counts it once."""

    return 11 + 2 * 8 + 3 + 18 + (8 if p.warp is not None else 0)


__all__ = ["sweep_ref", "point_ops", "SENTINEL", "WaveParams"]
