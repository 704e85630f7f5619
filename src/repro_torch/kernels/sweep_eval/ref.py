"""Plain PyTorch version of the sweep-eval kernel: the wave model's
tensor twin in int32, the kernel's arithmetic (floor division and
remainder, wraparound on overflow)."""

from __future__ import annotations

import torch

from ...core.wave_model import WaveParams, model_time_torch

SENTINEL = torch.iinfo(torch.int32).max


def sweep_ref(p: WaveParams, WG: torch.Tensor, TS: torch.Tensor) -> torch.Tensor:
    return model_time_torch(p, WG, TS, dtype=torch.int32)


__all__ = ["sweep_ref", "SENTINEL", "WaveParams"]
