"""Wrapper of the hand-written CUDA sweep-eval kernel
(``csrc/sweep_eval.cu``).

A CUDA tensor launches the kernel and raises if the launch fails; a CPU
tensor takes the plain version, :func:`~.ref.sweep_ref`.  The wave
parameters are kernel arguments, so one build serves every platform.
``sweep_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ...core.wave_model import WaveParams
from .. import _build
from .ref import sweep_ref

_INT32_MAX = 2**31 - 1


def sweep_kernel(wg: torch.Tensor, ts: torch.Tensor, p: WaveParams,
                 threads: int, ept: int) -> torch.Tensor:
    """§7 Minimum model time (int32) for each (wg[i], ts[i]); blocks of
    ``threads`` threads evaluate ``ept`` configurations each."""

    if p.kind != "minimum":
        raise ValueError("the kernel implements the §7 Minimum model")
    if wg.shape != ts.shape or wg.dim() != 1 or wg.numel() < 1:
        raise ValueError(f"need equal non-empty 1-D wg/ts, got "
                         f"{tuple(wg.shape)} and {tuple(ts.shape)}")
    if wg.device != ts.device:
        raise ValueError("wg and ts must be on one device")
    params = (p.size, p.NP, p.GMT, p.L, p.ND * p.NU, p.warp or 0)
    if not all(0 <= v <= _INT32_MAX for v in params) or p.NP < 1 \
            or p.ND * p.NU < 1:
        raise ValueError(f"wave parameters out of the kernel's int32 range: {p}")
    if not (1 <= threads <= 1024 and ept >= 1):
        raise ValueError(f"bad launch parameters threads={threads} ept={ept}")
    wg = wg.to(torch.int32).contiguous()
    ts = ts.to(torch.int32).contiguous()
    if wg.device.type == "cpu":
        return sweep_ref(p, wg, ts)
    if wg.device.type != "cuda":
        raise ValueError(f"unsupported device {wg.device}")
    lib = _build.library()
    out = torch.empty_like(wg)
    with torch.cuda.device(wg.device):
        err = lib.se_sweep_eval(wg.data_ptr(), ts.data_ptr(), out.data_ptr(),
                                wg.numel(), *params, threads, ept,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "se_sweep_eval")
    sweep_kernel.launches += 1
    return out


sweep_kernel.launches = 0

__all__ = ["sweep_kernel"]
