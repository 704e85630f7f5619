"""Public entry point + ``repro_torch.tune`` integration for the on-device
lattice sweep — the tuner tuning its own evaluator: the kernel's launch
shape (``threads`` per block × ``ept`` vectors of 4 configurations per
thread) is itself resolved through ``@autotune`` when omitted.

The lattice is the card's, not the TPU's: ``threads`` a power of two
from 64 to 1024, ``ept`` a power of two up to 16, no block covering more
than the data.  The cost model takes the larger of two times, both
derated while the card is not full of threads: three int32 arrays
streamed at 3.35 TB/s, and the issue of each configuration's
instructions (``_POINT_PS``: the kernel's instructions a point over the
issue rate it reaches); plus a per-block cost (``_BLOCK_US``) and one
launch, both constants fitted on the card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, ClassVar, Mapping

import torch

from ...core.search_space import Param, SearchSpace, powers_of_two
from ...core.wave_model import WaveParams
from ...tune import autotune
from ..common import (HBM_BYTES_PER_S, LAUNCH_US, SMS, THREADS_PER_SM,
                      as_device_tensor, generator, resolve_device, time_fn,
                      tunable_device)
from .kernel import sweep_kernel
from .ref import SENTINEL, point_ops, sweep_ref

# picoseconds of issue a configuration with the card full of threads, and
# a block's cost on its SM (scheduling, the gmt_eff table's fill), fitted
# by tools/reduce_sweep_report.py on an H100 (the dense 4096 x 4096
# lattice at every launch shape, NP = 1024, warp = 32)
_POINT_PS = 5.24
_BLOCK_US = 0.17


def tuning_space(n: int) -> SearchSpace:
    """(threads, ept) lattice for an ``n``-point sweep."""

    space = SearchSpace(params=[Param("threads", powers_of_two(64, 1024)),
                                Param("ept", powers_of_two(1, 16))])
    space.constraints.append(
        lambda c: c["ept"] == 1 or 4 * c["threads"] * c["ept"] <= n)
    return space


def cost_model(cfg: Mapping[str, Any], *, n: int) -> float:
    """Modeled microseconds on an H100 (see the module docstring)."""

    threads, ept = cfg["threads"], cfg["ept"]
    blocks = -(-n // (4 * threads * ept))
    resident = min(1.0, blocks * threads / (SMS * THREADS_PER_SM))
    stream_us = 3 * 4 * n / (HBM_BYTES_PER_S / 1e6 * resident)
    issue_us = _POINT_PS * n / 1e6 / resident
    return max(stream_us, issue_us) + blocks * _BLOCK_US / SMS + LAUNCH_US


@dataclass(frozen=True)
class SweepEvalTunable:
    """``repro_torch.tune`` Tunable: the launch shape for an n-point
    lattice sweep.  ``device=None`` measures on the card."""

    n: int
    device: str | None = None
    name: ClassVar[str] = "kernels.sweep_eval"

    def space(self) -> SearchSpace:
        return tuning_space(self.n)

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return cost_model(cfg, n=self.n)

    @functools.cached_property
    def _inputs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Random (WG, TS) points in [1, 1024] from a seeded generator on
        the device, made at the first ``measure()`` and kept for every
        later one."""

        dev = resolve_device(self.device)
        g = generator(dev)
        return tuple(torch.randint(1, 1025, (self.n,), generator=g,
                                   device=dev, dtype=torch.int32)
                     for _ in range(2))

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 3) -> float:
        """Microseconds of the kernel at this launch shape over this
        Tunable's one seeded lattice (timing depends on the lattice size
        and the launch shape, hardly on the wave parameters)."""

        wg, ts = self._inputs
        p = WaveParams(size=max(4, self.n), NP=4, GMT=4, kind="minimum")
        run = lambda: sweep_eval(wg, ts, p, threads=cfg["threads"],
                                 ept=cfg["ept"])
        return time_fn(run, device=wg.device, warmup=warmup, iters=iters)

    def fingerprint(self) -> dict[str, Any]:
        fp = {"tunable": self.name, "n": self.n}
        if self.device is not None:
            fp["device"] = self.device
        return fp


def _tunable(wg, ts, p, *, device=None) -> SweepEvalTunable:
    n = wg.numel() if isinstance(wg, torch.Tensor) else len(wg)
    return SweepEvalTunable(n=n, device=tunable_device(wg, device))


@autotune(_tunable, params=("threads", "ept"))
def sweep_eval(wg, ts, p: WaveParams, *, threads: int | None = None,
               ept: int | None = None, device=None) -> torch.Tensor:
    """Minimum-model time (int32; ``SENTINEL`` where a config has no work
    item) for flat config arrays ``wg``, ``ts``; an omitted launch shape
    is auto-tuned (cached).  Runs where ``wg`` lies if it is a tensor,
    else on ``device`` (``cuda:0`` by default)."""

    wg = as_device_tensor(wg, device)
    ts = as_device_tensor(ts, wg.device)
    return sweep_kernel(wg, ts, p, threads, ept)


__all__ = ["sweep_eval", "SweepEvalTunable", "tuning_space", "cost_model",
           "sweep_ref", "sweep_kernel", "SENTINEL", "point_ops"]
