"""Public entry point + ``repro_torch.tune`` integration for the tuned
reduction — the paper's §7 Minimum problem as a (WG, TS) kernel.

``reduce_1d(x, op=...)`` reduces a 1-D tensor; omitted ``WG``/``TS``
resolve through ``@autotune`` and the port's tuning cache.  The
:class:`ReductionTunable` lattice is the kernel's launch space on the
card: WG a multiple of 32 from 64 to 1024 threads (a block's limit), TS
a power of two from the 16-byte vector's element count up (the TS values
the vector path serves), no work-group tile larger than the data and no
grid beyond 2^31 - 1 blocks.  Its cost model streams the data in waves
of resident blocks: a wave moves at the card's 3.35 TB/s unless its
blocks' loads in flight cannot cover the memory latency, so a short last
wave (the tail) runs at the rate its few blocks sustain; then the last
block folds the partials, and there is one launch.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, ClassVar, Mapping

import torch

from ...core.search_space import Param, SearchSpace, powers_of_two
from ...tune import autotune
from ..common import (HBM_BYTES_PER_S, LAUNCH_US, SMS, THREADS_PER_SM,
                      as_device_tensor, generator, resolve_device, time_fn,
                      tunable_device)
from .kernel import reduce_kernel
from .ref import block_threads, group_width, reduce_chunked

WG_VALUES = tuple(range(64, 1025, 32))
_MAX_BLOCKS = 2**31 - 1
_UNROLL = 4            # vector loads in flight a thread (the kernel's UNROLL)
# device-memory latency under load, a wave's fixed cost (its blocks' folds
# and tickets) and the last block's time per partial read from L2 by each
# of its threads, fitted together by tools/reduce_sweep_report.py on an
# H100 (int32 and bf16 at 2^28 over a grid of (WG, TS))
_LATENCY_US = 1.35
_BLOCK_US = 0.7
_L2_US = 0.25


def tuning_space(n: int, dtype_bytes: int = 4) -> SearchSpace:
    """(WG, TS) lattice for an ``n``-element reduction on the card; TS
    starts at the vector's element count, which is always allowed."""

    ts_min = 16 // dtype_bytes
    space = SearchSpace(params=[
        Param("WG", WG_VALUES),
        Param("TS", powers_of_two(ts_min, max(ts_min, n // WG_VALUES[0]))),
    ])
    space.constraints.append(
        lambda c: c["TS"] == ts_min or c["WG"] * c["TS"] <= n)
    space.constraints.append(
        lambda c: -(-n // (c["WG"] * c["TS"])) <= _MAX_BLOCKS)
    return space


def cost_model(cfg: Mapping[str, Any], *, n: int,
               dtype_bytes: int = 4) -> float:
    """Modeled microseconds on an H100 (see the module docstring).  A
    block keeps WG · ``_UNROLL`` groups of loads in flight, so it streams
    at most that many bytes per ``_LATENCY_US``; a wave of k blocks moves
    at the lesser of k such rates and the card's.  Up to
    THREADS_PER_SM / B blocks are resident on each SM."""

    WG, TS = cfg["WG"], cfg["TS"]
    blocks = -(-n // (WG * TS))
    B = block_threads(WG)
    group_bytes = group_width(TS, dtype_bytes) * dtype_bytes
    steps = TS * dtype_bytes // group_bytes
    block_rate = WG * min(_UNROLL, steps) * group_bytes / _LATENCY_US
    card_rate = HBM_BYTES_PER_S / 1e6                   # bytes per us
    chunk_bytes = WG * TS * dtype_bytes
    per_wave = SMS * min(32, THREADS_PER_SM // B)

    def wave_us(k: int) -> float:
        return k * chunk_bytes / min(card_rate, k * block_rate) + _BLOCK_US

    full, tail = divmod(blocks, per_wave)
    stream_us = full * wave_us(per_wave) + (wave_us(tail) if tail else 0.0)
    fold_us = -(-blocks // B) * _L2_US
    return stream_us + fold_us + LAUNCH_US


@dataclass(frozen=True)
class ReductionTunable:
    """``repro_torch.tune`` Tunable: (WG, TS) for an n-element reduction.
    ``device=None`` measures on the card; ``"cpu"`` on the plain version."""

    n: int
    op: str = "min"
    dtype_bytes: int = 4
    device: str | None = None
    name: ClassVar[str] = "kernels.tuned_reduction"

    def space(self) -> SearchSpace:
        return tuning_space(self.n, self.dtype_bytes)

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return cost_model(cfg, n=self.n, dtype_bytes=self.dtype_bytes)

    @functools.cached_property
    def _input(self) -> torch.Tensor:
        """Random data (f32 for 4-byte, bf16 for 2-byte elements) from a
        seeded generator on the device, made at the first ``measure()``
        and kept for every later one: a job's time is the kernel's, not
        the data's."""

        dev = resolve_device(self.device)
        dtype = torch.float32 if self.dtype_bytes == 4 else torch.bfloat16
        return torch.randn(self.n, generator=generator(dev),
                           device=dev).to(dtype)

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 3) -> float:
        """Microseconds of the kernel at this config on this Tunable's
        one seeded input."""

        x = self._input
        run = lambda: reduce_1d(x, op=self.op, WG=cfg["WG"], TS=cfg["TS"])
        return time_fn(run, device=x.device, warmup=warmup, iters=iters)

    def fingerprint(self) -> dict[str, Any]:
        fp = {"tunable": self.name, "n": self.n, "op": self.op,
              "dtype_bytes": self.dtype_bytes}
        if self.device is not None:
            fp["device"] = self.device
        return fp


def _tunable(x, *, op: str = "min", device=None) -> ReductionTunable:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return ReductionTunable(n=t.numel(), op=op, dtype_bytes=t.element_size(),
                            device=tunable_device(x, device))


@autotune(_tunable, params=("WG", "TS"))
def reduce_1d(x, *, op: str = "min", WG: int | None = None,
              TS: int | None = None, device=None) -> torch.Tensor:
    """Min, max or sum of a 1-D array (int32, f32 or bf16) as a 0-d
    tensor of its dtype; omitted ``WG``/``TS`` are auto-tuned (cached).
    Runs where ``x`` lies if it is a tensor, else on ``device``
    (``cuda:0`` by default)."""

    return reduce_kernel(as_device_tensor(x, device), op, WG, TS)


__all__ = ["reduce_1d", "ReductionTunable", "tuning_space", "cost_model",
           "reduce_chunked", "reduce_kernel", "WG_VALUES"]
