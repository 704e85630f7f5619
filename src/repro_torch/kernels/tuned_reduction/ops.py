"""Public entry point + ``repro_torch.tune`` integration for the tuned
reduction — the paper's §7 Minimum problem as a (WG, TS) kernel.

``reduce_1d(x, op=...)`` reduces a 1-D tensor; omitted ``WG``/``TS``
resolve through ``@autotune`` and the port's tuning cache.  The
:class:`ReductionTunable` lattice is the kernel's launch space on the
card: WG a multiple of 32 from 64 to 1024 threads (a block's limit), TS
a power of two, no work-group tile larger than the data and no grid
beyond 2^31 - 1 blocks.  Its cost model prices device-memory streaming
at the H100's 3.35 TB/s, scaled down when too few threads are in flight
to cover the memory latency, plus the second pass that folds one partial
per block on one SM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar, Mapping

import torch

from ...core.search_space import Param, SearchSpace, powers_of_two
from ...tune import autotune
from ..common import (HBM_BYTES_PER_S, LAUNCH_US, SMS, THREADS_PER_SM,
                      as_device_tensor, generator, resolve_device, time_fn,
                      tunable_device)
from .kernel import reduce_kernel
from .ref import reduce_chunked

WG_VALUES = tuple(range(64, 1025, 32))
_MAX_BLOCKS = 2**31 - 1


def tuning_space(n: int) -> SearchSpace:
    """(WG, TS) lattice for an ``n``-element reduction on the card."""

    space = SearchSpace(params=[
        Param("WG", WG_VALUES),
        Param("TS", powers_of_two(1, max(1, n // WG_VALUES[0]))),
    ])
    space.constraints.append(
        lambda c: c["TS"] == 1 or c["WG"] * c["TS"] <= n)
    space.constraints.append(
        lambda c: -(-n // (c["WG"] * c["TS"])) <= _MAX_BLOCKS)
    return space


def cost_model(cfg: Mapping[str, Any], *, n: int,
               dtype_bytes: int = 4) -> float:
    """Modeled microseconds on an H100: stream n elements at the memory
    rate (derated when fewer than a full card of threads is resident),
    fold one 4-byte partial per block on one SM's share of the
    bandwidth, and pay two launches."""

    WG, TS = cfg["WG"], cfg["TS"]
    blocks = -(-n // (WG * TS))
    resident = min(1.0, blocks * WG / (SMS * THREADS_PER_SM))
    bytes_per_us = HBM_BYTES_PER_S / 1e6
    stream_us = n * dtype_bytes / (bytes_per_us * resident)
    fold_us = blocks * 4 / (bytes_per_us / SMS)
    return stream_us + fold_us + 2 * LAUNCH_US


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
        return tuning_space(self.n)

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return cost_model(cfg, n=self.n, dtype_bytes=self.dtype_bytes)

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 3) -> float:
        """Microseconds of the kernel at this config on random data
        (f32 for 4-byte, bf16 for 2-byte elements), made from a seeded
        generator on the device."""

        dev = resolve_device(self.device)
        dtype = torch.float32 if self.dtype_bytes == 4 else torch.bfloat16
        x = torch.randn(self.n, generator=generator(dev), device=dev).to(dtype)
        run = lambda: reduce_1d(x, op=self.op, WG=cfg["WG"], TS=cfg["TS"])
        return time_fn(run, device=dev, warmup=warmup, iters=iters)

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
