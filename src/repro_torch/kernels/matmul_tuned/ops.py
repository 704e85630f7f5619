"""Public entry point + ``repro_torch.tune`` integration for the tiled
matmul (the paper's §8 case study).

``matmul_tuned(a, b)`` with tile sizes omitted resolves (bm, bn, bk)
through ``@autotune``: the :class:`MatmulTunable` built from the operand
shapes is tuned on first sight and served from the port's tuning cache
afterwards.  The lattice is the set of tile shapes compiled into the
kernel for the operands' dtype that divide the problem, each within the
227 KB of dynamic shared memory a block may use.  The cost model prices
the H100: for bf16, waves of output tiles over the 132 SMs, each tile
its K steps and its epilogue at rates fitted on the card; for f32, the
larger of the flops at 67 TFLOP/s (FMA) and the operand panels
re-streamed at 3.35 TB/s, plus a per-K-step cost fitted on the card.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, ClassVar, Mapping

import torch

from ...core.search_space import Param, SearchSpace
from ...tune import autotune
from ..common import (F32_FLOPS, HBM_BYTES_PER_S, LAUNCH_US, SMS,
                      as_device_tensor, generator, resolve_device, time_fn,
                      tunable_device)
from .kernel import (BF16_STAGES, TILES, f32_stage_bytes, f32_stages,
                     matmul_kernel)
from .ref import matmul_ref

_SMEM_LIMIT = 227 * 1024
# f32 (FMA kernel): what one block's K step costs beyond the flops at
# 67 TFLOP/s (or the streamed bytes), the least-squares fit over every
# f32 tile at 4096 x 4096 x {1024, 4096} on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit (tools/matmul_report.py, "f32_fit")
_STEP_US = 0.5375
# bf16 (wgmma kernel), per bn: the time of one block's K step and of one
# tile's epilogue, fitted on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit to each tile's median time at 8192 x 8192 x {1024, 8192}
# (tools/matmul_report.py, "fit"); the medians include bursts at the
# clock the card settles to under sustained load
_WG_STEP_US = {128: 0.446, 256: 0.780}
_WG_EPILOGUE_US = {128: 0.98, 256: 1.02}


def smem_bytes(cfg: Mapping[str, Any], dtype_bytes: int) -> int:
    """Dynamic shared memory of one block (see ``csrc/matmul_tuned.cu``)."""

    bm, bn, bk = cfg["bm"], cfg["bn"], cfg["bk"]
    if dtype_bytes == 2:
        # 1024 bytes to align the ring for the 128-byte swizzle, the
        # stages of A and B tiles, a full and an empty barrier per stage
        stages = BF16_STAGES[bn]
        return 1024 + stages * (bm * bk + bk * bn) * 2 + 2 * stages * 8
    return f32_stages(bm, bn, bk) * f32_stage_bytes(bm, bn, bk)


def tuning_space(M: int, N: int, K: int, dtype_bytes: int = 2) -> SearchSpace:
    """Tile shapes compiled for the dtype that divide (M, N, K)."""

    tiles = TILES[dtype_bytes]
    vals = {name: tuple(v for v in tiles[name] if dim % v == 0)
            for name, dim in (("bm", M), ("bn", N), ("bk", K))}
    empty = [name for name, v in vals.items() if not v]
    if empty:
        raise ValueError(f"({M}, {N}, {K}) has no compiled tile for "
                         f"{', '.join(empty)} (bm in {tiles['bm']}, bn in "
                         f"{tiles['bn']}, bk in {tiles['bk']})")
    space = SearchSpace(params=[Param(k, v) for k, v in vals.items()])
    space.constraints.append(
        lambda c: smem_bytes(c, dtype_bytes) <= _SMEM_LIMIT)
    return space


def cost_model(cfg: Mapping[str, Any], *, M: int, N: int, K: int,
               dtype_bytes: int = 2) -> float:
    """Modeled microseconds for the whole product on an H100."""

    bm, bn, bk = cfg["bm"], cfg["bn"], cfg["bk"]
    if dtype_bytes == 2:
        # one block per SM: the tiles run in waves of 132
        waves = math.ceil((M // bm) * (N // bn) / SMS)
        tile_us = (K // bk) * _WG_STEP_US[bn] + _WG_EPILOGUE_US[bn]
        return waves * tile_us + LAUNCH_US
    compute_us = 2 * M * N * K / F32_FLOPS * 1e6
    # A is read once per column of tiles, B once per row of tiles
    streamed = (M * K * (N // bn) + K * N * (M // bm) + M * N) * dtype_bytes
    mem_us = streamed / HBM_BYTES_PER_S * 1e6
    steps = (M // bm) * (N // bn) * (K // bk)
    return max(compute_us, mem_us) + steps * _STEP_US / SMS + LAUNCH_US


@dataclass(frozen=True)
class MatmulTunable:
    """``repro_torch.tune`` Tunable: (bm, bn, bk) for an (M, K) x (K, N)
    matmul (bf16 for 2-byte, f32 for 4-byte elements).
    ``device=None`` measures on the card."""

    M: int
    N: int
    K: int
    dtype_bytes: int = 2
    device: str | None = None
    name: ClassVar[str] = "kernels.matmul_tuned"

    def space(self) -> SearchSpace:
        return tuning_space(self.M, self.N, self.K, self.dtype_bytes)

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return cost_model(cfg, M=self.M, N=self.N, K=self.K,
                          dtype_bytes=self.dtype_bytes)

    @functools.cached_property
    def _inputs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Random operands from a seeded generator on the device, made at
        the first ``measure()`` and kept for every later one."""

        dev = resolve_device(self.device)
        dtype = torch.bfloat16 if self.dtype_bytes == 2 else torch.float32
        g = generator(dev)
        a = torch.randn(self.M, self.K, generator=g, device=dev).to(dtype)
        b = torch.randn(self.K, self.N, generator=g, device=dev).to(dtype)
        return a, b

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 3) -> float:
        """Microseconds of the kernel at this tile on this Tunable's one
        seeded pair of operands."""

        a, b = self._inputs
        run = lambda: matmul_tuned(a, b, bm=cfg["bm"], bn=cfg["bn"],
                                   bk=cfg["bk"])
        return time_fn(run, device=a.device, warmup=warmup, iters=iters)

    def fingerprint(self) -> dict[str, Any]:
        fp = {"tunable": self.name, "M": self.M, "N": self.N, "K": self.K,
              "dtype_bytes": self.dtype_bytes}
        if self.device is not None:
            fp["device"] = self.device
        return fp


def _tunable(a, b, *, device=None) -> MatmulTunable:
    ta = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    tb = b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
    return MatmulTunable(M=ta.shape[0], N=tb.shape[1], K=ta.shape[1],
                         dtype_bytes=ta.element_size(),
                         device=tunable_device(a, device))


@autotune(_tunable, params=("bm", "bn", "bk"))
def matmul_tuned(a, b, *, bm: int | None = None, bn: int | None = None,
                 bk: int | None = None, device=None) -> torch.Tensor:
    """Tiled matmul of two f32 or two bf16 matrices; omitted tile sizes
    are auto-tuned (cached).  Runs where ``a`` lies if it is a tensor,
    else on ``device`` (``cuda:0`` by default)."""

    a = as_device_tensor(a, device)
    b = as_device_tensor(b, a.device)
    return matmul_kernel(a, b, bm, bn, bk)


__all__ = ["matmul_tuned", "MatmulTunable", "tuning_space", "cost_model",
           "matmul_ref", "matmul_kernel", "smem_bytes"]
