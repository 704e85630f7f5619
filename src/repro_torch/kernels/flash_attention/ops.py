"""Public entry point + ``repro_torch.tune`` integration for flash
attention.

``flash_attention(q, k, v)`` on (B, H, S, D) with block sizes omitted
resolves (block_q, block_k) through ``@autotune``: the
:class:`FlashAttentionTunable` built from the call's shapes, causality
and window is tuned on first sight and served from the port's tuning
cache afterwards.  The lattice is the set of tiles compiled into the
kernel for the dtype that divide S, each within the 227 KB of shared
memory a block may use and 1024 threads.  The cost model prices the
H100: blocks of one q-block each, dealt out in launch order to the SMs
(one bf16 block per SM; one or two f32 blocks, as their shared memory
lets), each block its relevant k-blocks and a fixed cost at rates fitted
on the card per dtype and tile.
"""

from __future__ import annotations

import functools
import heapq
from dataclasses import dataclass
from typing import Any, ClassVar, Mapping

import torch

from ...core.search_space import Param, SearchSpace
from ...tune import autotune
from ..common import (LAUNCH_US, SMS, as_device_tensor, generator,
                      resolve_device, time_fn, tunable_device)
from .kernel import (SMEM_LIMIT, TILES, bf16_stages, f32_blocks_per_sm,
                     f32_smem_bytes, flash_kernel)
from .ref import attention_ref

_MAX_THREADS = 1024
# f32 (FMA kernel), per head dim and (block_q, block_k): the SM time of
# one block's k-block and of its fixed cost (blocks that share an SM split
# its rate), fitted on an NVIDIA H100 80GB HBM3 at a 700 W power limit to
# each tile's median time at (1, 20, 1024, 64) and (1, 20, 4096, 128),
# causal and not (tools/flash_report.py, "f32_fit"; a negative fixed cost
# fitted as 0)
_F32_STEP_US = {
    64: {(64, 32): 2.061, (64, 64): 5.189, (128, 32): 7.731,
         (128, 64): 13.91},
    128: {(64, 32): 4.080, (64, 64): 8.300, (128, 32): 7.994,
          (128, 64): 13.99}}
_F32_BLOCK_US = {
    64: {(64, 32): 28.76, (64, 64): 9.347, (128, 32): 0.0, (128, 64): 0.0},
    128: {(64, 32): 1.301, (64, 64): 0.0, (128, 32): 9.540, (128, 64): 15.20}}
# bf16 (wgmma kernel), per block_k at D = 128 (other head dims in
# proportion to D): the time one block takes for a k-block, and its fixed
# cost (Q's load, the ring's fill, the epilogue), fitted on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit to each tile's median time at
# (1, 20, 4096, 128), causal and not (tools/flash_report.py, "fit")
_WG_STEP_US = {64: 1.021, 128: 2.443}
_WG_BLOCK_US = {64: 4.49, 128: 2.92}


def smem_bytes(cfg: Mapping[str, Any], D: int, dtype_bytes: int) -> int:
    """Dynamic shared memory of one block (see
    ``csrc/flash_attention.cu``)."""

    bq, bk = cfg["block_q"], cfg["block_k"]
    if dtype_bytes == 2:
        # 1024 bytes to align Q and the ring for the 128-byte swizzle, the
        # Q tile, the stages of K and V tiles, Q's barrier and a full and
        # an empty barrier per stage
        stages = bf16_stages(bk, D)
        return 1024 + bq * D * 2 + stages * 2 * bk * D * 2 + \
            (1 + 2 * stages) * 8
    return f32_smem_bytes(bq, bk, D)


def threads(cfg: Mapping[str, Any], dtype_bytes: int) -> int:
    """Threads of one block: two consumer warpgroups and a producer warp
    (bf16), 16 per 8 query rows (f32)."""

    return 288 if dtype_bytes == 2 else cfg["block_q"] * 2


def tuning_space(S: int, D: int, dtype_bytes: int = 2) -> SearchSpace:
    """Compiled (block_q, block_k) tiles for the dtype that divide S and
    fit a block (the head dim is not searched: a CUDA call with one that
    was not compiled raises in the kernel's wrapper)."""

    tiles = TILES[dtype_bytes]
    vals = {name: tuple(b for b in tiles[name] if S % b == 0)
            for name in ("block_q", "block_k")}
    empty = [name for name, v in vals.items() if not v]
    if empty:
        raise ValueError(f"S={S} has no compiled tile for {', '.join(empty)} "
                         f"(block_q in {tiles['block_q']}, block_k in "
                         f"{tiles['block_k']})")
    space = SearchSpace(params=[Param(k, v) for k, v in vals.items()])
    space.constraints.append(
        lambda c: smem_bytes(c, D, dtype_bytes) <= SMEM_LIMIT
        and threads(c, dtype_bytes) <= _MAX_THREADS)
    return space


def k_blocks(q_lo: int, q_hi: int, S: int, bk: int, causal: bool = True,
             window: int | None = None) -> tuple[int, int]:
    """The k-blocks holding a key some row of [q_lo, q_hi] sees: the
    first one and how many (the kernel's ``Mask::k_blocks``).  A causal
    window of 0 leaves every row without a key."""

    lo = 0 if window is None else max(0, q_lo - window + 1)
    hi = q_hi if causal else S - 1
    first = lo // bk
    if (causal and window is not None and window < 1) or lo > hi:
        return first, 0
    return first, hi // bk - first + 1


def visited_blocks(S: int, bq: int, bk: int, causal: bool = True,
                   window: int | None = None) -> int:
    """(q-block, k-block) pairs the kernel computes: a k-block is visited
    iff some (q, k) pair of the two blocks is inside the mask."""

    return sum(k_blocks(q_lo, q_lo + bq - 1, S, bk, causal, window)[1]
               for q_lo in range(0, S, bq))


def visible_pairs(S: int, causal: bool = True,
                  window: int | None = None) -> int:
    """(q, k) pairs inside the mask: the work the function needs."""

    total = 0
    for qi in range(S):
        hi = qi if causal else S - 1
        lo = 0 if window is None else max(0, qi - window + 1)
        total += max(0, hi - lo + 1)
    return total


def schedule_us(S: int, BH: int, bq: int, bk: int, step: float, fixed: float,
                slots: int, causal: bool = True,
                window: int | None = None) -> float:
    """Modeled time of a grid of one block per (head, q-block), the
    latest q-block of every head first as the kernels launch them, each
    block to the slot that frees first: ``step`` a visited k-block plus
    ``fixed`` a block."""

    busy = [0.0] * slots
    for q_lo in range(S - bq, -1, -bq):
        n = k_blocks(q_lo, q_lo + bq - 1, S, bk, causal, window)[1]
        for _ in range(BH):
            heapq.heapreplace(busy, busy[0] + n * step + fixed)
    return max(busy)


def wgmma_time_us(S: int, D: int, BH: int, bk: int, causal: bool = True,
                  window: int | None = None, bq: int = 128) -> float:
    """The bf16 kernel's modeled time without the launch (one block per
    SM)."""

    return schedule_us(S, BH, bq, bk, _WG_STEP_US[bk] * D / 128,
                       _WG_BLOCK_US[bk] * D / 128, SMS, causal, window)


def ffma_time_us(S: int, D: int, BH: int, bq: int, bk: int,
                 causal: bool = True, window: int | None = None) -> float:
    """The f32 kernel's modeled time without the launch: b blocks to an
    SM (``f32_blocks_per_sm``), each at 1/b of the SM's rate fitted at
    its head dim."""

    b = f32_blocks_per_sm(bq, bk, D)
    # a head dim that was not fitted (on the CPU) scales the nearer one's
    fit = 64 if D <= 64 else 128
    scale = b * D / fit
    return schedule_us(S, BH, bq, bk, scale * _F32_STEP_US[fit][(bq, bk)],
                       scale * _F32_BLOCK_US[fit][(bq, bk)], SMS * b, causal,
                       window)


def cost_model(cfg: Mapping[str, Any], *, S: int, D: int, BH: int,
               causal: bool = True, window: int | None = None,
               dtype_bytes: int = 2) -> float:
    """Modeled microseconds for the whole call on an H100."""

    bq, bk = cfg["block_q"], cfg["block_k"]
    if dtype_bytes == 2:
        return wgmma_time_us(S, D, BH, bk, causal, window, bq) + LAUNCH_US
    return ffma_time_us(S, D, BH, bq, bk, causal, window) + LAUNCH_US


@dataclass(frozen=True)
class FlashAttentionTunable:
    """``repro_torch.tune`` Tunable: (block_q, block_k) for (B*H, S, D)
    attention under a causality mask and an optional window (bf16 for
    2-byte, f32 for 4-byte elements).  ``device=None`` measures on the
    card."""

    S: int
    D: int
    BH: int
    causal: bool = True
    window: int | None = None
    dtype_bytes: int = 2
    device: str | None = None
    name: ClassVar[str] = "kernels.flash_attention"

    def space(self) -> SearchSpace:
        return tuning_space(self.S, self.D, self.dtype_bytes)

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return cost_model(cfg, S=self.S, D=self.D, BH=self.BH,
                          causal=self.causal, window=self.window,
                          dtype_bytes=self.dtype_bytes)

    @functools.cached_property
    def _inputs(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Random q, k, v from a seeded generator on the device, made at
        the first ``measure()`` and kept for every later one."""

        dev = resolve_device(self.device)
        dtype = torch.bfloat16 if self.dtype_bytes == 2 else torch.float32
        g = generator(dev)
        return tuple(torch.randn(1, self.BH, self.S, self.D, generator=g,
                                 device=dev).to(dtype) for _ in range(3))

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 3) -> float:
        """Microseconds of the kernel at this tile on this Tunable's one
        seeded q, k, v."""

        q, k, v = self._inputs
        run = lambda: flash_attention(q, k, v, causal=self.causal,
                                      window=self.window,
                                      block_q=cfg["block_q"],
                                      block_k=cfg["block_k"])
        return time_fn(run, device=q.device, warmup=warmup, iters=iters)

    def fingerprint(self) -> dict[str, Any]:
        fp = {"tunable": self.name, "S": self.S, "D": self.D, "BH": self.BH,
              "causal": self.causal, "window": self.window,
              "dtype_bytes": self.dtype_bytes}
        if self.device is not None:
            fp["device"] = self.device
        return fp


def _tunable(q, k, v, *, causal: bool = True, window: int | None = None,
             device=None) -> FlashAttentionTunable:
    tq = q if isinstance(q, torch.Tensor) else torch.as_tensor(q)
    B, H, S, D = tq.shape
    return FlashAttentionTunable(S=S, D=D, BH=B * H, causal=causal,
                                 window=window,
                                 dtype_bytes=tq.element_size(),
                                 device=tunable_device(q, device))


@autotune(_tunable, params=("block_q", "block_k"))
def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, block_q: int | None = None,
                    block_k: int | None = None, device=None) -> torch.Tensor:
    """q, k, v: (B, H, S, D) -> (B, H, S, D).  GQA callers broadcast KV
    heads first.  Omitted block sizes are auto-tuned (cached).  Runs
    where ``q`` lies if it is a tensor, else on ``device`` (``cuda:0``
    by default)."""

    q = as_device_tensor(q, device)
    k = as_device_tensor(k, q.device)
    v = as_device_tensor(v, q.device)
    B, H, S, D = q.shape
    fold = lambda x: x.reshape(B * H, S, D)
    o = flash_kernel(fold(q), fold(k), fold(v), causal=causal,
                     window=window, block_q=block_q, block_k=block_k)
    return o.reshape(B, H, S, D)


__all__ = ["flash_attention", "FlashAttentionTunable", "tuning_space",
           "cost_model", "attention_ref", "flash_kernel", "smem_bytes",
           "threads", "k_blocks", "visited_blocks", "visible_pairs",
           "wgmma_time_us", "ffma_time_us", "schedule_us"]
