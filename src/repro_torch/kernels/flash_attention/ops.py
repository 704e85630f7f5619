"""Public entry point + ``repro_torch.tune`` integration for flash
attention.

``flash_attention(q, k, v)`` on (B, H, S, D) with block sizes omitted
resolves (block_q, block_k) through ``@autotune``: the
:class:`FlashAttentionTunable` built from the call's shapes, causality
and window is tuned on first sight and served from the port's tuning
cache afterwards.  The lattice is the set of tiles compiled into the
kernel for the dtype that divide S, each within the 227 KB of shared
memory a block may use and 1024 threads.  The cost model prices the
H100: for bf16, blocks of one q-block each, dealt out in launch order to
the 132 SMs (one block per SM), each block its relevant k-blocks and a
fixed cost at rates fitted on the card; for f32, the flops of the
visited blocks at 67 TFLOP/s (FMA) against K/V re-streamed once per
q-block at 3.35 TB/s, plus a per-tile cost of each block's load-and-sync
round.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, ClassVar, Mapping

import torch

from ...core.search_space import Param, SearchSpace
from ...tune import autotune
from ..common import (F32_FLOPS, HBM_BYTES_PER_S, LAUNCH_US, SMS,
                      as_device_tensor, generator, resolve_device, time_fn,
                      tunable_device)
from .kernel import SMEM_LIMIT, TILES, bf16_stages, flash_kernel
from .ref import attention_ref

_MAX_THREADS = 1024
# f32 (FMA kernel), a modeling assumption: one block's staged K/V tile +
# two barriers
_STEP_US = 0.3
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
    return 2 * bk * D * 4


def threads(cfg: Mapping[str, Any], dtype_bytes: int) -> int:
    """Threads of one block: two consumer warpgroups and a producer warp
    (bf16), four threads per row (f32)."""

    return 288 if dtype_bytes == 2 else cfg["block_q"] * 4


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


def wgmma_time_us(S: int, D: int, BH: int, bk: int, causal: bool = True,
                  window: int | None = None, bq: int = 128) -> float:
    """The bf16 kernel's modeled time without the launch: its blocks, the
    latest q-block of every head first as the grid launches them, each
    to the SM that frees first (one block per SM)."""

    step = _WG_STEP_US[bk] * D / 128
    fixed = _WG_BLOCK_US[bk] * D / 128
    sms = [0.0] * SMS
    for q_lo in range(S - bq, -1, -bq):
        n = k_blocks(q_lo, q_lo + bq - 1, S, bk, causal, window)[1]
        for _ in range(BH):
            heapq.heapreplace(sms, sms[0] + n * step + fixed)
    return max(sms)


def cost_model(cfg: Mapping[str, Any], *, S: int, D: int, BH: int,
               causal: bool = True, window: int | None = None,
               dtype_bytes: int = 2) -> float:
    """Modeled microseconds for the whole call on an H100."""

    bq, bk = cfg["block_q"], cfg["block_k"]
    if dtype_bytes == 2:
        return wgmma_time_us(S, D, BH, bk, causal, window, bq) + LAUNCH_US
    visited = visited_blocks(S, bq, bk, causal, window)
    compute_us = 4 * BH * visited * bq * bk * D / F32_FLOPS * 1e6
    # K and V re-streamed once per visited tile, q read and o written once
    streamed = (BH * visited * bk * D * 2 + BH * S * D * 2) * dtype_bytes
    mem_us = streamed / HBM_BYTES_PER_S * 1e6
    return max(compute_us, mem_us) + BH * visited * _STEP_US / SMS + LAUNCH_US


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

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 3) -> float:
        """Microseconds of the kernel at this tile on random q, k, v made
        from a seeded generator on the device."""

        dev = resolve_device(self.device)
        dtype = torch.bfloat16 if self.dtype_bytes == 2 else torch.float32
        g = generator(dev)
        q, k, v = (torch.randn(1, self.BH, self.S, self.D, generator=g,
                               device=dev).to(dtype) for _ in range(3))
        run = lambda: flash_attention(q, k, v, causal=self.causal,
                                      window=self.window,
                                      block_q=cfg["block_q"],
                                      block_k=cfg["block_k"])
        return time_fn(run, device=dev, warmup=warmup, iters=iters)

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
           "wgmma_time_us"]
