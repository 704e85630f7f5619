"""Public entry point + ``repro_torch.tune`` integration for flash
attention.

``flash_attention(q, k, v)`` on (B, H, S, D) with block sizes omitted
resolves (block_q, block_k) through ``@autotune``: the
:class:`FlashAttentionTunable` built from the call's shapes, causality
and window is tuned on first sight and served from the port's tuning
cache afterwards.  The lattice is the set of tiles compiled into the
kernel that divide S, each within the 227 KB of shared memory a block
may use and 1024 threads.  The cost model prices the H100: the flops of
the visited (causal / window) blocks at 989 TFLOP/s (bf16 tensor cores)
or 67 TFLOP/s (f32 FMA) against K/V re-streamed once per q-block at
3.35 TB/s, plus a per-tile cost of each block's load-and-sync round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar, Mapping

import torch

from ...core.search_space import Param, SearchSpace
from ...tune import autotune
from ..common import (BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S, LAUNCH_US, SMS,
                      as_device_tensor, generator, resolve_device, time_fn,
                      tunable_device)
from .kernel import BLOCK_K, BLOCK_Q, flash_kernel
from .ref import attention_ref

_SMEM_LIMIT = 227 * 1024
_MAX_THREADS = 1024
# modeling assumption: one block's staged K/V tile + two barriers
_STEP_US = 0.3


def smem_bytes(cfg: Mapping[str, Any], D: int, dtype_bytes: int) -> int:
    """Dynamic shared memory of one block (see
    ``csrc/flash_attention.cu``): bf16 stages K and V^T with 8 elements of
    row padding, f32 stages K and V as they are."""

    bk = cfg["block_k"]
    if dtype_bytes == 2:
        return (bk * (D + 8) + D * (bk + 8)) * 2
    return 2 * bk * D * 4


def threads(cfg: Mapping[str, Any], dtype_bytes: int) -> int:
    """Threads of one block: a warp per 16 rows (bf16), four threads per
    row (f32)."""

    bq = cfg["block_q"]
    return bq * 2 if dtype_bytes == 2 else bq * 4


def tuning_space(S: int, D: int, dtype_bytes: int = 2) -> SearchSpace:
    """Compiled (block_q, block_k) tiles that divide S and fit a block
    (the head dim is not searched: a CUDA call with one that was not
    compiled raises in the kernel's wrapper)."""

    vals = {"block_q": tuple(b for b in BLOCK_Q if S % b == 0),
            "block_k": tuple(b for b in BLOCK_K if S % b == 0)}
    empty = [name for name, v in vals.items() if not v]
    if empty:
        raise ValueError(f"S={S} has no compiled tile for {', '.join(empty)} "
                         f"(block_q in {BLOCK_Q}, block_k in {BLOCK_K})")
    space = SearchSpace(params=[Param(k, v) for k, v in vals.items()])
    space.constraints.append(
        lambda c: smem_bytes(c, D, dtype_bytes) <= _SMEM_LIMIT
        and threads(c, dtype_bytes) <= _MAX_THREADS)
    return space


def visited_blocks(S: int, bq: int, bk: int, causal: bool = True,
                   window: int | None = None) -> int:
    """(q-block, k-block) pairs the kernel computes: a k-block is visited
    iff some (q, k) pair of the two blocks is inside the mask."""

    nq, nk = S // bq, S // bk
    visited = 0
    for i in range(nq):
        q_lo, q_hi = i * bq, (i + 1) * bq - 1
        for j in range(nk):
            k_lo, k_hi = j * bk, (j + 1) * bk - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi < q_lo - window + 1:
                continue
            visited += 1
    return visited


def visible_pairs(S: int, causal: bool = True,
                  window: int | None = None) -> int:
    """(q, k) pairs inside the mask: the work the function needs."""

    total = 0
    for qi in range(S):
        hi = qi if causal else S - 1
        lo = 0 if window is None else max(0, qi - window + 1)
        total += max(0, hi - lo + 1)
    return total


def cost_model(cfg: Mapping[str, Any], *, S: int, D: int, BH: int,
               causal: bool = True, window: int | None = None,
               dtype_bytes: int = 2) -> float:
    """Modeled microseconds for the whole call on an H100."""

    bq, bk = cfg["block_q"], cfg["block_k"]
    visited = visited_blocks(S, bq, bk, causal, window)
    peak = BF16_FLOPS if dtype_bytes == 2 else F32_FLOPS
    compute_us = 4 * BH * visited * bq * bk * D / peak * 1e6
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
           "visited_blocks", "visible_pairs"]
