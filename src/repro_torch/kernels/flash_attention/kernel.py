"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

A CUDA tensor launches the kernel (a TMA + ``wgmma`` pipeline for bf16,
the FMA path for f32) and raises if the head dim or tile was not compiled or
the launch fails; a CPU tensor takes the plain version,
:func:`~.ref.attention_ref`.  ``flash_kernel.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

# the (block_q, block_k) tiles compiled as template instantiations, per
# element size: bf16 has block_q = 128 (two consumer warpgroups of 64 rows)
# and block_k in {64, 128} (wgmma widths); f32 (the FMA kernel, 16 threads
# per 8 query rows) has block_q in {64, 128} and block_k in {32, 64}, each
# of which fits a block with its two-stage K/V ring at both head dims.
# Both compile the head dims HEAD_DIMS.
TILES = {
    2: {"block_q": (128,), "block_k": (64, 128)},
    4: {"block_q": (64, 128), "block_k": (32, 64)},
}
HEAD_DIMS = (64, 128)
# the most dynamic shared memory a block may have on Hopper (227 KB), and
# the most each of two blocks sharing an SM may have
SMEM_LIMIT = 232448
SMEM_PAIR = 115712
# depth of the f32 kernel's K/V ring (csrc/flash_attention.cu, ffma)
F32_STAGES = 2


def f32_smem_bytes(block_q: int, block_k: int, D: int) -> int:
    """Shared memory of one f32 block: the (block_q, D) Q tile, the ring's
    K and V tiles, and the (block_q, block_k) P tile, all f32."""

    return (block_q * D + F32_STAGES * 2 * block_k * D + block_q * block_k) * 4


def f32_blocks_per_sm(block_q: int, block_k: int, D: int) -> int:
    """Blocks of the f32 kernel that share an SM: ptxas gives a thread
    160-224 registers, so a block of 256 threads (block_q = 128) has an
    SM to itself, and two of 128 (block_q = 64) share one where their
    shared memory allows."""

    if block_q == 128:
        return 1
    return 2 if f32_smem_bytes(block_q, block_k, D) <= SMEM_PAIR else 1
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}


def bf16_stages(block_k: int, D: int) -> int:
    """Depth of the bf16 kernel's K/V ring: the deepest that fits 227 KB
    beside 1024 bytes of alignment slack, the (128, D) Q tile and the
    barriers (csrc/flash_attention.cu, ``wg::Tile``)."""

    q_bytes, stage = 128 * D * 2, 2 * block_k * D * 2
    return (SMEM_LIMIT - 1024 - q_bytes - 8) // (stage + 16)


def flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int | None = None,
                 block_q: int, block_k: int) -> torch.Tensor:
    """q, k, v: (BH, S, D) with S divisible by the blocks (each clamped
    to S, as the reference clamps them) -> (BH, S, D) in q's dtype,
    scale ``D ** -0.5``."""

    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"need three (BH, S, D) tensors of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"need f32 or bf16 q, k, v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    BH, S, D = q.shape
    block_q, block_k = min(block_q, S), min(block_k, S)
    if block_q < 1 or block_k < 1 or S % block_q or S % block_k:
        raise ValueError(f"S={S} not divisible by the blocks "
                         f"({block_q}, {block_k})")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not compiled; D in {HEAD_DIMS}")
    tiles = TILES[q.element_size()]
    if block_q not in tiles["block_q"] or block_k not in tiles["block_k"]:
        raise ValueError(f"tile ({block_q}, {block_k}) is not compiled for "
                         f"{q.dtype}; block_q in {tiles['block_q']}, "
                         f"block_k in {tiles['block_k']}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k, v must be 16-byte aligned")
    o = torch.empty_like(q)
    lib = _build.library()
    has_window = window is not None
    with torch.cuda.device(q.device):
        err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), BH, S, D, _DTYPE_CODE[q.dtype],
                             int(causal), int(has_window),
                             min(window, S) if has_window else 0,
                             D ** -0.5, block_q, block_k,
                             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fa_forward")
    flash_kernel.launches += 1
    return o


flash_kernel.launches = 0

__all__ = ["flash_kernel", "TILES", "HEAD_DIMS", "SMEM_LIMIT", "SMEM_PAIR",
           "F32_STAGES", "bf16_stages", "f32_smem_bytes", "f32_blocks_per_sm"]
