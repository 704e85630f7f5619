"""Wrapper of the hand-written CUDA GEMM (``csrc/matmul_tuned.cu``).

A CUDA tensor launches the kernel (a TMA + ``wgmma`` pipeline for bf16,
the FMA path for f32) and raises if the launch fails; a CPU tensor takes
the plain version, :func:`~.ref.matmul_ref`.  Both check the operands
the same way first, so what the kernel cannot take raises on either
device.  ``matmul_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import matmul_ref

# the (bm, bn, bk) tile shapes compiled as template instantiations, per
# element size: bf16 has bm = 128 (two consumer warpgroups of 64 rows) and
# bk = 64 (one 128-byte swizzle row); f32 is the FMA kernel's grid
TILES = {
    2: {"bm": (128,), "bn": (128, 256), "bk": (64,)},
    4: {"bm": (64, 128), "bn": (64, 128), "bk": (32, 64)},
}
# depth of the bf16 kernel's ring of shared-memory stages for each bn: the
# deepest that fits 227 KB (csrc/matmul_tuned.cu, wg::Tile)
BF16_STAGES = {128: 7, 256: 4}
# the most shared memory each of two blocks on one SM may have (the SM's
# 228 KB less 1 KB reserved a block, halved): the f32 kernel's ring is as
# deep as this allows, so two blocks share an SM where they can
F32_SMEM_PAIR = 115712


def f32_stage_bytes(bm: int, bn: int, bk: int) -> int:
    """One stage of the f32 kernel's ring: A (bm x bk, rows padded by 4
    floats) and B (bk x bn), f32 (csrc/matmul_tuned.cu, ffma::Tile)."""

    return (bm * (bk + 4) + bk * bn) * 4


def f32_stages(bm: int, bn: int, bk: int) -> int:
    """Depth of the f32 kernel's cp.async ring: the deepest that lets two
    blocks share an SM, and never below 2."""

    return max(2, F32_SMEM_PAIR // f32_stage_bytes(bm, bn, bk))


_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}


def _check_layout(name: str, t: torch.Tensor) -> None:
    """What TMA (and the f32 kernel's 16-byte cp.async copies) needs of
    an operand: contiguous rows, 16 bytes apart or a multiple of that, from
    a 16-byte aligned base."""

    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous (strides {t.stride()})")
    if t.stride(0) * t.element_size() % 16:
        raise ValueError(f"{name}'s row stride of {t.stride(0)} elements "
                         f"is not a multiple of 16 bytes")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def matmul_kernel(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int,
                  bk: int) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) of ``a``'s dtype, in (bm, bn) output
    tiles stepping ``bk`` along K."""

    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"need two f32 or two bf16 operands, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    _check_layout("a", a)
    _check_layout("b", b)
    M, K = a.shape
    N = b.shape[1]
    tiles = TILES[a.element_size()]
    if bm not in tiles["bm"] or bn not in tiles["bn"] or bk not in tiles["bk"]:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) is not compiled for "
                         f"{a.dtype}; bm in {tiles['bm']}, bn in "
                         f"{tiles['bn']}, bk in {tiles['bk']}")
    if M % bm or N % bn or K % bk:
        raise ValueError(f"dims ({M}, {N}, {K}) not divisible by the tile "
                         f"({bm}, {bn}, {bk})")
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    lib = _build.library()
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.mm_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                            _DTYPE_CODE[a.dtype], bm, bn, bk,
                            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mm_matmul")
    matmul_kernel.launches += 1
    return c


matmul_kernel.launches = 0

__all__ = ["matmul_kernel", "TILES", "BF16_STAGES", "F32_SMEM_PAIR",
           "f32_stage_bytes", "f32_stages"]
