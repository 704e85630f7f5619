"""Wrapper of the hand-written CUDA tiled GEMM (``csrc/matmul_tuned.cu``).

A CUDA tensor launches the kernel (WMMA tensor-core path for bf16, FMA
path for f32) and raises if the launch fails; a CPU tensor takes the
plain version, :func:`~.ref.matmul_ref`.  ``matmul_kernel.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import matmul_ref

# the (bm, bn, bk) tile shapes compiled as template instantiations
TILE_M = (64, 128)
TILE_N = (64, 128)
TILE_K = (32, 64)
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}


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
    M, K = a.shape
    N = b.shape[1]
    if bm not in TILE_M or bn not in TILE_N or bk not in TILE_K:
        raise ValueError(f"tile ({bm}, {bn}, {bk}) is not compiled; "
                         f"bm in {TILE_M}, bn in {TILE_N}, bk in {TILE_K}")
    if M % bm or N % bn or K % bk:
        raise ValueError(f"dims ({M}, {N}, {K}) not divisible by the tile "
                         f"({bm}, {bn}, {bk})")
    a, b = a.contiguous(), b.contiguous()
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("operands must be 16-byte aligned")
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

__all__ = ["matmul_kernel", "TILE_M", "TILE_N", "TILE_K"]
