"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

A CUDA tensor launches the kernel (mma.sync tensor-core path for bf16,
FMA path for f32) and raises if the head dim or tile was not compiled or
the launch fails; a CPU tensor takes the plain version,
:func:`~.ref.attention_ref`.  ``flash_kernel.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

# the (block_q, block_k) tiles and head dims compiled as template
# instantiations
BLOCK_Q = (64, 128)
BLOCK_K = (32, 64, 128)
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}


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
    if block_q not in BLOCK_Q or block_k not in BLOCK_K:
        raise ValueError(f"tile ({block_q}, {block_k}) is not compiled; "
                         f"block_q in {BLOCK_Q}, block_k in {BLOCK_K}")
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

__all__ = ["flash_kernel", "BLOCK_Q", "BLOCK_K", "HEAD_DIMS"]
