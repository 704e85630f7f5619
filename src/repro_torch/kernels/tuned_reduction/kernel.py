"""Wrapper of the hand-written CUDA reduction (``csrc/tuned_reduction.cu``).

A CUDA tensor launches the kernel (two passes: block partials, then one
block folds them) and raises if the launch fails; a CPU tensor takes the
plain version, :func:`~.ref.reduce_chunked`, which folds in the same
order.  ``reduce_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import DTYPES, OPS, reduce_chunked

_DTYPE_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_OP_CODE = {"min": 0, "max": 1, "sum": 2}


def reduce_kernel(x: torch.Tensor, op: str, WG: int, TS: int) -> torch.Tensor:
    """Reduce the 1-D tensor ``x`` with work-groups of ``WG`` threads that
    fold ``TS`` elements each; returns a 0-d tensor of ``x``'s dtype."""

    if x.dim() != 1 or x.numel() < 1:
        raise ValueError(f"need a non-empty 1-D tensor, got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    if not (1 <= WG <= 1024 and TS >= 1):
        raise ValueError(f"bad launch parameters WG={WG} TS={TS}")
    x = x.contiguous()
    if x.device.type == "cpu":
        return reduce_chunked(x, op, WG, TS)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _build.library()
    n = x.numel()
    blocks = -(-n // (WG * TS))
    partials = torch.empty(blocks, dtype=torch.int32, device=x.device)
    out = torch.empty((), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tr_reduce(x.data_ptr(), n, _DTYPE_CODE[x.dtype],
                            _OP_CODE[op], WG, TS, partials.data_ptr(),
                            out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tr_reduce")
    reduce_kernel.launches += 1
    return out


reduce_kernel.launches = 0

__all__ = ["reduce_kernel"]
