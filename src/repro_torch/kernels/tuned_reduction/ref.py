"""Plain PyTorch version of the tuned reduction kernel.

:func:`reduce_chunked` folds in exactly the order of
``csrc/tuned_reduction.cu``.  Block b owns the chunk of WG·TS elements
from b·WG·TS, read in groups of W = :func:`group_width` elements (16
bytes, or fewer when TS is not a multiple of that): thread t folds the
group at chunk offset (j·WG + t)·W for j = 0..TS/W-1, each group's
elements in order.  A block of B = 32·⌈WG/32⌉ threads (threads past WG
hold the identity) then folds each warp's 32 values with a halving
tree, and the warps' partials, padded to 32, with the same tree.  The
block partials are folded by the B threads of one block, thread t
taking partials t, t + B, ... in order, followed by the same block
fold.  Padding with the monoid identity stands in for the kernel's
masked tail (``op(a, identity) == a`` exactly).  So min, max and the
int32 sum match the kernel bit for bit for every (WG, TS), and so do
the f32 and bf16 sums, which depend on (WG, TS) only through their
rounding.

Semantics: identities are ±inf for floats and the int32 bounds for
ints; min/max propagate NaN; the int32 sum wraps mod 2^32; f32 and bf16
accumulate in f32 and round once at the end.
"""

from __future__ import annotations

import torch

OPS = ("min", "max", "sum")
DTYPES = (torch.int32, torch.float32, torch.bfloat16)
VECTOR_BYTES = 16
WARP = 32


def group_width(TS: int, element_size: int) -> int:
    """Elements a thread folds from one place: the 16-byte vector's
    count, cut to the largest power of two that divides ``TS``."""

    return min(TS & -TS, VECTOR_BYTES // element_size)


def block_threads(WG: int) -> int:
    """Threads of a block: WG rounded up to whole warps."""

    return -(-WG // WARP) * WARP


def identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def acc_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    """The kernel's accumulator type; an int32 sum is carried in int64
    here and wrapped mod 2^32 at the end (the same result as the
    kernel's uint32 accumulator)."""

    if dtype.is_floating_point:
        return torch.float32
    return torch.int64 if op == "sum" else torch.int32


def combine(op: str):
    return {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}[op]


def _pad(acc: torch.Tensor, width: int, op: str) -> torch.Tensor:
    """``acc`` padded with the identity to ``width`` along its last axis."""

    extra = width - acc.shape[-1]
    if extra == 0:
        return acc
    pad = acc.new_full((*acc.shape[:-1], extra), identity(op, acc.dtype))
    return torch.cat([acc, pad], dim=-1)


def _tree(acc: torch.Tensor, op: str) -> torch.Tensor:
    """Fold the last axis (a power of two wide) as a warp's butterfly
    leaves it in lane 0: entry i takes entry i + h for h = width/2 .. 1."""

    comb = combine(op)
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = comb(acc[..., :h], acc[..., h:])
    return acc[..., 0]


def _block_fold(acc: torch.Tensor, op: str) -> torch.Tensor:
    """Fold the last axis (B = a multiple of 32 values, one a thread):
    each warp's tree, then the tree over the warps' partials padded to 32."""

    warps = _tree(acc.view(*acc.shape[:-1], -1, WARP), op)
    return _tree(_pad(warps, WARP, op), op)


def _finish(acc: torch.Tensor, op: str, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int32 and op == "sum":
        acc = torch.remainder(acc + 2**31, 2**32) - 2**31
    return acc.to(dtype)


def reduce_chunked(x: torch.Tensor, op: str, WG: int, TS: int) -> torch.Tensor:
    """Reduce the 1-D ``x`` in the kernel's (WG, TS) fold order; returns a
    0-d tensor of ``x``'s dtype."""

    n = x.numel()
    adt = acc_dtype(op, x.dtype)
    chunk = WG * TS
    G = -(-n // chunk)
    W = group_width(TS, x.element_size())
    B = block_threads(WG)
    x = _pad(x, G * chunk, op)
    view = x.view(G, TS // W, WG, W)
    comb = combine(op)
    acc = torch.full((G, WG), identity(op, adt), dtype=adt, device=x.device)
    for j in range(TS // W):
        for k in range(W):
            acc = comb(acc, view[:, j, :, k].to(adt))
    partials = _block_fold(_pad(acc, B, op), op)               # (G,)

    rows = -(-G // B)
    folded = _pad(partials, rows * B, op).view(rows, B)
    acc = torch.full((B,), identity(op, adt), dtype=adt, device=x.device)
    for r in range(rows):
        acc = comb(acc, folded[r])
    return _finish(_block_fold(acc, op), op, x.dtype)


__all__ = ["reduce_chunked", "group_width", "block_threads", "identity",
           "acc_dtype", "combine", "OPS", "DTYPES"]
