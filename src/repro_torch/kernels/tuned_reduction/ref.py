"""Plain PyTorch version of the tuned reduction kernel.

:func:`reduce_chunked` folds in exactly the order of
``csrc/tuned_reduction.cu``: thread (b, t) folds elements
``b*WG*TS + j*WG + t`` for j = 0..TS-1, each block tree-reduces its WG
partials (stride halving from the largest power of two below WG), and the
block partials are folded by FOLD_THREADS "threads", each in order,
followed by the same tree.  Padding with the monoid identity stands in
for the kernel's masked tail (``op(a, identity) == a`` exactly).  So
min, max and the int32 sum match the kernel bit for bit for every
(WG, TS), and so does the f32 sum, which depends on (WG, TS) only
through its rounding.

Semantics: identities are ±inf for floats and the int32 bounds for
ints; min/max propagate NaN; the int32 sum wraps mod 2^32; f32 and bf16
accumulate in f32 and round once at the end.
"""

from __future__ import annotations

import torch

FOLD_THREADS = 1024
OPS = ("min", "max", "sum")
DTYPES = (torch.int32, torch.float32, torch.bfloat16)


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


def _tree(acc: torch.Tensor, op: str) -> torch.Tensor:
    """Fold the last axis like the kernel's shared-memory tree."""

    width = acc.shape[-1]
    p2 = 1 << max(0, (width - 1).bit_length())
    if p2 > width:
        pad = acc.new_full((*acc.shape[:-1], p2 - width),
                           identity(op, acc.dtype))
        acc = torch.cat([acc, pad], dim=-1)
    comb = combine(op)
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = comb(acc[..., :h], acc[..., h:])
    return acc[..., 0]


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
    if G * chunk != n:
        x = torch.cat([x, x.new_full((G * chunk - n,), identity(op, x.dtype))])
    view = x.view(G, TS, WG)
    comb = combine(op)
    acc = torch.full((G, WG), identity(op, adt), dtype=adt, device=x.device)
    for j in range(TS):
        acc = comb(acc, view[:, j, :].to(adt))
    partials = _tree(acc, op)                                   # (G,)

    rows = -(-G // FOLD_THREADS)
    if rows * FOLD_THREADS != G:
        partials = torch.cat([partials, partials.new_full(
            (rows * FOLD_THREADS - G,), identity(op, adt))])
    folded = partials.view(rows, FOLD_THREADS)
    acc = torch.full((FOLD_THREADS,), identity(op, adt), dtype=adt,
                     device=x.device)
    for r in range(rows):
        acc = comb(acc, folded[r])
    return _finish(_tree(acc, op), op, x.dtype)


__all__ = ["reduce_chunked", "identity", "acc_dtype", "combine",
           "FOLD_THREADS", "OPS", "DTYPES"]
