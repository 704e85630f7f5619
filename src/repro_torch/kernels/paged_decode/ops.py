"""Public entry point of the paged decode attention: the split rule and
the call.

``paged_decode(q, k, v, page_table, cur_len, window=..., scale=...)``
attends each serving slot's one query to the keys of its own pages, read
in place (:mod:`.kernel` on a CUDA tensor, :mod:`.ref` on a CPU one).
The only parameter the kernel has beyond the shapes is the number of
splits of a row's live pages, and :func:`num_splits` takes it from what
the host knows without reading the device back: the B · Hkv blocks of
one split against the card's SMs, and the page table's width M.  The
kernel is bound by bytes, so it needs about ``FILL`` blocks in flight to
stream at the memory's rate: a batch with that many (slot, kv head)
pairs runs one split and one launch; a smaller one splits its pages, up
to one page a split, and a second launch merges the splits.
"""

from __future__ import annotations

import torch

from ..common import SMS
from .kernel import (GROUPS, HEAD_DIMS, MAX_PAGES, check_kernel_args,
                     group_rows, paged_decode_kernel, shapes)
from .ref import paged_decode_ref

# blocks that keep the card streaming: two of 128 threads an SM
FILL = 2 * SMS


def num_splits(B: int, Hkv: int, M: int) -> int:
    """Splits of each row's live pages: 1 when B · Hkv blocks fill the
    card, else enough for ``FILL`` blocks, at most one a page."""

    blocks = B * Hkv
    if blocks >= FILL:
        return 1
    return max(1, min(M, -(-FILL // blocks)))


def paged_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 page_table: torch.Tensor, cur_len: torch.Tensor, *,
                 window: int | None = None,
                 scale: float | None = None) -> torch.Tensor:
    """One-token attention of each slot against its pages: q (B, H, 1,
    hd) after RoPE; k, v (P, Hkv, ps, hd) pools holding this step's
    token; page_table (B, M), -1 = unallocated; cur_len (B,), the query's
    position.  Returns (B, H, 1, hd) in q's dtype; a row with no valid
    key is zeros.  ``scale`` defaults to hd ** -0.5."""

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    splits = num_splits(q.shape[0], k.shape[1], page_table.shape[-1])
    return paged_decode_kernel(q, k, v, page_table, cur_len, window=window,
                               scale=scale, splits=splits)


__all__ = ["paged_decode", "num_splits", "paged_decode_kernel",
           "paged_decode_ref", "shapes", "check_kernel_args", "group_rows",
           "FILL", "HEAD_DIMS", "GROUPS", "MAX_PAGES"]
