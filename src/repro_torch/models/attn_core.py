"""The attention core the model's cached paths share, and the page pool's
views: the grouped f32 attention over a kv-head cache, and a paged
pool's per-slot gather and validity.

It imports nothing of the port, so the paged decode kernel's plain
version (``kernels/paged_decode/ref.py``) runs this same code without
importing :mod:`.attention`, which imports the kernel.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def grouped_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Grouped GQA attention: contract q head-groups against the
    kv-head cache directly (no head repeat).  q: (B, H, T, hd); k/v:
    (B, Hkv, S, hd); mask broadcastable to (B, Hkv, g, T, S); returns
    (B, H, T, hd) in f32."""

    B, H, T, hd = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, T, hd).float() * scale
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float())
    s = s.masked_fill(~mask, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    og = torch.einsum("bkgts,bksd->bkgtd", pr, v.float())
    return og.reshape(B, H, T, hd)


def gather_pool(pool_kv: torch.Tensor,
                page_table: torch.Tensor) -> torch.Tensor:
    """(P, Hkv, ps, hd) pool -> (B, Hkv, M*ps, hd) per-slot linear view
    through the page table, a copy (unallocated entries gather page 0:
    callers mask them by ``page_table >= 0``)."""

    g = pool_kv[torch.clamp(page_table, min=0)]     # (B, M, Hkv, ps, hd)
    B, M, Hkv, ps, hd = g.shape
    return g.transpose(1, 2).reshape(B, Hkv, M * ps, hd)


def pool_validity(page_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """(B, M*ps) bool: which linear positions are backed by a live page."""

    return torch.repeat_interleave(page_table >= 0, page_size, dim=1)


__all__ = ["grouped_sdpa", "gather_pool", "pool_validity", "NEG_INF"]
