"""Plain PyTorch version of the paged decode kernel
(``csrc/paged_decode.cu``).

:func:`paged_decode_ref` gathers every slot's whole page table out of
the pool into a contiguous (B, Hkv, M·ps, hd) copy, masks it, and runs
the model's grouped f32 attention core (``models/attn_core.py``): the
port's paged decode as it was before the kernel, so the CPU keeps its
path and its numbers.  A row with no valid key (an idle slot's, whose
page table is all -1) writes zeros, as the kernel does.
"""

from __future__ import annotations

import torch

from ...models.attn_core import gather_pool, grouped_sdpa, pool_validity


def paged_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     page_table: torch.Tensor, cur_len: torch.Tensor, *,
                     window: int | None, scale: float) -> torch.Tensor:
    """q: (B, H, 1, hd) at position ``cur_len``; k, v: (P, Hkv, ps, hd)
    pools already holding this step's token; page_table: (B, M), -1 =
    unallocated; cur_len: (B,).  Key j of row b counts when j <=
    cur_len[b], its page is live, and, with a window, j >= cur_len[b] -
    window + 1.  Returns (B, H, 1, hd) in q's dtype."""

    ps, M = k.shape[2], page_table.shape[1]
    kp = torch.arange(M * ps, device=q.device)[None, :]     # (1, M*ps)
    qp = cur_len[:, None]                                   # (B, 1)
    mask = (kp <= qp) & pool_validity(page_table, ps)
    if window is not None:
        mask &= kp >= qp - window + 1
    mask = mask[:, None, None, None, :]                 # (B, 1, 1, 1, M*ps)
    o = grouped_sdpa(q, gather_pool(k, page_table), gather_pool(v, page_table),
                     mask, scale)
    o = o.masked_fill(~mask.any(dim=-1), 0.0)   # (B, 1, 1, 1)
    return o.to(q.dtype)


__all__ = ["paged_decode_ref"]
