"""Gradient compression for the cross-pod reduction (the port's copy of
``repro.optim.compression``).

int8 block quantisation with error feedback: gradients are quantised to
int8 with per-block f32 scales before the slow cross-node all-reduce,
and the quantisation residual is carried to the next step (error
feedback keeps SGD-style convergence).  The intra-node reduction stays
full precision.  On one process the round trip models exactly what the
receiving nodes would see.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so both packages quantise alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.common import tree_map

BLOCK = 256


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values (n_blocks, BLOCK), f32 per-block scales).  Works on
    any shape."""

    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: tuple[int, ...]) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def ef_compress_grads(grads, residual):
    """Error-feedback compression of a gradient tree.

    Returns (compressed-then-decompressed grads, new residual): the
    residual (g + r) - Q(g + r) is added to the next step's gradient."""

    if residual is None:
        residual = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)

    def one(g, r):
        target = g.float() + r
        q, s = compress_int8(target)
        deq = decompress_int8(q, s, tuple(g.shape))
        return deq.to(g.dtype), target - deq

    pairs = tree_map(one, grads, residual)     # tuples are leaves here
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


__all__ = ["compress_int8", "decompress_int8", "ef_compress_grads", "BLOCK"]
