"""Shared model substrate (the port's copy of ``repro.models.common``):
parameter specs, norms, rotary embeddings, MLPs.

Parameters are declared as :class:`PSpec` trees (nested dicts whose
leaves are specs: shape, logical axes, init).  :func:`init_params`
materializes a tree into tensors on a device from a
``torch.Generator``; the trees keep the JAX package's nested-dict
layout and stacked leading ``layers`` dim, so
:func:`repro_torch.interop.params_from_jax` can cross weights between
the two packages leaf for leaf.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..kernels.common import resolve_device

DEFAULT_DTYPE = torch.bfloat16
# a "normal" leaf of more elements than LARGE_LEAF is drawn LEAF_SLICE
# elements at a time into its dtype, never as one f32 tensor of its size
# (llama4-maverick's (1, 128, 5120, 8192) expert leaves: 21.5 GB in f32);
# every leaf of the configs the card runs whole or cut is smaller, and is
# drawn as one tensor as before
LARGE_LEAF = 2 ** 31
LEAF_SLICE = 2 ** 28


@dataclass(frozen=True)
class PSpec:
    """Declarative parameter: shape, logical axes (one name per dim, or
    None for unsharded), init kind, dtype."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    dtype: Any = DEFAULT_DTYPE
    scale: float | None = None    # stddev override for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (specs or tensors), with
    any further trees of the same structure passed alongside."""

    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in key-insertion order (the order :func:`init_params`
    draws them)."""

    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stack_specs(tree, n: int, axis_name: str | None = "layers"):
    """Add a leading stacked-layers dim of size n to every spec."""

    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n, *s.shape), axes=(axis_name, *s.axes)), tree)


def init_params(tree, generator: torch.Generator, device=None):
    """Materialize a PSpec tree into tensors on ``device`` (``cuda:0``
    by default), drawing every "normal" leaf from ``generator`` (which
    must live on that device) in tree order.

    The scale rule is the reference's: stddev ``spec.scale`` or
    ``shape[-1] ** -0.5`` — the LAST dim, not the true fan-in (``wq``
    (d, H, hd) gets ``hd ** -0.5``, ``unembed`` (d, V) gets
    ``V ** -0.5``), so activations and logits keep the reference's
    scale.  Each leaf is drawn in f32, scaled, then cast to its dtype; a
    leaf of more than ``LARGE_LEAF`` elements is drawn so in rows of its
    flattened leading dims, at most ``LEAF_SLICE`` elements at a time
    (the same distribution and scale, other values than one draw)."""

    dev = resolve_device(device)

    def draw(shape, scale, dtype):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def make(spec: PSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        fan_in = spec.shape[-1] if len(spec.shape) >= 1 else 1
        scale = spec.scale if spec.scale is not None else fan_in ** -0.5
        if math.prod(spec.shape) <= LARGE_LEAF:
            return draw(spec.shape, scale, spec.dtype)
        out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
        rows = out.view(-1, fan_in)
        step = max(1, LEAF_SLICE // fan_in)
        for i in range(0, rows.shape[0], step):
            part = rows[i:i + step]
            part.copy_(draw(tuple(part.shape), scale, spec.dtype))
        return out

    return tree_map(make, tree)


def abstract_params(tree):
    """Meta tensors of the specs' shapes and dtypes: the dry run's
    stand-ins, which allocate nothing."""

    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def axes_tree(tree):
    """The logical-axes tree (leaf = tuple of axis names)."""

    return tree_map(lambda s: s.axes, tree)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding; x: (..., S, D), positions: (..., S)."""

    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    # broadcast over head dims: x is (B, H, S, D), ang is (B, S, half)
    while cos.dim() < x.dim():
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if d > 2 * half:  # odd head dims: pass through the tail
        rotated = torch.cat([rotated, x[..., 2 * half:].to(rotated.dtype)],
                            dim=-1)
    return rotated.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Token-mean CE; logits (..., V) any float dtype, computed in f32."""

    lse, gold = ce_terms(logits.float(), labels)
    return torch.mean(lse - gold)


def ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp, gold logit) over the last dim of f32 ``logits``.

    On a DTensor the vocab dim may be sharded: the logsumexp is taken as
    max + log(sum(exp(x - max))), whose two reductions DTensor does as
    small all-reduces, and the gold logit in a local_map region
    (:func:`_gold_on_shards`); DTensor's own gather and logsumexp gather
    the whole vocab onto every rank, forward and backward."""

    from ..distribute.sharding import current_ctx
    if current_ctx() is None or not _is_dtensor(logits):
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return lse, gold
    from ..distribute.sharding import logical_constraint as lc
    lead = ("batch",) + ("seq",) * (logits.dim() - 2)
    m = lc(torch.amax(logits, dim=-1, keepdim=True).detach(), *lead, None)
    z = lc(torch.sum(torch.exp(logits - m), dim=-1, keepdim=True), *lead,
           None)
    lse = (m + torch.log(z))[..., 0]
    return lse, lc(_gold_on_shards(logits, labels), *lead)


def _gold_on_shards(logits, labels):
    """``logits[..., labels]`` of a DTensor whose last (vocab) dim may be
    sharded.

    local_map region: logits as they are placed, labels placed like its
    leading dims; out a partial sum over the mesh dims that shard the
    vocab (each rank picks the labels in its vocab range, zero
    elsewhere), sharded like the logits elsewhere.  The logits' gradient
    is each rank's own one-hot rows."""

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distribute.sharding import shard_offset
    lp = tuple(logits.placements)
    last = logits.dim() - 1
    vocab_dims = [m for m, p in enumerate(lp)
                  if isinstance(p, Shard) and p.dim == last]
    bp = tuple(Replicate() if m in vocab_dims else p
               for m, p in enumerate(lp))
    out_p = [Partial() if m in vocab_dims else p for m, p in enumerate(bp)]
    lo = shard_offset(logits, last)

    def pick(x, lab):
        idx = lab.long() - lo
        hit = (idx >= 0) & (idx < x.shape[-1])
        g = torch.gather(x, -1, torch.where(hit, idx, 0)[..., None])[..., 0]
        return g * hit.to(g.dtype)

    return local_map(pick, out_placements=out_p, in_placements=(lp, bp),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(logits, labels)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


__all__ = [
    "PSpec", "tree_map", "tree_leaves", "stack_specs",
    "init_params", "abstract_params", "axes_tree", "rms_norm", "rope",
    "swiglu", "softmax_cross_entropy", "ce_terms",
    "DEFAULT_DTYPE",
]
