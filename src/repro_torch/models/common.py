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
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..kernels.common import resolve_device

DEFAULT_DTYPE = torch.bfloat16


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
    scale.  Each leaf is drawn in f32, scaled, then cast to its dtype."""

    dev = resolve_device(device)

    def make(spec: PSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        fan_in = spec.shape[-1] if len(spec.shape) >= 1 else 1
        scale = spec.scale if spec.scale is not None else fan_in ** -0.5
        x = torch.randn(spec.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return x.mul_(scale).to(spec.dtype)

    return tree_map(make, tree)


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

    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


__all__ = [
    "PSpec", "tree_map", "tree_leaves", "stack_specs",
    "init_params", "rms_norm", "rope", "swiglu", "softmax_cross_entropy",
    "DEFAULT_DTYPE",
]
