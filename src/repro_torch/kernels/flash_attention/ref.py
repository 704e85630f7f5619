"""Plain PyTorch version of flash attention (causal / sliding-window),
the port's copy of ``repro.kernels.flash_attention.ref``: f32 scores and
softmax, fully masked rows -> exact zeros, output in q's dtype."""

from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q, k, v: (..., S, D) -> (..., S, D); f32 softmax accumulation.

    ``window`` is a sliding-attention width W: position i attends to
    [i-W+1, i] (combined with causality), as in Mistral/Mixtral SWA."""

    S = q.shape[-2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki >= qi - window + 1
    s = s.masked_fill(~mask, float("-inf"))
    p = _softmax(s)
    return torch.einsum("...qk,...kd->...qd", p, v.float()).to(q.dtype)


def _softmax(s: torch.Tensor) -> torch.Tensor:
    m = torch.amax(s, dim=-1, keepdim=True)
    # fully-masked rows (can happen with tiny windows) -> zeros, not NaN
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    return p / torch.clamp(denom, min=1e-30)


__all__ = ["attention_ref"]
