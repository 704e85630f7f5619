"""AdamW with decoupled weight decay, cosine schedule, global-norm clip
(the port's copy of ``repro.optim.adamw``).

Plain functions on the port's parameter trees (nested dicts of tensors),
not ``torch.optim.AdamW``: the moments are f32 whatever the param dtype
(bf16 params, f32 m/v: 2 + 4 + 4 bytes a parameter), the update is
computed in f32 and cast back to the param's dtype, and the state is a
tree that checkpoints leaf by leaf.  Every function returns new tensors
and writes none it was given."""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..models.common import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Any                   # f32 tree
    v: Any                   # f32 tree


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw_update(params, grads, state: OptState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float | None = 1.0):
    """Returns (new_params, new_state, metrics)."""

    step = state.step + 1
    gnorm = global_norm(grads)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
    else:
        grads = tree_map(lambda g: g.float(), grads)

    lr_t = lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.m, grads)
    new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.v, grads)

    def upd(p, m, v):
        mh, vh = m / bc1, v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p.float() - lr_t * delta).to(p.dtype)

    new_params = tree_map(upd, params, new_m, new_v)
    return new_params, OptState(step, new_m, new_v), {
        "grad_norm": gnorm, "lr": lr_t}


__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]
