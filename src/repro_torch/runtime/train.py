"""Train-step builder (the port's copy of ``repro.runtime.train``):
gradient accumulation over microbatches, AdamW, optional int8
error-feedback compression of the cross-pod gradients.

``train_step(state, batch)`` is pure: it returns a new
:class:`TrainState` and never writes the tensors of the state it was
given (the loop's straggler re-dispatch and its restart from the initial
state rely on that).  Gradients come from ``torch.autograd.grad`` over
the parameter leaves; microbatches run as a Python loop that sums f32
gradients, the reference's ``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..models.api import ModelAPI
from ..models.common import tree_leaves, tree_map
from ..optim import (OptState, adamw_init, adamw_update, cosine_schedule,
                     ef_compress_grads)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1          # gradient accumulation (tuning parameter)
    compress_pod_grads: bool = False


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    ef_residual: Any               # None unless compress_pod_grads


def init_train_state(api: ModelAPI, generator: torch.Generator | int,
                     tcfg: TrainConfig, device=None) -> TrainState:
    """Parameters from ``generator`` (a ``torch.Generator`` on ``device``,
    or a seed) on ``device`` (``cuda:0`` by default), zero moments."""

    params = api.init(generator, device)
    residual = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
                if tcfg.compress_pod_grads else None)
    return TrainState(params, adamw_init(params), residual)


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    def split(x):
        B = x.shape[0]
        if B % m:
            raise ValueError(f"batch {B} does not split into {m} "
                             f"microbatches")
        return x.reshape(m, B // m, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[j] for k, v in parts.items()} for j in range(m)]


def value_and_grad(api: ModelAPI, params, batch: dict):
    """(loss, grads) of ``api.loss`` at ``params``: grads in each
    parameter's dtype, zeros for a parameter the loss does not reach."""

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = api.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def build_train_step(api: ModelAPI, tcfg: TrainConfig
                     ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    lr = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)

    def train_step(state: TrainState, batch: dict):
        if tcfg.microbatches > 1:
            loss_sum, g_sum = None, None
            for one in _split_microbatches(batch, tcfg.microbatches):
                loss, g = value_and_grad(api, state.params, one)
                if g_sum is None:
                    loss_sum = loss.float()
                    g_sum = tree_map(lambda b: b.float(), g)
                else:
                    loss_sum = loss_sum + loss
                    tree_map(lambda a, b: a.add_(b.float()), g_sum, g)
            loss = loss_sum / tcfg.microbatches
            grads = tree_map(lambda g: g / tcfg.microbatches, g_sum)
        else:
            loss, grads = value_and_grad(api, state.params, batch)

        residual = state.ef_residual
        if tcfg.compress_pod_grads:
            grads, residual = ef_compress_grads(grads, residual)

        params, opt, metrics = adamw_update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
        metrics = dict(metrics, loss=loss)
        return TrainState(params, opt, residual), metrics

    return train_step


__all__ = ["TrainConfig", "TrainState", "init_train_state",
           "build_train_step", "value_and_grad"]
