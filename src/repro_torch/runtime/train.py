"""Train-step builder (the port's copy of ``repro.runtime.train``):
gradient accumulation over microbatches, AdamW, optional int8
error-feedback compression of the cross-pod gradients.

``train_step(state, batch)`` is pure: it returns a new
:class:`TrainState` and never writes the tensors of the state it was
given (the loop's straggler re-dispatch and its restart from the initial
state rely on that).  Gradients come from ``torch.autograd.grad`` over
the parameter leaves; microbatches run as a Python loop that sums f32
gradients, the reference's ``lax.scan``.  Under a ``torch.profiler``
the step names its ``train.forward``, ``train.backward`` and
``train.optimizer`` ranges (:func:`repro_torch.obs.profile.span`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..models.api import ModelAPI
from ..models.common import tree_leaves, tree_map
from ..obs.profile import span
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


def abstract_train_state(api: ModelAPI, tcfg: TrainConfig) -> TrainState:
    """Meta-tensor train state for the dry run: the parameters in their
    dtypes, f32 moments (and residual), an int32 step."""

    params = api.abstract()
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    opt = OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                   m=tree_map(f32, params), v=tree_map(f32, params))
    residual = tree_map(f32, params) if tcfg.compress_pod_grads else None
    return TrainState(params, opt, residual)


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    """``m`` microbatches of consecutive rows, as the reference's.  A
    DTensor batch whose rows are split over n ranks is split within each
    rank's rows instead (microbatch j holds rows ``[j·b/m, (j+1)·b/m)``
    of every rank's b): DTensor cannot split a sharded dim into m
    consecutive blocks that n does not divide.  The microbatches' sum,
    the step's gradient, holds the same rows."""

    from torch.distributed.tensor import DTensor, Shard

    def split(x):
        B = x.shape[0]
        if B % m:
            raise ValueError(f"batch {B} does not split into {m} "
                             f"microbatches")
        n = 1
        if isinstance(x, DTensor):
            for k, p in enumerate(x.placements):
                if isinstance(p, Shard) and p.dim == 0:
                    n *= x.device_mesh.size(k)
        if n == 1:
            return [x.reshape(m, B // m, *x.shape[1:])[j] for j in range(m)]
        if (B // n) % m:
            raise ValueError(f"{B // n} rows a rank do not split into {m} "
                             f"microbatches")
        x3 = x.reshape(n, m, B // (n * m), *x.shape[1:])
        return [x3[:, j].reshape(B // m, *x.shape[1:]) for j in range(m)]

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[j] for k, v in parts.items()} for j in range(m)]


def value_and_grad(api: ModelAPI, params, batch: dict):
    """(loss, grads) of ``api.loss`` at ``params``: grads in each
    parameter's dtype, zeros for a parameter the loss does not reach."""

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        with span("train.forward", clock=None):
            loss = api.loss(live, batch)
        with span("train.backward", clock=None):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    it = iter(_unnested(g) for g in grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _unnested(g):
    """A gradient as one DTensor.  torch 2.11's autograd on the card
    returns the gradient of a DTensor leaf used more than once (a stacked
    layer leaf, the tied embedding) as a DTensor whose local tensor is
    that gradient's DTensor; the inner one is the gradient."""

    from torch.distributed.tensor import DTensor
    while isinstance(g, DTensor) and isinstance(g._local_tensor, DTensor):
        g = g._local_tensor
    return g


def _replicated(x):
    """A DTensor metric with every rank holding its whole value (a loss
    is a partial mean over the batch's ranks until reduced); any other
    value itself."""

    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim)
    return x


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

        with span("train.optimizer", clock=None):
            params, opt, metrics = adamw_update(
                state.params, grads, state.opt, lr=lr,
                weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
        metrics = {k: _replicated(v) for k, v in
                   dict(metrics, loss=loss).items()}
        return TrainState(params, opt, residual), metrics

    return train_step


__all__ = ["TrainConfig", "TrainState", "init_train_state",
           "abstract_train_state",
           "build_train_step", "value_and_grad"]
