"""Pipeline parallelism: the GPipe microbatch schedule over a "pp" mesh
axis (the port's copy of ``repro.distribute.pipeline``).

Each rank of the axis is one stage and holds a contiguous slice of the
stacked stage parameters; microbatch activations flow stage to stage by
a point-to-point shift.  The schedule runs ``M + P − 1`` ticks; stage p
runs microbatch ``t − p`` at tick t (classic GPipe bubbles).  The last
stage's outputs are summed to every rank.

Gradients come out of ``loss.backward()`` as from the reference's
autodiff, every rank computing the same loss from the same output: the
shift is an autograd function whose backward shifts the other way, and
the final sum (``torch.distributed.nn.functional.all_reduce``, whose
backward sums the ranks' gradients) scales its input's gradient by 1/P,
the ranks' P copies of one loss.  Every rank builds the same graph (the
stage's inputs and outputs are selected arithmetically, never by a
branch), so the backward's shifts pair up across ranks in the same
order.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch


def _shift(x: torch.Tensor, group, rank: int, size: int,
           step: int) -> torch.Tensor:
    """Send ``x`` to the stage ``rank + step`` and return what the stage
    ``rank - step`` sent (zeros at the ends), posted together so that
    neither direction waits on the other."""

    import torch.distributed as dist
    ops, buf = [], torch.zeros_like(x)
    dst, src = rank + step, rank - step
    if 0 <= dst < size:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < size:
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return buf


class _Shift(torch.autograd.Function):
    """One stage forward: stage p's activation to stage p + 1; its
    backward carries the gradient from p + 1 back to p."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.args = (group, rank, size)
        return _shift(x, group, rank, size, 1)

    @staticmethod
    def backward(ctx, g):
        group, rank, size = ctx.args
        return _shift(g, group, rank, size, -1), None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _local_stage(stage_params, axis_rank: int, n_stages: int):
    """This stage's slice of the stacked parameters: a DTensor's local
    shard, or rows ``[p·k, (p+1)·k)`` of a whole tensor (k = n / P)."""

    from torch.distributed.tensor import DTensor

    def one(w):
        if isinstance(w, DTensor):
            return w.to_local()
        k = w.shape[0] // n_stages
        return w[axis_rank * k:(axis_rank + 1) * k]

    if isinstance(stage_params, dict):
        return {k: _local_stage(v, axis_rank, n_stages)
                for k, v in stage_params.items()}
    if isinstance(stage_params, (list, tuple)):
        return type(stage_params)(_local_stage(v, axis_rank, n_stages)
                                  for v in stage_params)
    return one(stage_params)


def gpipe(stage_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
          microbatches: int, axis: str = "pp") -> torch.Tensor:
    """Run ``x`` through P pipeline stages.

    stage_fn(params_stage, act) -> act applies ONE stage's layer slice;
    stage_params: tensors (or a tree of them) with leading dim = the
    stages' units stacked, whole on every rank or DTensors sharded over
    ``axis``; x: (B, ...) with B divisible by ``microbatches``, the same
    on every rank.  Returns the (B, ...) output on every rank."""

    import torch.distributed.nn.functional as dist_fn

    dim = mesh.mesh_dim_names.index(axis)
    group = mesh.get_group(dim)
    P = mesh.size(dim)
    p = mesh.get_local_rank(dim)
    M = microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    xm = x.reshape(M, B // M, *x.shape[1:])
    params = _local_stage(stage_params, p, P)

    first, last = float(p == 0), float(p == P - 1)
    prev = torch.zeros_like(xm[0])
    outs = torch.zeros_like(xm)
    for t in range(M + P - 1):
        recv = _Shift.apply(prev, group, p, P)
        mb = t - p
        active = 0 <= mb < M
        mb_c = min(max(mb, 0), M - 1)
        inp = xm[mb_c] * first + recv * (1.0 - first)
        out = stage_fn(params, inp) * float(active)
        # every tick's output joins the sum (weighted 0 where it is not
        # the last stage's microbatch), so every shift is on the graph
        w = torch.zeros(M, dtype=out.dtype, device=out.device)
        if active:
            w[mb] = last
        outs = outs + w.view(M, *([1] * out.dim())) * out[None]
        prev = out
    # only the last stage holds real outputs; the sum replicates them
    with warnings.catch_warnings():
        # deprecated for the functional collectives, which have no
        # backward
        warnings.simplefilter("ignore", FutureWarning)
        total = dist_fn.all_reduce(_ScaleGrad.apply(outs, 1.0 / P),
                                   group=group)
    return total.reshape(B, *x.shape[1:])


__all__ = ["gpipe"]
