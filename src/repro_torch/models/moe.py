"""Mixture-of-Experts layer (the port's copy of ``repro.models.moe``):
token-choice top-k routing with a per-row capacity and a scatter-based
dispatch.

Each batch row is its own group: tokens compete for an expert's ``C``
slots only within their sequence, in token order.  Kept (token, choice)
pairs are scattered into an ``E·C + 1``-row buffer whose last row takes
every dropped pair (the trash row), the experts run as batched products,
and the outputs are gathered back, gated by the renormalized top-k
router weights.  ``moe_forward_einsum`` is the one-hot dispatch oracle
for small shapes.

``torch.topk`` does not promise ``lax.top_k``'s lowest-index-first
order among equal logits; the router logits are f32 products of
continuous weights and activations, so exact ties do not occur outside
constructed inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distribute.sharding import current_ctx
from ..distribute.sharding import logical_constraint as lc
from ..distribute.sharding import pinned
from .common import PSpec


def moe_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    E = cfg.moe.num_experts
    specs = {
        "router": PSpec((d, E), ("embed", "experts"), dtype=torch.float32),
        "wg": PSpec((E, d, f), ("experts", "embed", "expert_mlp")),
        "wu": PSpec((E, d, f), ("experts", "embed", "expert_mlp")),
        "wd": PSpec((E, f, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.moe.shared_experts:
        specs["shared_wg"] = PSpec((d, f), ("embed", "mlp"))
        specs["shared_wu"] = PSpec((d, f), ("embed", "mlp"))
        specs["shared_wd"] = PSpec((f, d), ("mlp", "embed"))
    return specs


def capacity(cfg: ArchConfig, tokens: int) -> int:
    m = cfg.moe
    c = int(m.top_k * tokens * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)  # padded to 8, as the reference


def _route(cfg: ArchConfig, p: dict, x2: torch.Tensor):
    """x2: (T, d) -> gates (T, k) f32, idx (T, k) int64."""

    # whole over the experts: DTensor's top-k over a sharded dim is not
    # the global one
    logits = lc(x2.float() @ p["router"].float(), "batch", None)
    top, idx = _topk(logits, cfg.moe.top_k)
    return torch.softmax(top, dim=-1), idx   # renormalized over the top-k


def _topk(logits: torch.Tensor, k: int):
    """``torch.topk`` over the experts of (T, E) router logits; on
    DTensors, on each rank's rows.

    local_map region: logits and both outputs with T over the batch
    rule's mesh dims and E (or k) whole.  DTensor's sharding cache does
    not key ``topk`` on ``k``: a second MoE config of another top-k in
    the same process would get the first one's output shape."""

    ctx = current_ctx()
    if ctx is None or not _is_dtensor(logits):
        return torch.topk(logits, k, dim=-1)
    from torch.distributed.tensor.experimental import local_map
    pl = ctx.placements(("batch", None), tuple(logits.shape))
    return local_map(lambda t: tuple(torch.topk(t, k, dim=-1)),
                     out_placements=(pl, pl), in_placements=(pl,),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(logits)


def _dispatch(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """Routing and per-row capacity ranks: (gates (B, S·k), experts
    (B, S·k), rank within the expert (B, S·k), keep (B, S·k), C)."""

    B, S, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C = capacity(cfg, S)
    gates, idx = _route(cfg, p, x.reshape(B * S, d))
    flat_e = idx.reshape(B, S * k)
    onehot = F.one_hot(flat_e, E)                        # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    my_pos = torch.take_along_dim(pos, flat_e[..., None], dim=2)[..., 0]
    return gates.reshape(B, S * k), flat_e, my_pos, my_pos < C, C


def _experts(p: dict, xd: torch.Tensor) -> torch.Tensor:
    """(B, E, C, d) dispatched tokens through each expert's SwiGLU."""

    h = F.silu(torch.einsum("becd,edf->becf", xd, p["wg"])) * \
        torch.einsum("becd,edf->becf", xd, p["wu"])
    h = lc(h, "batch", "experts", None, "expert_mlp")
    return lc(torch.einsum("becf,efd->becd", h, p["wd"]), "batch",
              "experts", None, "embed")


def _shared(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["shared_wg"]) * (x @ p["shared_wu"])) @ \
        p["shared_wd"]


def moe_forward(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""

    B, S, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    gates, flat_e, my_pos, keep, C = _dispatch(cfg, p, x)
    slot = torch.where(keep, flat_e * C + my_pos, E * C)  # E*C: trash row

    x_rep = torch.repeat_interleave(x, k, dim=1)          # (B, S*k, d)
    # the scatter stays local per batch shard (slot indices are
    # row-local); the reshard to expert sharding below is the EP
    # all-to-all
    xd = _scatter_rows(slot, x_rep, E * C + 1)
    xd = lc(xd, "batch", None, "embed")
    # pinned: the experts' backward may split C, and the merge of (E, C)
    # would hand the slice's backward a strided shard
    xd = pinned(xd[:, :E * C].reshape(B, E, C, d), ("batch", "experts",
                                                     None, "embed"))
    yo = _experts(p, xd)

    flat = yo.reshape(B, E * C, d)
    flat = lc(flat, "batch", None, "embed")   # combine all-to-all back
    picked = torch.take_along_dim(
        flat, torch.clamp(slot, 0, E * C - 1)[..., None], dim=1)
    picked = picked * (keep[..., None] * gates[..., None]).to(x.dtype)
    y = picked.reshape(B, S, k, d).sum(dim=2)
    if cfg.moe.shared_experts:
        y = y + _shared(p, x)
    return lc(y, "batch", "seq", "embed")


def _scatter_rows(slot: torch.Tensor, x_rep: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """(B, rows, d) buffer with each (B, S*k) token of ``x_rep`` added at
    row ``slot`` of its batch row.

    On DTensors, a local_map region: ``slot`` (B, S*k) and ``x_rep``
    (B, S*k, d) come in, and the buffer goes out, with B over the batch
    rule's mesh dims and every other dim whole, so each rank scatters
    its own batch rows."""

    def scatter(slot, x_rep):
        B, T, d = x_rep.shape
        xd = torch.zeros((B, rows, d), dtype=x_rep.dtype,
                         device=x_rep.device)
        return xd.scatter_add_(1, slot[..., None].expand(-1, -1, d), x_rep)

    ctx = current_ctx()
    if ctx is None or not _is_dtensor(x_rep):
        return scatter(slot, x_rep)
    from torch.distributed.tensor.experimental import local_map
    p2 = ctx.placements(("batch", None), tuple(slot.shape))
    p3 = ctx.placements(("batch", None, None), tuple(x_rep.shape))
    return local_map(scatter, out_placements=list(p3),
                     in_placements=(p2, p3), device_mesh=x_rep.device_mesh,
                     redistribute_inputs=True)(slot, x_rep)


def moe_forward_einsum(p: dict, cfg: ArchConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """One-hot dispatch oracle (small shapes only), with the per-row
    capacity of the scatter path."""

    B, S, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    gates, flat_e, my_pos, keep, C = _dispatch(cfg, p, x)
    # dispatch/combine tensors (B, S*k, E, C)
    disp = (F.one_hot(flat_e, E).float()[..., None] *
            F.one_hot(torch.clamp(my_pos, 0, C - 1), C).float()[:, :, None])
    disp = disp * keep[..., None, None]

    x_rep = torch.repeat_interleave(x, k, dim=1)          # (B, S*k, d)
    xd = torch.einsum("btec,btd->becd", disp.to(x.dtype), x_rep)
    yo = _experts(p, xd)
    comb = disp * gates[..., None, None]
    y = torch.einsum("btec,becd->btd", comb.to(x.dtype), yo)
    y = y.reshape(B, S, k, d).sum(dim=2)
    if cfg.moe.shared_experts:
        y = y + _shared(p, x)
    return y


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


__all__ = ["moe_specs", "moe_forward", "moe_forward_einsum", "capacity"]
