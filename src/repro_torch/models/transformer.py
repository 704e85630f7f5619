"""Decoder stack of the dense family (the port's copy of
``repro.models.transformer``): pre-norm attention + MLP layers over
stacked per-layer parameters, logits, forward and loss.

The reference scans its stacked blocks with ``lax.scan``; here a Python
loop indexes the stacked tensors (``blocks[...][i]`` is a view, no
copy).  Forward only: the JAX flash kernel has no backward, and training
is a later slice.  Families other than ``dense`` raise
``NotImplementedError`` (ROADMAP queue 1, item 19).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import attention as attn
from .common import (PSpec, rms_norm, softmax_cross_entropy, stack_specs,
                     tree_map)

_NOT_PORTED = ("the {} family is not ported yet (ROADMAP queue 1, item 19: "
               "SSM, MoE, hybrid, cross-attention and encoder-decoder "
               "stacks)")


def require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(_NOT_PORTED.format(repr(cfg.family)))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "gelu":
        return {"w1": PSpec((d, f), ("embed", "mlp")),
                "b1": PSpec((f,), ("mlp",), init="zeros"),
                "w2": PSpec((f, d), ("mlp", "embed")),
                "b2": PSpec((d,), ("embed",), init="zeros")}
    return {"wg": PSpec((d, f), ("embed", "mlp")),
            "wu": PSpec((d, f), ("embed", "mlp")),
            "wd": PSpec((f, d), ("mlp", "embed"))}


def mlp_forward(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
        return h @ p["w2"] + p["b2"]
    h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _norm_spec(cfg):
    return PSpec((cfg.d_model,), ("embed",), init="ones")


def layer_specs(cfg: ArchConfig, kind: str) -> dict:
    if kind != "dense":
        raise NotImplementedError(_NOT_PORTED.format(repr(kind)))
    return {"ln1": _norm_spec(cfg), "attn": attn.attn_specs(cfg),
            "ln2": _norm_spec(cfg), "ffn": mlp_specs(cfg)}


def layer_forward(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor,
                  positions: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    if kind != "dense":
        raise NotImplementedError(_NOT_PORTED.format(repr(kind)))
    h = rms_norm(x, p["ln1"])
    x = x + attn.attention(p["attn"], cfg, h, positions, causal=causal,
                           window=cfg.window, use_flash=cfg.use_flash)
    return x + mlp_forward(p["ffn"], cfg, rms_norm(x, p["ln2"]))


# ---------------------------------------------------------------------------
# Stacks (a loop over the stacked blocks)
# ---------------------------------------------------------------------------


def _block_plan(cfg: ArchConfig) -> tuple[list[str], int]:
    """Returns (kinds within one block, number of blocks)."""

    require_dense(cfg)
    return ["dense"], cfg.n_layers


def stack_param_specs(cfg: ArchConfig) -> dict:
    kinds, n_blocks = _block_plan(cfg)
    block = {f"{i}_{kind}": layer_specs(cfg, kind)
             for i, kind in enumerate(kinds)}
    specs: dict[str, Any] = {
        "embed": PSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=0.02),
        "ln_f": _norm_spec(cfg),
        "blocks": stack_specs(block, n_blocks),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = PSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return specs


def block_params(blocks: dict, i: int) -> dict:
    """Block ``i`` of a stacked tree: views into the stacked tensors."""

    return tree_map(lambda a: a[i], blocks)


def _run_blocks(cfg: ArchConfig, blocks: dict, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True):
    kinds, n_blocks = _block_plan(cfg)
    for i in range(n_blocks):
        bp = block_params(blocks, i)
        for j, kind in enumerate(kinds):
            x = layer_forward(bp[f"{j}_{kind}"], cfg, kind, x, positions,
                              causal=causal)
    return x


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    rows = tokens.reshape(-1).to(torch.int64)
    return params["embed"].index_select(0, rows).reshape(B, S, -1)


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"])
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = x @ params["unembed"]
    return logits.to(getattr(torch, cfg.logits_dtype))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device).expand(B, S)


def forward_lm(params: dict, cfg: ArchConfig,
               tokens: torch.Tensor) -> torch.Tensor:
    """Decoder-only forward -> logits (B, S, V)."""

    x = _embed(params, tokens)
    x = _run_blocks(cfg, params["blocks"], x, _positions(tokens))
    return _logits(params, cfg, x)


def hidden_lm(params: dict, cfg: ArchConfig,
              tokens: torch.Tensor) -> torch.Tensor:
    """Decoder trunk up to (and including) the final norm: no logits."""

    x = _embed(params, tokens)
    x = _run_blocks(cfg, params["blocks"], x, _positions(tokens))
    return rms_norm(x, params["ln_f"])


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _chunked_ce(params: dict, cfg: ArchConfig, h: torch.Tensor,
                labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """CE without materializing (B, S, V): a loop over sequence chunks
    (numerically the fused CE up to summation order)."""

    B, S, d = h.shape
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        hx, lx = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", hx, w)
        else:
            logits = hx @ w
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lx[..., None].long())[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (B * S)


def lm_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    if cfg.loss_seq_chunk:
        h = hidden_lm(params, cfg, batch["tokens"])
        return _chunked_ce(params, cfg, h[:, :-1], batch["labels"][:, 1:],
                           cfg.loss_seq_chunk)
    logits = forward_lm(params, cfg, batch["tokens"])
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


__all__ = [
    "mlp_specs", "mlp_forward", "layer_specs", "layer_forward",
    "stack_param_specs", "block_params", "forward_lm", "hidden_lm",
    "lm_loss", "require_dense",
]
