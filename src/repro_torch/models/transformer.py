"""The layer stacks of every family (the port's copy of
``repro.models.transformer``): layers over stacked per-layer parameters,
logits, forward and loss.

Layer kinds, picked per family:

* dense   — pre-norm attention + MLP
* moe     — attention + MoE FFN (mixtral every layer; llama4 every 2nd)
* ssm     — Mamba2 SSD block + (optional) MLP; d_ff == 0 -> pure SSD
* hybrid  — parallel attention (SWA) and SSD heads on the same input,
            mixed by a learned per-dim ``(2, d)`` weight (hymba)
* cross   — gated cross attention to image embeddings every N layers
            (llama-3.2-vision), the gate f32 under ``tanh``
* enc-dec — whisper: bidirectional encoder over frame embeddings, causal
            decoder with a cross-attention layer after each block
            (sinusoidal positions)

The reference scans its stacked blocks with ``lax.scan``; here a Python
loop indexes the stacked tensors (``blocks[...][i]`` is a view, no
copy).  ``cfg.remat`` acts per block, as the reference's remat covers
its scan body: ``"full"`` recomputes the block in the backward,
``"dots"`` saves its matrix products' outputs and recomputes the rest;
only where a gradient is being taken (serving never is).  The flash
kernel has no backward, so a loss through ``use_flash=True`` raises on
``backward``.  Frame and image embeddings are cast to the residual
stream's dtype (the reference promotes mixed dtypes instead; with the
params' dtype given, both compute the same).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..distribute.sharding import current_ctx, gather_fsdp, shard_offset
from ..distribute.sharding import logical_constraint as lc
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import (PSpec, ce_terms, rms_norm, softmax_cross_entropy,
                     stack_specs, tree_leaves, tree_map)


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
        h = lc(h, "batch", "seq", "mlp")
        return lc(h @ p["w2"] + p["b2"], "batch", "seq", "embed")
    h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    h = lc(h, "batch", "seq", "mlp")
    return lc(h @ p["wd"], "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _norm_spec(cfg):
    return PSpec((cfg.d_model,), ("embed",), init="ones")


def layer_specs(cfg: ArchConfig, kind: str) -> dict:
    d = cfg.d_model
    s: dict[str, Any] = {"ln1": _norm_spec(cfg)}
    if kind in ("dense", "moe", "encoder"):
        s["attn"] = attn.attn_specs(cfg)
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = moe_mod.moe_specs(cfg) if kind == "moe" else mlp_specs(cfg)
    elif kind == "ssm":
        s["ssm"] = ssm_mod.ssm_specs(cfg)
        if cfg.d_ff:
            s["ln2"] = _norm_spec(cfg)
            s["ffn"] = mlp_specs(cfg)
    elif kind == "hybrid":
        s["attn"] = attn.attn_specs(cfg)
        s["ssm"] = ssm_mod.ssm_specs(cfg)
        s["mix"] = PSpec((2, d), (None, "embed"), init="ones", scale=0.5)
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = mlp_specs(cfg)
    elif kind == "cross":
        s["xattn"] = attn.attn_specs(cfg, cross=True)
        s["gate"] = PSpec((1,), (None,), init="zeros", dtype=torch.float32)
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = mlp_specs(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    return s


def ffn_forward(p: dict, cfg: ArchConfig, kind: str,
                x: torch.Tensor) -> torch.Tensor:
    """The layer's second half: x + FFN(norm(x)) when it has one."""

    if "ffn" not in p:
        return x
    h = rms_norm(x, p["ln2"])
    if kind == "moe":
        return x + moe_mod.moe_forward(p["ffn"], cfg, h)
    return x + mlp_forward(p["ffn"], cfg, h)


def layer_forward(p: dict, cfg: ArchConfig, kind: str, x: torch.Tensor,
                  positions: torch.Tensor, *,
                  enc_out: torch.Tensor | None = None,
                  causal: bool = True) -> torch.Tensor:
    h = rms_norm(x, p["ln1"])
    if kind in ("dense", "moe", "encoder"):
        x = x + attn.attention(p["attn"], cfg, h, positions, causal=causal,
                               window=cfg.window, use_flash=cfg.use_flash)
    elif kind == "ssm":
        x = x + ssm_mod.ssm_forward(p["ssm"], cfg, h)
    elif kind == "hybrid":
        a = attn.attention(p["attn"], cfg, h, positions, causal=True,
                           window=cfg.window, use_flash=cfg.use_flash)
        m = ssm_mod.ssm_forward(p["ssm"], cfg, h)
        x = x + p["mix"][0] * a + p["mix"][1] * m
    elif kind == "cross":
        a = attn.attention(p["xattn"], cfg, h, positions, x_kv=enc_out)
        x = x + torch.tanh(p["gate"]).to(x.dtype) * a
    return lc(ffn_forward(p, cfg, kind, x), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Stacks (a loop over the stacked blocks)
# ---------------------------------------------------------------------------


def _block_plan(cfg: ArchConfig) -> tuple[list[str], int]:
    """Returns (kinds within one block, number of blocks).  The stack is
    ``n_blocks`` repetitions of the block."""

    if cfg.family in ("dense", "ssm", "hybrid"):
        return [cfg.family], cfg.n_layers
    if cfg.family == "moe":
        every = cfg.moe.every
        if every == 1:
            return ["moe"], cfg.n_layers
        assert cfg.n_layers % every == 0
        return ["dense"] * (every - 1) + ["moe"], cfg.n_layers // every
    if cfg.family == "vlm":
        every = cfg.cross_attn_every
        assert cfg.n_layers % every == 0
        return ["dense"] * (every - 1) + ["cross"], cfg.n_layers // every
    if cfg.family == "audio":
        return ["dense"], cfg.n_layers      # decoder; encoder built apart
    raise ValueError(cfg.family)


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
    if cfg.family == "audio":
        enc_block = {"0_encoder": layer_specs(cfg, "encoder")}
        specs["enc_blocks"] = stack_specs(enc_block, cfg.encoder_layers)
        specs["enc_ln_f"] = _norm_spec(cfg)
        # the decoder's cross attention, one after each decoder block
        xblock = {"x": attn.attn_specs(cfg, cross=True),
                  "ln_x": _norm_spec(cfg)}
        specs["xattn_blocks"] = stack_specs(xblock, cfg.n_layers)
    return specs


def block_params(blocks: dict, i: int) -> dict:
    """Block ``i`` of a stacked tree: views into the stacked tensors."""

    return tree_map(lambda a: a[i], blocks)


def gather_params(tree):
    """A parameter tree in its compute placements
    (:func:`~repro_torch.distribute.sharding.gather_fsdp` on each leaf);
    the tree itself without a mesh context."""

    if current_ctx() is None:
        return tree
    return tree_map(gather_fsdp, tree)


# the counterpart of jax.checkpoint_policies.checkpoint_dots: the outputs
# of matrix products are saved, everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, body: Callable[[torch.Tensor], torch.Tensor],
           x: torch.Tensor, params: Any) -> torch.Tensor:
    """``body(x)`` for one block under ``cfg.remat``: checkpointed only
    where a gradient is being taken through ``x`` or ``params``."""

    if cfg.remat == "none" or not torch.is_grad_enabled() or not (
            x.requires_grad
            or any(t.requires_grad for t in tree_leaves(params))):
        return body(x)
    if cfg.remat == "dots":
        return checkpoint(body, x, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    if cfg.remat == "full":
        return checkpoint(body, x, use_reentrant=False)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _run_blocks(cfg: ArchConfig, blocks: dict, x: torch.Tensor,
                positions: torch.Tensor, *,
                enc_out: torch.Tensor | None = None, causal: bool = True,
                kinds: list[str] | None = None) -> torch.Tensor:
    kinds = kinds or _block_plan(cfg)[0]
    n_blocks = next(iter(tree_leaves(blocks))).shape[0]
    for i in range(n_blocks):
        bp = block_params(blocks, i)

        def body(h, bp=bp):
            bp = gather_params(bp)
            for j, kind in enumerate(kinds):
                h = layer_forward(bp[f"{j}_{kind}"], cfg, kind, h, positions,
                                  enc_out=enc_out, causal=causal)
            return h

        x = _remat(cfg, body, x, bp)
    return x


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # the reference's constraint after the embedding (its forward_lm and
    # hidden_lm), here for every caller
    w = gather_fsdp(params["embed"])
    tokens = tokens.to(torch.int64)
    if current_ctx() is None or not isinstance(w, _dtensor_type()):
        return F.embedding(tokens, w)
    return lc(_vocab_parallel_embed(tokens, w), "batch", "seq", "embed")


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _vocab_parallel_embed(tokens, w):
    """The lookup of (B, S) tokens in a (V, d) DTensor table whose vocab
    dim may be sharded.

    local_map region: tokens as they are placed, the table with its d dim
    whole (gathered if it was not) and its V dim sharded or not; out
    (B, S, d) a partial sum over the mesh dims that shard V (each rank
    looks up the tokens in its vocab range, zeros elsewhere), sharded
    like the tokens' batch dim on the others.  The table's gradient comes
    back as each rank's rows, a partial sum over the tokens' batch dims.
    DTensor's own sharded lookup leaves a masked partial sum that its
    backward cannot add to the tied logits' gradient."""

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    wp = tuple(Replicate() if isinstance(p, Shard) and p.dim != 0 else p
               for p in w.placements)
    if wp != tuple(w.placements):
        w = w.redistribute(mesh, wp)
    tp = tuple(tokens.placements)
    vocab_dims = [m for m, p in enumerate(wp) if isinstance(p, Shard)]
    lo = shard_offset(w, 0)
    out_p = [Partial() if m in vocab_dims else
             (Shard(0) if isinstance(tp[m], Shard) and tp[m].dim == 0
              else Replicate()) for m in range(mesh.ndim)]
    grad_p = [Shard(0) if m in vocab_dims else
              (Partial() if isinstance(tp[m], Shard) else Replicate())
              for m in range(mesh.ndim)]

    def lookup(tok, wl):
        rows = tok - lo
        hit = (rows >= 0) & (rows < wl.shape[0])
        x = F.embedding(torch.where(hit, rows, 0), wl)
        return x * hit[..., None].to(x.dtype)

    return local_map(lookup, out_placements=out_p, in_placements=(tp, wp),
                     in_grad_placements=(tp, grad_p), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, w)


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, gather_fsdp(params["ln_f"]))
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, gather_fsdp(params["embed"]))
    else:
        logits = x @ gather_fsdp(params["unembed"])
    logits = lc(logits, "batch", "seq", "vocab")
    return logits.to(getattr(torch, cfg.logits_dtype))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    """(B, S) positions ``0 .. S-1``, marked so that the flash gate takes
    them without reading them back (:func:`attention._positions_standard`)."""

    pos = torch.arange(S, device=device).expand(B, S)
    pos._arange = True
    return pos


def _trunk(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
           img_embeds: torch.Tensor | None) -> torch.Tensor:
    x = _embed(params, tokens)
    if img_embeds is not None:
        img_embeds = img_embeds.to(x.dtype)
    return _run_blocks(cfg, params["blocks"], x,
                       _positions(*tokens.shape, tokens.device),
                       enc_out=img_embeds)


def forward_lm(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
               img_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder-only forward -> logits (B, S, V)."""

    return _logits(params, cfg, _trunk(params, cfg, tokens, img_embeds))


def hidden_lm(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
              img_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder trunk up to (and including) the final norm: no logits."""

    return rms_norm(_trunk(params, cfg, tokens, img_embeds),
                    gather_fsdp(params["ln_f"]))


def encode(params: dict, cfg: ArchConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """The enc-dec encoder over frame embeddings (B, Senc, d), after its
    final norm.  Non-causal self-attention: the flash gate takes it only
    where Senc tiles by 128 (whisper's 1,500 frames do not)."""

    B, Senc, d = frames.shape
    frames = frames.to(params["embed"].dtype)
    enc = frames + _sinusoid(Senc, d, frames.dtype, frames.device)
    enc = _run_blocks(cfg, params["enc_blocks"], enc,
                      _positions(B, Senc, frames.device), causal=False,
                      kinds=["encoder"])
    return rms_norm(enc, gather_fsdp(params["enc_ln_f"]))


def forward_encdec(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                   frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style: encode frame embeddings, decode tokens."""

    enc = encode(params, cfg, frames)
    B, S = tokens.shape
    x = _embed(params, tokens)
    x = x + _sinusoid(S, cfg.d_model, x.dtype, x.device)
    positions = _positions(B, S, tokens.device)
    for i in range(cfg.n_layers):
        dp = block_params(params["blocks"], i)["0_dense"]
        xp = block_params(params["xattn_blocks"], i)

        def body(h, dp=dp, xp=xp):
            dp, xp = gather_params(dp), gather_params(xp)
            h = layer_forward(dp, cfg, "dense", h, positions)
            return h + attn.attention(xp["x"], cfg, rms_norm(h, xp["ln_x"]),
                                      positions, x_kv=enc)

        x = _remat(cfg, body, x, {"dense": dp, "x": xp})
    return _logits(params, cfg, x)


def _sinusoid(S: int, d: int, dtype, device) -> torch.Tensor:
    """(1, S, d) sinusoidal embeddings of positions 0..S-1."""

    return sinusoid_at(torch.arange(S, device=device), d, dtype)[None]


def sinusoid_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Sinusoidal embedding at absolute position(s): (...,) positions ->
    (..., d); callers shape the position grid ((B, 1) per-slot decode,
    (B, T) chunked prefill)."""

    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[..., None] / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _chunked_ce(params: dict, cfg: ArchConfig, h: torch.Tensor,
                labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """CE without materializing (B, S, V): a loop over sequence chunks
    (numerically the fused CE up to summation order)."""

    B, S, d = h.shape
    w = gather_fsdp(params["embed"] if cfg.tie_embeddings
                    else params["unembed"])
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        hx, lx = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", hx, w)
        else:
            logits = hx @ w
        lse, gold = ce_terms(logits.float(), lx)
        total = total + torch.sum(lse - gold)
    return total / (B * S)


def lm_loss(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    if cfg.is_encdec:
        logits = forward_encdec(params, cfg, batch["tokens"],
                                batch["frames"])
        return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    if cfg.loss_seq_chunk:
        h = hidden_lm(params, cfg, batch["tokens"], batch.get("img_embeds"))
        return _chunked_ce(params, cfg, h[:, :-1], batch["labels"][:, 1:],
                           cfg.loss_seq_chunk)
    logits = forward_lm(params, cfg, batch["tokens"], batch.get("img_embeds"))
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


__all__ = [
    "mlp_specs", "mlp_forward", "layer_specs", "layer_forward",
    "ffn_forward", "stack_param_specs", "block_params", "gather_params",
    "forward_lm",
    "forward_encdec", "encode", "hidden_lm", "lm_loss", "sinusoid_at",
]
