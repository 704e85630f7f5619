"""Unified model API for every family (the port's copy of
``repro.models.api``).

``build_model(cfg)`` returns a :class:`ModelAPI` whose functions take the
parameter tree first:

* ``init(generator, device)``      — bf16 weights made on the device
* ``loss(params, batch)``          — forward + CE loss
* ``forward(params, batch)``       — logits (the serving-prefill form);
  ``batch["frames"]`` for enc-dec, ``batch["img_embeds"]`` for the vlm
* ``decode_state_specs(B, ctx, paged)`` — per-block KV rings (or with
  ``paged`` a shared page pool), SSM states, cross-attention K/V, as a
  PSpec tree
* ``decode_step`` / ``prefill_step`` / ``verify_step`` — the serving
  steps over that state (``page_table=`` addresses the pool)
* ``encode_cross_kv(params, frames)`` — the enc-dec encoder and each
  decoder layer's cross K/V, for a request's admission

Decode state is a tree with a stacked leading blocks dim, walked in
lock-step with the stacked block params.  The serving steps write the
state IN PLACE and return it (the reference returns a new tree).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..kernels.common import resolve_device
from . import attention as attn
from . import ssm as ssm_mod
from .common import (PSpec, abstract_params, axes_tree, init_params, rms_norm,
                     stack_specs, tree_leaves, tree_map)
from .transformer import (_block_plan, _embed, _logits, block_params, encode,
                          ffn_forward, forward_encdec, forward_lm,
                          gather_params, lm_loss, sinusoid_at,
                          stack_param_specs)


def _cache_len(cfg: ArchConfig, context: int) -> int:
    if cfg.window is not None:
        return min(cfg.window, context)
    return context


@dataclass
class ModelAPI:
    cfg: ArchConfig
    specs: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.specs:
            self.specs = stack_param_specs(self.cfg)

    # -- params ---------------------------------------------------------
    def init(self, generator: torch.Generator | int = 0, device=None):
        """The parameter tree on ``device`` (``cuda:0`` by default), drawn
        from ``generator`` (a ``torch.Generator`` on that device, or a
        seed for one)."""

        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            seed = int(generator)
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
        return init_params(self.specs, generator, dev)

    def abstract(self):
        """Meta tensors of the parameters (the dry run's stand-ins)."""

        return abstract_params(self.specs)

    def axes(self):
        return axes_tree(self.specs)

    def param_count(self) -> int:
        return int(sum(np.prod(s.shape) for s in tree_leaves(self.specs)))

    # -- train / prefill ---------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        return lm_loss(params, self.cfg, batch)

    def forward(self, params, batch) -> torch.Tensor:
        if self.cfg.is_encdec:
            return forward_encdec(params, self.cfg, batch["tokens"],
                                  batch["frames"])
        return forward_lm(params, self.cfg, batch["tokens"],
                          batch.get("img_embeds"))

    # -- decode ---------------------------------------------------------
    def decode_block_specs(self, batch: int, context: int, paged: Any = None,
                           dtype: Any = None) -> dict:
        """Decode state of ONE block (unstacked).  Attention layers hold
        K/V rings, or with ``paged`` (a
        :class:`~repro_torch.runtime.kv.PagedKVSpec`) a ``(n_pages, Hkv,
        page_size, hd)`` pool that slots address through the page table
        given to the steps; SSM layers hold per-slot recurrent state and
        cross layers per-slot image K/V (O(1) in context: paging buys
        nothing).  ``dtype`` overrides the KV and conv-ring dtype
        (default bfloat16): pass the params' dtype to keep a float32
        model float32 through the cache.  The cross K/V stays bfloat16,
        as in the reference."""

        cfg = self.cfg
        kinds, _ = _block_plan(cfg)
        per_block: dict[str, Any] = {}
        for i, kind in enumerate(kinds):
            entry: dict[str, Any] = {}
            if kind in ("dense", "moe", "hybrid", "encoder"):
                entry["kv"] = (
                    attn.kv_pool_specs(cfg, paged.n_pages, paged.page_size,
                                       dtype=dtype) if paged is not None
                    else attn.kv_cache_specs(cfg, batch,
                                             _cache_len(cfg, context),
                                             dtype=dtype))
            if kind in ("ssm", "hybrid"):
                entry["ssm"] = ssm_mod.ssm_state_specs(cfg, batch,
                                                       dtype=dtype)
            if kind == "cross":
                entry["enc_kv"] = _cross_kv_specs(cfg, batch,
                                                  cfg.n_img_tokens)
            per_block[f"{i}_{kind}"] = entry
        return per_block

    def decode_state_specs(self, batch: int, context: int, paged: Any = None,
                           dtype: Any = None) -> dict:
        cfg = self.cfg
        _, n_blocks = _block_plan(cfg)
        per_block = self.decode_block_specs(batch, context, paged, dtype)
        state: dict[str, Any] = {"blocks": stack_specs(per_block, n_blocks)}
        if cfg.is_encdec:
            state["xattn"] = stack_specs(
                _cross_kv_specs(cfg, batch, cfg.enc_seq), cfg.n_layers)
        return state

    def init_decode_state(self, batch: int, context: int, paged: Any = None,
                          dtype: Any = None, device=None):
        """Zeroed state on ``device`` (``cuda:0`` by default)."""

        dev = resolve_device(device)
        specs = self.decode_state_specs(batch, context, paged, dtype)
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=dev), specs)

    def decode_step(self, params, state, tokens: torch.Tensor, cur_len,
                    page_table: Any = None,
                    active: torch.Tensor | None = None):
        """tokens: (B, 1) -> (logits (B, V), state), state written IN
        PLACE.

        ``cur_len`` is a scalar token count or a (B,) vector of per-slot
        counts.  ``active`` ((B,) bool, default all) gates every write per
        slot (KV, recurrent state): an idle or prefilling slot of a
        serving batch keeps its state untouched (its logits are garbage
        the caller discards).  ``page_table`` ((B, M) int32, -1 =
        unallocated) switches the attention state to the paged pool
        layout."""

        cfg = self.cfg
        x = _embed(params, tokens)                          # (B, 1, d)
        B = tokens.shape[0]
        cur_len = attn.per_slot(cur_len, B, x.device)
        if cfg.is_encdec:
            x = x + sinusoid_at(cur_len[:, None], cfg.d_model, x.dtype)
        if page_table is None:
            def attend(p, h, kv):
                return attn.decode_attention(p, cfg, h, kv, cur_len,
                                             window=cfg.window,
                                             active=active)[0]
        else:
            if active is None:
                active = torch.ones(B, dtype=torch.bool, device=x.device)
            writes = self._paged_writes(state, page_table, cur_len[:, None],
                                        active[:, None])

            def attend(p, h, kv):
                return attn.decode_attention_paged(
                    p, cfg, h, kv, page_table, cur_len, writes,
                    window=cfg.window)[0]

        def recur(p, h, st):
            return ssm_mod.ssm_decode_step(p, cfg, h, st, active)[0]

        x = self._walk(params, state, x, attend, recur)
        return _logits(params, cfg, x)[:, 0], state

    def prefill_step(self, params, state, tokens: torch.Tensor, positions,
                     lengths=None, page_table: Any = None):
        """Chunked serving-side prefill: advance a CHUNK of prompt tokens
        per call against the decode state, writing it IN PLACE.

        tokens: (B, T), one chunk per slot; positions: (B,) per-slot count
        of tokens already in the cache; lengths: (B,) valid tokens of this
        chunk per slot (default: all T).  Slots with length 0 (decoding
        or idle while others prefill) are untouched: padding tokens
        neither write the KV nor advance the SSM state.

        Returns ``(logits (B, V), state)`` where each slot's logits are
        read at its LAST valid chunk token."""

        x, state, lengths = self._chunk_forward(params, state, tokens,
                                                positions, lengths,
                                                page_table, write=True)
        # logits only at each slot's last valid token: (B, T, V) never
        # materializes
        li = torch.clamp(lengths - 1, 0, x.shape[1] - 1)
        h_last = torch.take_along_dim(x, li[:, None, None], dim=1)
        return _logits(params, self.cfg, h_last)[:, 0], state

    def verify_step(self, params, state, tokens: torch.Tensor, positions,
                    lengths=None, page_table: Any = None):
        """Speculative-decode verifier: the chunked prefill forward with
        logits at EVERY chunk position, ``(logits (B, T, V), state)``.

        Same contract as :meth:`prefill_step`, except that the state is
        NOT written: the reference returns a state holding the chunk's
        writes, which its callers discard before committing the accepted
        prefix with ``prefill_step``.  Here the chunk's keys are attended
        and never stored (with a ``page_table``, they are placed in the
        gathered copies of the slot's pages, never in the shared pool),
        and the recurrence runs on its own tensors, so the returned state
        is the one given, untouched.  Positions past ``lengths`` hold
        garbage logits."""

        x, state, _ = self._chunk_forward(params, state, tokens, positions,
                                          lengths, page_table, write=False)
        return _logits(params, self.cfg, x), state

    def _chunk_forward(self, params, state, tokens, positions, lengths,
                       page_table, *, write: bool):
        """Shared multi-token cached forward under ``prefill_step`` and
        ``verify_step``: embed + chunk attention and recurrence over the
        blocks.  Returns ``(hidden (B, T, d), state, lengths (B,))``."""

        cfg = self.cfg
        B, T = tokens.shape
        x = _embed(params, tokens)                          # (B, T, d)
        positions = attn.per_slot(positions, B, x.device)
        lengths = attn.per_slot(T if lengths is None else lengths, B,
                                x.device)
        t_idx = torch.arange(T, device=x.device)[None, :]
        valid = t_idx < lengths[:, None]                    # (B, T)
        if cfg.is_encdec:
            x = x + sinusoid_at(positions[:, None] + t_idx, cfg.d_model,
                                x.dtype)
        if page_table is None:
            def attend(p, h, kv):
                return attn.decode_attention_chunked(
                    p, cfg, h, kv, positions, lengths, window=cfg.window,
                    write=write)[0]
        else:
            writes = self._paged_writes(state, page_table,
                                        positions[:, None] + t_idx, valid)

            def attend(p, h, kv):
                return attn.decode_attention_chunked_paged(
                    p, cfg, h, kv, page_table, positions, writes,
                    window=cfg.window, write=write)[0]

        def recur(p, h, st):
            return ssm_mod.ssm_prefill_step(p, cfg, h, st, valid,
                                            write=write)[0]

        return self._walk(params, state, x, attend, recur), state, lengths

    def _walk(self, params, state, x: torch.Tensor, attend: Callable,
              recur: Callable) -> torch.Tensor:
        """The cached layer stack: every block's layers in order, with
        ``attend(p, h, kv)`` for self attention over the block's cache
        and ``recur(p, h, ssm_state)`` for the SSM recurrence; cross
        layers (and the enc-dec cross layer after each decoder block)
        attend their precomputed K/V."""

        cfg = self.cfg
        kinds, n_blocks = _block_plan(cfg)
        for i in range(n_blocks):
            bp = gather_params(block_params(params["blocks"], i))
            cache = block_params(state["blocks"], i)
            for j, kind in enumerate(kinds):
                key = f"{j}_{kind}"
                p, c = bp[key], cache[key]
                h = rms_norm(x, p["ln1"])
                if kind in ("dense", "moe", "encoder"):
                    x = x + attend(p["attn"], h, c["kv"])
                elif kind == "hybrid":
                    a = attend(p["attn"], h, c["kv"])
                    m = recur(p["ssm"], h, c["ssm"])
                    x = x + p["mix"][0] * a + p["mix"][1] * m
                elif kind == "ssm":
                    x = x + recur(p["ssm"], h, c["ssm"])
                elif kind == "cross":
                    a = attn.decode_cross_attention(p["xattn"], cfg, h,
                                                    c["enc_kv"])
                    x = x + torch.tanh(p["gate"]).to(x.dtype) * a
                x = ffn_forward(p, cfg, kind, x)
            if cfg.is_encdec:
                xp = gather_params(block_params(params["xattn_blocks"], i))
                x = x + attn.decode_cross_attention(
                    xp["x"], cfg, rms_norm(x, xp["ln_x"]),
                    block_params(state["xattn"], i))
        return x

    def encode_cross_kv(self, params, frames: torch.Tensor) -> dict:
        """Enc-dec serving prefill: run the encoder over frames (B, Senc,
        d) and project each decoder layer's cross-attention K/V.  Returns
        {"k", "v"}: (L, B, Hkv, Senc, hd)."""

        cfg = self.cfg
        assert cfg.is_encdec
        enc = encode(params, cfg, frames)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            xp = gather_params(block_params(params["xattn_blocks"], i)["x"])
            k = torch.einsum("bsd,dhk->bhsk", enc, xp["wk"])
            if "k_norm" in xp:
                k = rms_norm(k, xp["k_norm"])
            ks.append(k)
            vs.append(torch.einsum("bsd,dhk->bhsk", enc, xp["wv"]))
        return {"k": torch.stack(ks), "v": torch.stack(vs)}

    # -- assigned-shape input specs ----------------------------------------
    def input_specs(self, shape: ShapeSpec, *, reduced: bool = False,
                    prefill_chunk: int | None = None,
                    paged: Any = None) -> dict:
        """Meta-tensor stand-ins for every model input of a shape (the
        dry-run contract; nothing is allocated), in the reference's
        dtypes.

        For decode shapes, ``cur_len`` is the (B,) per-slot position
        vector the continuous-batching server feeds.  ``prefill_chunk=T``
        describes the chunked :meth:`prefill_step` inputs instead (tokens
        (B, T), per-slot positions and lengths).  ``paged`` (a
        :class:`~repro_torch.runtime.kv.PagedKVSpec`) switches the state
        tree to the page-pool layout and adds the ``page_table`` (and,
        for decode, the per-slot ``active`` gate) of the paged steps."""

        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            out = {"tokens": meta((B, S)), "labels": meta((B, S))}
            if cfg.family == "vlm":
                out["img_embeds"] = meta((B, cfg.n_img_tokens, cfg.d_model),
                                         torch.bfloat16)
            if cfg.is_encdec:
                out["frames"] = meta((B, cfg.enc_seq, cfg.d_model),
                                     torch.bfloat16)
            return out
        state = abstract_params(self.decode_state_specs(B, S, paged))
        paged_specs = {} if paged is None else {
            "page_table": meta((B, paged.pages_per_slot))}
        if prefill_chunk is not None:
            return {"tokens": meta((B, prefill_chunk)), "state": state,
                    "positions": meta((B,)), "lengths": meta((B,)),
                    **paged_specs}
        if paged is not None:
            paged_specs["active"] = meta((B,), torch.bool)
        return {"tokens": meta((B, 1)), "state": state,
                "cur_len": meta((B,)), **paged_specs}

    @staticmethod
    def _paged_writes(state, page_table, pos, gate):
        """:func:`~repro_torch.models.attention.paged_writes` for this
        step, at the page size of the pool (stacked blocks first:
        (L, P, Hkv, page_size, hd)); None when no layer attends (a pure
        SSM stack ignores the page table)."""

        pool = next((e["kv"] for e in state["blocks"].values() if "kv" in e),
                    None)
        if pool is None:
            return None
        return attn.paged_writes(page_table, pos, gate, pool["k"].shape[3])


def _cross_kv_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Per-slot cross-attention K/V of ``seq`` encoder or image tokens
    (bfloat16, as the reference's)."""

    shape = (batch, cfg.n_kv_heads, seq, cfg.hd)
    axes = ("cache_batch", "kv_heads", None, None)
    return {"k": PSpec(shape, axes, init="zeros"),
            "v": PSpec(shape, axes, init="zeros")}


def build_model(cfg: ArchConfig) -> ModelAPI:
    return ModelAPI(cfg)


__all__ = ["ModelAPI", "build_model"]
