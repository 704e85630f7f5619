"""Unified model API for dense decoders (the port's copy of
``repro.models.api``, contiguous caches).

``build_model(cfg)`` returns a :class:`ModelAPI` whose functions take the
parameter tree first:

* ``init(generator, device)``      — bf16 weights made on the device
* ``loss(params, batch)``          — forward + CE loss
* ``forward(params, batch)``       — logits (the serving-prefill form)
* ``decode_state_specs(B, ctx)``   — per-block KV rings as a PSpec tree
* ``decode_step`` / ``prefill_step`` / ``verify_step`` — the serving
  steps over those rings

Decode state is a tree with a stacked leading blocks dim, walked in
lock-step with the stacked block params.  The serving steps write the
state IN PLACE and return it (the reference returns a new tree); only
families ``dense`` are ported, others raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from . import attention as attn
from .common import init_params, rms_norm, stack_specs, tree_leaves, tree_map
from .transformer import (_block_plan, _embed, _logits, block_params,
                          forward_lm, lm_loss, mlp_forward, require_dense,
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
        require_dense(self.cfg)
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

    def param_count(self) -> int:
        return int(sum(np.prod(s.shape) for s in tree_leaves(self.specs)))

    # -- train / prefill ---------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        return lm_loss(params, self.cfg, batch)

    def forward(self, params, batch) -> torch.Tensor:
        return forward_lm(params, self.cfg, batch["tokens"])

    # -- decode ---------------------------------------------------------
    def decode_block_specs(self, batch: int, context: int, paged: Any = None,
                           dtype: Any = None) -> dict:
        """Decode state of ONE block (unstacked): its KV rings.  ``dtype``
        overrides the KV storage dtype (default bfloat16): pass the
        params' dtype to keep a float32 model float32 through the
        cache."""

        if paged is not None:
            raise NotImplementedError(
                "paged KV is not ported yet (ROADMAP queue 1, item 17)")
        kinds, _ = _block_plan(self.cfg)
        C = _cache_len(self.cfg, context)
        return {f"{i}_{kind}": {"kv": attn.kv_cache_specs(self.cfg, batch, C,
                                                          dtype=dtype)}
                for i, kind in enumerate(kinds)}

    def decode_state_specs(self, batch: int, context: int, paged: Any = None,
                           dtype: Any = None) -> dict:
        _, n_blocks = _block_plan(self.cfg)
        per_block = self.decode_block_specs(batch, context, paged, dtype)
        return {"blocks": stack_specs(per_block, n_blocks)}

    def init_decode_state(self, batch: int, context: int, paged: Any = None,
                          dtype: Any = None, device=None):
        """Zeroed KV rings on ``device`` (``cuda:0`` by default)."""

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
        counts.  ``active`` ((B,) bool, default all) gates the KV writes
        per slot: an idle or prefilling slot of a serving batch keeps its
        ring untouched (its logits are garbage the caller discards)."""

        if page_table is not None:
            raise NotImplementedError(
                "paged KV is not ported yet (ROADMAP queue 1, item 17)")
        cfg = self.cfg
        kinds, n_blocks = _block_plan(cfg)
        x = _embed(params, tokens)                          # (B, 1, d)
        cur_len = attn.per_slot(cur_len, tokens.shape[0], x.device)
        for i in range(n_blocks):
            bp = block_params(params["blocks"], i)
            cache = block_params(state["blocks"], i)
            for j, kind in enumerate(kinds):
                key = f"{j}_{kind}"
                p, c = bp[key], cache[key]
                a, _ = attn.decode_attention(p["attn"], cfg,
                                             rms_norm(x, p["ln1"]), c["kv"],
                                             cur_len, window=cfg.window,
                                             active=active)
                x = x + a
                x = x + mlp_forward(p["ffn"], cfg, rms_norm(x, p["ln2"]))
        return _logits(params, cfg, x)[:, 0], state

    def prefill_step(self, params, state, tokens: torch.Tensor, positions,
                     lengths=None, page_table: Any = None):
        """Chunked serving-side prefill: advance a CHUNK of prompt tokens
        per call against the decode caches, writing them IN PLACE.

        tokens: (B, T), one chunk per slot; positions: (B,) per-slot count
        of tokens already in the cache; lengths: (B,) valid tokens of this
        chunk per slot (default: all T).  Slots with length 0 (decoding
        or idle while others prefill) are untouched.

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
        and never stored, so the returned state is the one given,
        untouched.  Positions past ``lengths`` hold garbage logits."""

        x, state, _ = self._chunk_forward(params, state, tokens, positions,
                                          lengths, page_table, write=False)
        return _logits(params, self.cfg, x), state

    def _chunk_forward(self, params, state, tokens, positions, lengths,
                       page_table, *, write: bool):
        """Shared multi-token cached forward under ``prefill_step`` and
        ``verify_step``: embed + chunk attention over the blocks.
        Returns ``(hidden (B, T, d), state, lengths (B,))``."""

        if page_table is not None:
            raise NotImplementedError(
                "paged KV is not ported yet (ROADMAP queue 1, item 17)")
        cfg = self.cfg
        kinds, n_blocks = _block_plan(cfg)
        B, T = tokens.shape
        x = _embed(params, tokens)                          # (B, T, d)
        positions = attn.per_slot(positions, B, x.device)
        lengths = attn.per_slot(T if lengths is None else lengths, B,
                                x.device)
        for i in range(n_blocks):
            bp = block_params(params["blocks"], i)
            cache = block_params(state["blocks"], i)
            for j, kind in enumerate(kinds):
                key = f"{j}_{kind}"
                p, c = bp[key], cache[key]
                a, _ = attn.decode_attention_chunked(
                    p["attn"], cfg, rms_norm(x, p["ln1"]), c["kv"],
                    positions, lengths, window=cfg.window, write=write)
                x = x + a
                x = x + mlp_forward(p["ffn"], cfg, rms_norm(x, p["ln2"]))
        return x, state, lengths


def build_model(cfg: ArchConfig) -> ModelAPI:
    return ModelAPI(cfg)


__all__ = ["ModelAPI", "build_model"]
