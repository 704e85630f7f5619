"""GQA attention (the port's copy of ``repro.models.attention``, dense
paths): qk-norm / qkv-bias / sliding-window / RoPE variants,
full-sequence (train / prefill), single-token cached decode, and chunked
cached prefill over contiguous per-slot KV rings.

Plain PyTorch math by default; ``use_flash=True`` routes full-sequence
self-attention through the ``@autotune``d hand-written CUDA flash kernel
(:mod:`repro_torch.kernels.flash_attention`) when the call passes the
reference's gate (:func:`_flash_supported`, S tiles by 128): on a CUDA
tensor the kernel runs or raises (an uncompiled head dim raises in the
wrapper), on a CPU tensor its plain version runs.  Shapes the gate
refuses take the plain math in both packages.

Unlike the reference, whose functions return new caches, the cached
paths here write the caches IN PLACE (a qwen1.5-4b serving state is
1.7 GB; a functional copy per step would move it all every tick).  They
return the same dict they were given.  Paged and cross attention are
not ported yet (ROADMAP queue 1, items 17 and 19).
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from .common import DEFAULT_DTYPE, PSpec, rms_norm, rope

NEG_INF = -1e30


def attn_specs(cfg: ArchConfig, cross: bool = False) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs: dict[str, Any] = {
        "wq": PSpec((d, H, hd), ("embed", "heads", None)),
        "wk": PSpec((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wv": PSpec((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wo": PSpec((H, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = PSpec((H, hd), ("heads", None), init="zeros")
        specs["bk"] = PSpec((Hkv, hd), ("kv_heads", None), init="zeros")
        specs["bv"] = PSpec((Hkv, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = PSpec((hd,), (None,), init="ones")
        specs["k_norm"] = PSpec((hd,), (None,), init="ones")
    return specs


def _project_qkv(p: dict, cfg: ArchConfig, xq: torch.Tensor,
                 xkv: torch.Tensor):
    q = torch.einsum("bsd,dhk->bhsk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", xkv, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", xkv, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=1)


def _sdpa(q, k, v, mask, scale):
    s = torch.einsum("bhqk,bhsk->bhqs", q.float() * scale, k.float())
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bhsk->bhqk", p, v.float())
    return o.to(q.dtype)


# Above this query length, attention processes queries in chunks so the
# f32 score tensor stays O(chunk·S) instead of O(S²).  Chunk size is a
# tuning parameter.
Q_CHUNK_THRESHOLD = 8192
Q_CHUNK = 1024


def _sdpa_qchunked(q, k, v, positions, scale, *, causal, window,
                   chunk=Q_CHUNK):
    B, H, S, hd = q.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
        # padded queries mask out every key (position -1 precedes all
        # keys under the causal mask); their rows are sliced off below
        positions = torch.nn.functional.pad(positions, (0, pad), value=-1)
    ki = positions[:, None, None, :S]                       # (B,1,1,S)
    outs = []
    for c in range(nc):
        qc = q[:, :, c * chunk:(c + 1) * chunk]
        # the caller's per-query positions: the mask honors them (offset
        # prefill), it does not assume 0-based contiguity
        qi = positions[:, None, c * chunk:(c + 1) * chunk, None]
        if causal:
            m = ki <= qi
            if window is not None:
                m &= ki >= qi - window + 1
        else:
            m = torch.ones((1, 1, 1, S), dtype=torch.bool, device=q.device)
        outs.append(_sdpa(qc, k, v, m, scale))
    return torch.cat(outs, dim=2)[:, :, :S]


def _flash_supported(q: torch.Tensor) -> bool:
    """The reference's gate for the flash kernel on a full-sequence call:
    S tiles by 128.  A call that passes launches the kernel (CUDA; it
    raises for a head dim that was not compiled) or runs its plain
    version (CPU); one that does not takes the plain math here, as in
    the reference."""

    return q.shape[2] % 128 == 0


def _positions_standard(positions: torch.Tensor, S: int) -> bool:
    """The flash kernel masks by absolute 0-based indices, so it requires
    ``positions == arange(S)`` (offset prefill takes the plain path,
    which honors the caller's positions).  Reads the positions back to
    the host: one sync per call."""

    want = torch.arange(S, dtype=positions.dtype, device=positions.device)
    return bool(torch.equal(positions, want.expand_as(positions)))


def attention(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int | None = None, x_kv: torch.Tensor | None = None,
              use_flash: bool = False) -> torch.Tensor:
    """Full-sequence self-attention.

    ``use_flash=True`` routes the call through the ``@autotune``d flash
    kernel (block sizes from the tuning cache) when it passes the gate
    and ``positions == arange(S)``; otherwise the plain math runs."""

    if x_kv is not None:
        raise NotImplementedError(
            "cross attention is not ported yet (ROADMAP queue 1, item 19)")
    B, S, d = x.shape
    q, k, v = _project_qkv(p, cfg, x, x)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)

    if use_flash and _flash_supported(q) \
            and _positions_standard(positions, S):
        from ..kernels.flash_attention.ops import flash_attention
        # window only applies under causality in the plain paths; match
        # that here so use_flash never changes semantics
        o = flash_attention(q, k, v, causal=causal,
                            window=window if causal else None)
    elif causal and S > Q_CHUNK_THRESHOLD:
        o = _sdpa_qchunked(q, k, v, positions, cfg.hd ** -0.5,
                           causal=True, window=window)
    else:
        if not causal:
            mask = torch.ones((1, 1, S, S), dtype=torch.bool,
                              device=x.device)
        else:
            qi = positions[:, None, :, None]           # (B,1,S,1)
            ki = positions[:, None, None, :]           # (B,1,1,S)
            mask = ki <= qi
            if window is not None:
                mask &= ki >= qi - window + 1
        o = _sdpa(q, k, v, mask, cfg.hd ** -0.5)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# Cached decode (contiguous per-slot rings, written in place)
# ---------------------------------------------------------------------------


def kv_cache_specs(cfg: ArchConfig, batch: int, cache_len: int,
                   dtype: Any = None) -> dict:
    """One block's K/V rings.  ``dtype`` lets callers match the cache to
    the params' compute dtype (a float32 model wants float32 K/V)."""

    Hkv, hd = cfg.n_kv_heads, cfg.hd
    dt = dtype if dtype is not None else DEFAULT_DTYPE
    return {
        "k": PSpec((batch, Hkv, cache_len, hd),
                   ("cache_batch", "kv_heads", "cache_seq", "head_dim"),
                   init="zeros", dtype=dt),
        "v": PSpec((batch, Hkv, cache_len, hd),
                   ("cache_batch", "kv_heads", "cache_seq", "head_dim"),
                   init="zeros", dtype=dt),
    }


def per_slot(v, B: int, device) -> torch.Tensor:
    """A scalar or (B,) count as an int64 (B,) tensor on ``device``."""

    t = torch.as_tensor(v, device=device).to(torch.int64)
    return torch.broadcast_to(t, (B,))


def decode_attention(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     cur_len, *, window: int | None = None,
                     active: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """One-token attention against a KV cache, writing it in place.

    x: (B, 1, d); cache["k"/"v"]: (B, Hkv, C, hd) where C is the cache
    length (= window size for SWA, a ring buffer, else max context);
    cur_len: count of tokens already in the cache, a scalar or a (B,)
    vector of per-slot counts.  Keys are stored post-RoPE.  The new K/V
    lands at ring index ``cur_len mod C`` of each slot for which
    ``active`` ((B,) bool, default all) is set; an inactive slot's ring
    is left as it was (its output is garbage the caller discards).
    Returns (output, cache)."""

    B = x.shape[0]
    C = cache["k"].shape[2]
    cur_len = per_slot(cur_len, B, x.device)
    positions = cur_len[:, None]                  # (B, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k_new = rope(k_new, positions, cfg.rope_theta)

    slot = torch.remainder(cur_len, C)            # (B,) ring for SWA
    rows = torch.arange(B, device=x.device)
    for name, new in (("k", k_new), ("v", v_new)):
        buf = cache[name]
        val = new[:, :, 0].to(buf.dtype)          # (B, Hkv, hd)
        if active is not None:
            val = torch.where(active[:, None, None], val, buf[rows, :, slot])
        buf[rows, :, slot] = val

    # validity per slot: ring index i last held absolute position
    # cur_len[b] - ((slot[b] - i) mod C)
    idx = torch.arange(C, device=x.device)[None, :]   # (1, C)
    cl = cur_len[:, None]                             # (B, 1)
    if window is not None:
        abs_pos = cl - torch.remainder(slot[:, None] - idx, C)
        valid = (abs_pos >= torch.clamp(cl - window + 1, min=0)) & \
                (abs_pos <= cl)
    else:
        valid = idx <= cl                             # (B, C)
    mask = valid[:, None, None, None, :]              # (B, 1, 1, 1, C)

    o = _grouped_sdpa(q, cache["k"], cache["v"], mask,
                      cfg.hd ** -0.5).to(x.dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    return out, cache


def decode_attention_chunked(p: dict, cfg: ArchConfig, x: torch.Tensor,
                             cache: dict, cur_len, lengths, *,
                             window: int | None = None, write: bool = True
                             ) -> tuple[torch.Tensor, dict]:
    """Chunked cached prefill: advance T tokens against the decode cache
    in one call (the multi-token sibling of :func:`decode_attention`).

    x: (B, T, d); cache["k"/"v"]: (B, Hkv, C, hd); cur_len: (B,) tokens
    already in each slot's cache; lengths: (B,) valid tokens of this
    chunk per slot (rows past a slot's length are padding: they neither
    read into the cache nor write it).

    Queries attend to the pre-chunk cache concatenated with the in-chunk
    keys under a chunk-causal mask from absolute positions.  Attending
    the pre-chunk ring rather than the updated one is load-bearing for
    SWA: with a ring of C slots and a chunk longer than C, a late
    in-chunk token overwrites the ring slot an early query still needs.
    Then, with ``write`` (default), the valid chunk K/V is scattered
    into the ring in place, last writer per slot winning; ``write=False``
    leaves the cache untouched (the speculative verifier's forward)."""

    B, T, d = x.shape
    C = cache["k"].shape[2]
    dev = x.device
    cur_len = per_slot(cur_len, B, dev)
    lengths = per_slot(lengths, B, dev)
    t_idx = torch.arange(T, device=dev)
    pos = cur_len[:, None] + t_idx[None, :]             # (B, T) absolute
    valid = t_idx[None, :] < lengths[:, None]           # (B, T)

    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    if cfg.use_rope:
        q = rope(q, pos, cfg.rope_theta)
        k_new = rope(k_new, pos, cfg.rope_theta)

    # pre-chunk key positions: ring index i last held absolute position
    # (cur_len-1) - ((slot_last - i) mod C); never-written indices come
    # out negative and mask off
    last = cur_len - 1
    slot_last = torch.remainder(last, C)
    idx = torch.arange(C, device=dev)[None, :]          # (1, C)
    abs_old = last[:, None] - torch.remainder(slot_last[:, None] - idx, C)

    kp = torch.cat([abs_old, pos], dim=1)               # (B, C+T)
    k_ok = torch.cat([abs_old >= 0, valid], dim=1)
    qp = pos[:, :, None]                                # (B, T, 1)
    mask = k_ok[:, None, :] & (kp[:, None, :] <= qp)    # (B, T, C+T)
    if window is not None:
        mask &= kp[:, None, :] >= qp - window + 1
    mask = mask[:, None, None, :, :]                    # (B, 1, 1, T, C+T)

    k_all = torch.cat([cache["k"].float(), k_new.float()], dim=2)
    v_all = torch.cat([cache["v"].float(), v_new.float()], dim=2)
    o = _grouped_sdpa(q, k_all, v_all, mask, cfg.hd ** -0.5).to(x.dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])

    if write:
        # ring scatter: chunk token t lands in slot pos[t] mod C; each
        # ring index takes its LAST valid writer
        ring = torch.remainder(pos, C)                  # (B, T)
        match = (ring[:, :, None] == idx[None]) & valid[:, :, None]  # (B,T,C)
        hit = match.any(dim=1)                          # (B, C)
        last_t = torch.clamp(
            (match * (t_idx[None, :, None] + 1)).amax(dim=1) - 1, min=0)
        for name, new in (("k", k_new), ("v", v_new)):
            buf = cache[name]
            vals = torch.take_along_dim(new, last_t[:, None, :, None], dim=2)
            buf.copy_(torch.where(hit[:, None, :, None], vals.to(buf.dtype),
                                  buf))
    return out, cache


def _grouped_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Grouped GQA attention: contract q head-groups against the
    kv-head cache directly (no head repeat).  q: (B, H, T, hd); k/v:
    (B, Hkv, S, hd); mask broadcastable to (B, Hkv, g, T, S); returns
    (B, H, T, hd) in f32."""

    B, H, T, hd = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, T, hd).float() * scale
    s = torch.einsum("bkgtd,bksd->bkgts", qg, k.float())
    s = s.masked_fill(~mask, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    og = torch.einsum("bkgts,bksd->bkgtd", pr, v.float())
    return og.reshape(B, H, T, hd)


__all__ = ["attn_specs", "attention", "decode_attention",
           "decode_attention_chunked", "kv_cache_specs", "per_slot",
           "NEG_INF", "Q_CHUNK_THRESHOLD", "Q_CHUNK"]
