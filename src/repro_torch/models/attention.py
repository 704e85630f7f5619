"""GQA attention (the port's copy of ``repro.models.attention``):
qk-norm / qkv-bias / sliding-window / RoPE variants, full-sequence
(train / prefill) self and cross attention, single-token cached decode,
and chunked cached prefill over contiguous per-slot KV rings or a shared
pool of KV pages addressed through per-slot page tables.

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
return the same dict they were given.  The paged writes are indexed
writes of only the gated tokens (:func:`paged_writes`), where the
reference scatters through a one-hot ``(B, P, page_size)`` match and
``argmax``; pages are slot-exclusive and positions unique, so both land
the same values.  Cross attention (``attention(x_kv=...)``, and
:func:`decode_cross_attention` against precomputed encoder or image K/V)
has no RoPE and no mask, and never takes the flash kernel.

Paged decode (:func:`decode_attention_paged`, T = 1) attends through the
hand-written CUDA kernel (:mod:`repro_torch.kernels.paged_decode`),
which reads each slot's live pages in place; on a CPU tensor its plain
version runs, the page-table gather and grouped f32 core that the
chunked paged path (T > 1) keeps.

Each path names two ranges (:func:`repro_torch.obs.profile.span`, timed
on the device's stream): ``attn.kv``, the keys and values made ready for
the core (the cache write, the page-table gather, the head repeat; the
paged decode's write alone), and ``attn.core``, the attention core over
them (upcast, scores, mask, softmax, values; the paged decode kernel).
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..distribute.sharding import current_ctx
from ..distribute.sharding import logical_constraint as lc
# bound as a module, not by name: the kernel's plain version imports
# .attn_core, so a process that imports the kernel first runs this module
# while the kernel's package is half loaded
from ..kernels.paged_decode import ops as paged_decode_ops
from ..obs.profile import span
from .attn_core import NEG_INF, gather_pool, grouped_sdpa, pool_validity
from .common import DEFAULT_DTYPE, PSpec, rms_norm, rope


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

    if getattr(positions, "_arange", False):
        return True
    want = torch.arange(S, dtype=positions.dtype, device=positions.device)
    return bool(torch.equal(positions, want.expand_as(positions)))


@functools.cache
def _fake_flash_op():
    """``repro_torch::fake_flash(q, k, v, causal, window)``: the flash
    kernel's stand-in on the dry run's fake tensors, registered on first
    use.  Its output is q's shape, and its FLOP formula counts the two
    products over the (q, k) pairs inside the mask, ``4·B·H·D·pairs``;
    its backward (``fake_flash_backward``) counts the five products of a
    flash backward (the scores recomputed, dV, dP, dQ, dK),
    ``10·B·H·D·pairs``, as torch's SDPA formulas do for an unmasked
    call.  Neither runs on real tensors."""

    from torch.utils.flop_counter import register_flop_formula

    from ..kernels.flash_attention.ops import visible_pairs

    def refuse(*_):
        raise RuntimeError("fake_flash stands in for the flash kernel on "
                           "fake tensors only")

    @torch.library.custom_op("repro_torch::fake_flash", mutates_args=())
    def fake_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: int | None) -> torch.Tensor:
        refuse()

    @torch.library.custom_op("repro_torch::fake_flash_backward",
                             mutates_args=())
    def fake_flash_backward(
            grad: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, out: torch.Tensor, causal: bool,
            window: int | None) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
        refuse()

    @fake_flash.register_fake
    def _(q, k, v, causal, window):
        return torch.empty_like(q)

    @fake_flash_backward.register_fake
    def _(grad, q, k, v, out, causal, window):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def setup(ctx, inputs, output):
        q, k, v, ctx.causal, ctx.window = inputs
        ctx.save_for_backward(q, k, v, output)

    def backward(ctx, grad):
        return (*fake_flash_backward(grad, *ctx.saved_tensors, ctx.causal,
                                     ctx.window), None, None)

    fake_flash.register_autograd(backward, setup_context=setup)

    def products(n, q_shape, causal, window):
        B, H, S, D = q_shape
        return n * B * H * D * visible_pairs(S, causal, window)

    @register_flop_formula(torch.ops.repro_torch.fake_flash)
    def _(q_shape, k_shape, v_shape, causal, window, *_, **__):
        return products(4, q_shape, causal, window)

    @register_flop_formula(torch.ops.repro_torch.fake_flash_backward)
    def _(grad_shape, q_shape, k_shape, v_shape, o_shape, causal, window,
          *_, **__):
        return products(10, q_shape, causal, window)

    return torch.ops.repro_torch.fake_flash


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int | None) -> torch.Tensor:
    """The flash kernel on (B, H, S, D) q/k/v; on DTensors, on each
    rank's shard.

    local_map region: q, k, v and the output placed by the logical axes
    ("batch", "heads", None, None) -- B over the batch rule's mesh dims,
    H over the heads rule's, S and D whole on every rank (inputs
    sharded otherwise are redistributed first), so attention on a shard
    is exact and the kernel takes plain local tensors."""

    from ..kernels.flash_attention.ops import flash_attention

    def run(q, k, v):
        from torch._subclasses.fake_tensor import is_fake
        if is_fake(q):
            # the dry run's fake shards: stand in the kernel's cost, an
            # O(S·D) output and the FLOPs of the pairs inside the mask,
            # for the plain version's O(S²) scores
            return _fake_flash_op()(q, k, v, causal, window)
        return flash_attention(q, k, v, causal=causal, window=window)

    ctx = current_ctx()
    if ctx is None or not _is_dtensor(q):
        return run(q, k, v)
    from torch.distributed.tensor.experimental import local_map
    pl = ctx.placements(("batch", "heads", None, None), tuple(q.shape))
    return local_map(run, out_placements=list(pl),
                     in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def _on_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               aux: torch.Tensor, *args, **kw) -> torch.Tensor:
    """``fn(q, k, v, aux, *args, **kw)``, an attention core over
    (B, H, T, D) q and (B, Hkv, S, D) k/v; on DTensors, on each rank's
    shard.

    local_map region: q, k, v and the output placed by the logical axes
    ("batch", "heads", None, None) -- heads sharded only where both H and
    Hkv divide the mesh, so each shard keeps whole head groups -- T, S
    and D whole; ``aux`` (a mask or positions, leading dim B or 1) over
    the batch rule's mesh dims when its leading dim is B.  DTensor cannot
    run these products itself once batch and heads are both sharded (a
    bmm over the flattened pair), and on a shard they are exact."""

    ctx = current_ctx()
    if ctx is None or not _is_dtensor(q):
        return fn(q, k, v, aux, *args, **kw)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    heads = ("batch", "heads", None, None)
    pq = ctx.placements(heads, tuple(q.shape))
    pk = ctx.placements(heads, tuple(k.shape))
    if pq != pk:
        pq = pk = ctx.placements(("batch", None, None, None), tuple(q.shape))
    lead = ("batch",) if aux.shape[0] == q.shape[0] else (None,)
    pa = ctx.placements(lead + (None,) * (aux.dim() - 1), tuple(aux.shape))
    if not isinstance(aux, DTensor):
        from torch.distributed.tensor import distribute_tensor
        aux = distribute_tensor(aux, q.device_mesh, pa, src_data_rank=None)
    run = functools.partial(fn, **kw)
    return local_map(run, out_placements=list(pq),
                     in_placements=(pq, pk, pk, pa) + (None,) * len(args),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v, aux, *args)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def attention(p: dict, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int | None = None, x_kv: torch.Tensor | None = None,
              use_flash: bool = False) -> torch.Tensor:
    """Full-sequence attention.  ``x_kv`` ((B, Skv, d)) switches to cross
    attention: keys and values from ``x_kv``, no RoPE, no mask.

    ``use_flash=True`` routes self-attention through the ``@autotune``d
    flash kernel (block sizes from the tuning cache) when it passes the
    gate and ``positions == arange(S)``; otherwise the plain math runs."""

    B, S, d = x.shape
    cross = x_kv is not None
    xkv = x_kv if cross else x
    q, k, v = _project_qkv(p, cfg, x, xkv)
    if cfg.use_rope and not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    with span("attn.kv"):
        k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    q = lc(q, "batch", "heads", "seq", None)
    k = lc(k, "batch", "heads", "seq", None)

    with span("attn.core"):
        if cross:
            mask = torch.ones((1, 1, S, xkv.shape[1]), dtype=torch.bool,
                              device=x.device)
            o = _on_shards(_sdpa, q, k, v, mask, cfg.hd ** -0.5)
        elif use_flash and _flash_supported(q) \
                and _positions_standard(positions, S):
            # window only applies under causality in the plain paths;
            # match that here so use_flash never changes semantics
            o = _flash(q, k, v, causal=causal,
                       window=window if causal else None)
        elif causal and S > Q_CHUNK_THRESHOLD:
            o = _on_shards(_sdpa_qchunked, q, k, v, positions,
                           cfg.hd ** -0.5, causal=True, window=window)
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
            o = _on_shards(_sdpa, q, k, v, mask, cfg.hd ** -0.5)
    o = lc(o, "batch", "heads", "seq", None)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    return lc(out, "batch", "seq", "embed")


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
    with span("attn.kv"):
        if _is_dtensor(cache["k"]):
            # a DTensor cache (batch, kv heads or ring slots sharded)
            # takes the write as a masked select over the ring, which
            # DTensor shards like any elementwise op; the index write
            # below has no sharding strategy.  Same values, one pass
            # over the ring.
            hit = torch.arange(C, device=x.device)[None, :] == slot[:, None]
            if active is not None:
                hit = hit & active[:, None]
            for name, new in (("k", k_new), ("v", v_new)):
                buf = cache[name]
                buf.copy_(torch.where(hit[:, None, :, None],
                                      new.to(buf.dtype), buf))
        else:
            rows = torch.arange(B, device=x.device)
            for name, new in (("k", k_new), ("v", v_new)):
                buf = cache[name]
                val = new[:, :, 0].to(buf.dtype)      # (B, Hkv, hd)
                if active is not None:
                    val = torch.where(active[:, None, None], val,
                                      buf[rows, :, slot])
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

    with span("attn.core"):
        o = _on_shards(grouped_sdpa, q, cache["k"], cache["v"], mask,
                       cfg.hd ** -0.5).to(x.dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    return lc(out, "batch", "seq", "embed"), cache


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

    with span("attn.kv"):
        k_all = torch.cat([cache["k"].float(), k_new.float()], dim=2)
        v_all = torch.cat([cache["v"].float(), v_new.float()], dim=2)
        if write:
            # ring scatter, after the copies above that the core reads:
            # chunk token t lands in slot pos[t] mod C; each ring index
            # takes its LAST valid writer
            ring = torch.remainder(pos, C)              # (B, T)
            match = (ring[:, :, None] == idx[None]) & valid[:, :, None]
            hit = match.any(dim=1)                      # (B, C)
            last_t = torch.clamp(
                (match * (t_idx[None, :, None] + 1)).amax(dim=1) - 1, min=0)
            for name, new in (("k", k_new), ("v", v_new)):
                buf = cache[name]
                vals = torch.take_along_dim(new, last_t[:, None, :, None],
                                            dim=2)
                buf.copy_(torch.where(hit[:, None, :, None],
                                      vals.to(buf.dtype), buf))
    with span("attn.core"):
        o = _on_shards(grouped_sdpa, q, k_all, v_all, mask,
                       cfg.hd ** -0.5).to(x.dtype)
    out = lc(torch.einsum("bhsk,hkd->bsd", o, p["wo"]), "batch", "seq",
             "embed")
    return out, cache


# ---------------------------------------------------------------------------
# Paged cached decode (shared page pool instead of per-slot rings)
# ---------------------------------------------------------------------------


def kv_pool_specs(cfg: ArchConfig, n_pages: int, page_size: int,
                  dtype: Any = None) -> dict:
    """Paged KV storage for one block: a POOL of ``n_pages`` fixed-size
    pages shared by every serving slot, addressed through per-slot page
    tables (:mod:`repro_torch.runtime.kv`), the paged sibling of
    :func:`kv_cache_specs`.  ``dtype`` as there."""

    Hkv, hd = cfg.n_kv_heads, cfg.hd
    dt = dtype if dtype is not None else DEFAULT_DTYPE
    return {
        "k": PSpec((n_pages, Hkv, page_size, hd),
                   ("cache_batch", "kv_heads", None, "head_dim"),
                   init="zeros", dtype=dt),
        "v": PSpec((n_pages, Hkv, page_size, hd),
                   ("cache_batch", "kv_heads", None, "head_dim"),
                   init="zeros", dtype=dt),
    }


def paged_writes(page_table: torch.Tensor, pos: torch.Tensor,
                 gate: torch.Tensor, page_size: int) -> tuple:
    """Where a step's gated tokens land in the pool.

    pos: (B, T) absolute positions; gate: (B, T) bool, the tokens that
    write (``active`` for decode, ``t < lengths`` for a chunk).  A token
    writes page ``page_table[b, pos // ps]`` at offset ``pos % ps`` when
    it is gated AND that page is backed: an entry of -1 writes nothing
    (never page 0 through a clipped index).  Returns the index tensors
    ``(b, t, phys, off, lp)`` of the writes that happen, ``lp`` the
    logical page.  Reads the gate back to the host once
    (``nonzero``); the indices are the same for every block, so a step
    computes them once."""

    M = page_table.shape[1]
    lp = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"),
                     0, M - 1)
    phys = torch.take_along_dim(page_table.long(), lp, dim=1)
    b, t = torch.nonzero(gate & (phys >= 0), as_tuple=True)
    return b, t, phys[b, t], torch.remainder(pos, page_size)[b, t], lp[b, t]


def _paged_store(pool: dict, writes: tuple, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> None:
    """Store a step's gated tokens in the pool, in place."""

    b, t, phys, off, _ = writes
    for name, new in (("k", k_new), ("v", v_new)):
        pool[name][phys, :, off] = new[b, :, t].to(pool[name].dtype)


def _paged_kv(pool: dict, page_table: torch.Tensor, writes: tuple,
              k_new: torch.Tensor, v_new: torch.Tensor, *, write: bool):
    """The slot's linear K/V views (B, Hkv, M*ps, hd) holding this
    step's new tokens.  ``write``: store them in the pool, in place, then
    gather; else gather and place them in the gathered copies only, so
    the shared pool is never touched."""

    if write:
        _paged_store(pool, writes, k_new, v_new)
        return [gather_pool(pool[name], page_table) for name in ("k", "v")]
    b, t, _, off, lp = writes
    ps = pool["k"].shape[2]
    out = []
    for name, new in (("k", k_new), ("v", v_new)):
        lin = gather_pool(pool[name], page_table)
        lin[b, :, lp * ps + off] = new[b, :, t].to(lin.dtype)
        out.append(lin)
    return out


def decode_attention_chunked_paged(p: dict, cfg: ArchConfig, x: torch.Tensor,
                                   pool: dict, page_table: torch.Tensor,
                                   cur_len, writes: tuple, *,
                                   window: int | None = None,
                                   write: bool = True
                                   ) -> tuple[torch.Tensor, dict]:
    """Chunked cached prefill against a paged pool: the paged sibling of
    :func:`decode_attention_chunked`.

    x: (B, T, d); pool["k"/"v"]: (P, Hkv, page_size, hd) shared by all
    slots; page_table: (B, M) physical page per logical page (-1 =
    unallocated); cur_len: (B,) tokens already cached per slot.
    ``writes`` is :func:`paged_writes`' result for this step: it holds
    the gate (the reference's ``lengths`` for a chunk, ``active`` for
    decode), and padding rows (idle or decoding neighbours) write no
    page.  Paged positions are unique (no wraparound inside a chunk), so
    the chunk's gated K/V is stored first and queries attend the updated
    pages directly through a page-table gather: every key position
    ``<= qp`` is genuinely written, the chunk-causal mask plus "is the
    page live" does the rest.  ``write=False`` (the speculative
    verifier's forward) places the chunk's K/V in the gathered copies
    only and leaves the pool untouched.  Returns (output, pool)."""

    B, T, d = x.shape
    ps = pool["k"].shape[2]
    M = page_table.shape[1]
    dev = x.device
    cur_len = per_slot(cur_len, B, dev)
    pos = cur_len[:, None] + torch.arange(T, device=dev)[None, :]
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    if cfg.use_rope:
        q = rope(q, pos, cfg.rope_theta)
        k_new = rope(k_new, pos, cfg.rope_theta)
    with span("attn.kv"):
        k, v = _paged_kv(pool, page_table, writes, k_new, v_new, write=write)

    kp = torch.arange(M * ps, device=dev)[None, None, :]    # (1, 1, M*ps)
    qp = pos[:, :, None]                                # (B, T, 1)
    mask = (kp <= qp) & pool_validity(page_table, ps)[:, None, :]
    if window is not None:
        mask &= kp >= qp - window + 1
    mask = mask[:, None, None, :, :]                    # (B, 1, 1, T, M*ps)

    with span("attn.core"):
        o = _on_shards(grouped_sdpa, q, k, v, mask,
                       cfg.hd ** -0.5).to(x.dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    return lc(out, "batch", "seq", "embed"), pool


def decode_attention_paged(p: dict, cfg: ArchConfig, x: torch.Tensor,
                           pool: dict, page_table: torch.Tensor, cur_len,
                           writes: tuple, *, window: int | None = None
                           ) -> tuple[torch.Tensor, dict]:
    """One-token attention against a paged pool, writing it in place: the
    paged sibling of :func:`decode_attention`, and the math of
    :func:`decode_attention_chunked_paged` at T = 1.  x: (B, 1, d);
    ``writes`` from :func:`paged_writes` with positions ``cur_len`` and
    the per-slot ``active`` gate.  The token is stored first; then
    :func:`~repro_torch.kernels.paged_decode.paged_decode` reads each
    slot's live pages in place (a slot with no valid key attends to
    nothing and gets zeros)."""

    B = x.shape[0]
    cur_len = per_slot(cur_len, B, x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    if cfg.use_rope:
        q = rope(q, cur_len[:, None], cfg.rope_theta)
        k_new = rope(k_new, cur_len[:, None], cfg.rope_theta)
    with span("attn.kv"):
        _paged_store(pool, writes, k_new, v_new)
    with span("attn.core"):
        o = paged_decode_ops.paged_decode(q, pool["k"], pool["v"],
                                          page_table, cur_len, window=window,
                                          scale=cfg.hd ** -0.5)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    return lc(out, "batch", "seq", "embed"), pool


def decode_cross_attention(p: dict, cfg: ArchConfig, x: torch.Tensor,
                           enc_kv: dict) -> torch.Tensor:
    """Cross attention of x (B, T, d) against precomputed K/V
    (``enc_kv["k"/"v"]``: (B, Hkv, Skv, hd)), every key visible."""

    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(enc_kv["k"], n_rep), _repeat_kv(enc_kv["v"], n_rep)
    mask = torch.ones((1, 1, 1, k.shape[2]), dtype=torch.bool,
                      device=x.device)
    o = _on_shards(_sdpa, q, k, v, mask, cfg.hd ** -0.5)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"])


__all__ = ["attn_specs", "attention", "decode_attention",
           "decode_attention_chunked", "decode_attention_paged",
           "decode_attention_chunked_paged", "kv_cache_specs",
           "kv_pool_specs", "paged_writes", "per_slot",
           "decode_cross_attention", "NEG_INF",
           "Q_CHUNK_THRESHOLD", "Q_CHUNK"]
