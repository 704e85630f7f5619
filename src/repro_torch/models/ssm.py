"""Mamba2 SSD (state-space duality) block (the port's copy of
``repro.models.ssm``): chunked scan for full sequences, O(1) recurrence
for serving.

The minimal SSD form of arXiv:2405.21060: scalar decay per head (A),
shared B/C projections (ngroups=1), a short causal depthwise conv on
(x, B, C), gated output.  :func:`ssd_chunked` does quadratic
attention-like math within chunks of ``cfg.ssm.chunk`` tokens and
carries the (heads, state, headdim) state across chunks in a Python loop
(the reference's ``lax.scan``), in f32.

Serving keeps a per-slot recurrent state ``h`` (B, H, N, P), f32
whatever the params' dtype, and a conv ring of the last W-1 conv inputs.
Unlike the reference, whose steps return a new state, the serving steps
here write it IN PLACE, and only where they are gated: the slots that
``active`` marks (decode) or the tokens that ``valid`` marks (a chunk).
``F.softplus`` returns its input above 20 where ``jax.nn.softplus``
returns ``x + log1p(exp(-x))``; the difference is below 2.1e-9, under
half an f32 ulp of any x > 20, so in f32 (dt is always f32 here) the two
give the same value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distribute.sharding import current_ctx, grad_partials, pinned
from ..distribute.sharding import logical_constraint as lc
from .common import DEFAULT_DTYPE, PSpec


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.headdim
    return di, nh, s.headdim, s.state, s.conv_width


def ssm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di, nh, P, N, W = _dims(cfg)
    conv_ch = di + 2 * N
    return {
        "w_in": PSpec((d, 2 * di + 2 * N + nh), ("embed", "mlp")),
        "conv_w": PSpec((W, conv_ch), (None, "mlp"), scale=0.5),
        "conv_b": PSpec((conv_ch,), ("mlp",), init="zeros"),
        "a_log": PSpec((nh,), ("heads",), init="zeros"),
        "dt_bias": PSpec((nh,), ("heads",), init="zeros"),
        "D": PSpec((nh,), ("heads",), init="ones"),
        "w_out": PSpec((di, d), ("mlp", "embed")),
    }


def _split_in(cfg: ArchConfig, proj: torch.Tensor):
    """(z, x, B, C, dt) of the input projection."""

    di, nh, P, N, _ = _dims(cfg)
    return torch.split(proj, [di, di, N, N, nh], dim=-1)


def _depthwise(hist: torch.Tensor, w: torch.Tensor,
               pad: int = 0) -> torch.Tensor:
    """Depthwise correlation of (B, L, C), with ``pad`` zero rows put
    before it, with a (W, C) kernel over its valid positions:
    (B, pad + L - W + 1, C).  Both packages correlate (no flip):
    out[t, c] = sum_w hist[t + w, c] * w[w, c]."""

    def conv(hist, w):
        if pad:
            hist = F.pad(hist, (0, 0, pad, 0))
        out = F.conv1d(hist.transpose(1, 2), w.t()[:, None, :],
                       groups=w.shape[1])
        return out.transpose(1, 2)

    ctx = current_ctx()
    if ctx is None or not _is_dtensor(hist):
        return conv(hist, w)
    # local_map region: hist (B, L, C) and the output over the batch
    # rule's mesh dims, L and C whole, the (W, C) kernel whole: DTensor's
    # convolution has no depthwise (grouped) strategy, and torch 2.11's
    # planner fails on the pad of a sharded input
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    ph = ctx.placements(("batch", None, None), tuple(hist.shape))
    pw = (Replicate(),) * len(ph)
    return local_map(conv, out_placements=list(ph), in_placements=(ph, pw),
                     in_grad_placements=grad_partials((ph, pw), ph),
                     device_mesh=hist.device_mesh,
                     redistribute_inputs=True)(hist, w)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C): one
    ``conv1d(groups=C)`` over the input padded W-1 on the left."""

    return F.silu(_depthwise(x, w, pad=w.shape[0] - 1) + b)


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A two-operand einsum in the operands' dtype, returned in f32 (the
    reference's ``preferred_element_type=f32``)."""

    return torch.einsum(eq, a, b).float()


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                compute_dtype=torch.float32) -> torch.Tensor:
    """SSD over chunks.  x: (B,S,H,P), dt: (B,S,H), A: (H,) negative,
    Bm/Cm: (B,S,N).  Returns y: (B,S,H,P) in f32.

    ``compute_dtype`` is the dtype of the O(S·Q) intra-chunk tensors;
    decays and cumsums stay f32, then cast, as in the reference."""

    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    S_orig = S
    if S % Q:                    # pad the tail: dt = 0 tokens are inert
        pad = Q - S % Q          # (decay 1, no state contribution)
        padf = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        x, dt, Bm, Cm = padf(x), padf(dt), padf(Bm), padf(Cm)
        S = S + pad
    nc = S // Q

    r = lambda t: t.reshape(Bsz, nc, Q, *t.shape[2:])
    x, dt, Bm, Cm = r(x), r(dt), r(Bm), r(Cm)

    dA = dt * A[None, None, None, :]                     # (B,nc,Q,H)
    seg = torch.cumsum(dA, dim=2)                        # within-chunk
    total = seg[:, :, -1, :]                             # (B,nc,H)

    cd = compute_dtype
    xc = x.to(cd)
    # intra-chunk: y_ij = C_i . B_j * exp(seg_i - seg_j) * dt_j
    decay = torch.exp(seg[:, :, :, None, :] - seg[:, :, None, :, :])
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    decay = torch.where(mask, decay, 0.0).to(cd)         # (B,nc,Q,Q,H)
    cb = _einsum_f32("bcqn,bckn->bcqk", Cm.to(cd), Bm.to(cd))
    w_qk = cb.to(cd)[..., None] * decay * dt.to(cd)[:, :, None]
    y_diag = _einsum_f32("bcqkh,bckhp->bcqhp", w_qk, xc)

    # chunk states: S_c = sum_j exp(total - seg_j) * dt_j * B_j x_j
    sdecay = torch.exp(total[:, :, None, :] - seg)       # (B,nc,Q,H)
    u = (sdecay * dt).to(cd)[..., None] * xc             # (B,nc,Q,H,P)
    states = _einsum_f32("bcqn,bcqhp->bchnp", Bm.to(cd), u)

    # inter-chunk recurrence, the state carried in f32; each chunk sees
    # the state BEFORE it
    h = torch.zeros((Bsz, H, Bm.shape[-1], P), dtype=torch.float32,
                    device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                  # (B,nc,H,N,P)

    # the carried state's contribution: y += C_i . h_prev * exp(seg_i)
    ch = _einsum_f32("bcqn,bchnp->bcqhp", Cm.to(cd), h_prev.to(cd))
    y_off = ch * torch.exp(seg)[..., None]
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y[:, :S_orig]


def _ssd_on_shards(x, dt, A, Bm, Cm, chunk: int, cd) -> torch.Tensor:
    """:func:`ssd_chunked`; on DTensors, on each rank's shard.

    local_map region: x (B, S, H, P) and the output placed by ("batch",
    None, "heads", None), dt (B, S, H) by ("batch", None, "heads"), A (H,)
    by ("heads",), Bm and Cm (B, S, N) by ("batch", None, None): the scan
    is independent per (batch row, head), so a shard's is exact, and its
    chunked products need no sharding strategy."""

    ctx = current_ctx()
    if ctx is None or not _is_dtensor(x):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk, compute_dtype=cd)
    from torch.distributed.tensor.experimental import local_map
    px = ctx.placements(("batch", None, "heads", None), tuple(x.shape))
    pd = ctx.placements(("batch", None, "heads"), tuple(dt.shape))
    pa = ctx.placements(("heads",), tuple(A.shape))
    pb = ctx.placements(("batch", None, None), tuple(Bm.shape))

    def run(x, dt, A, Bm, Cm):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk, compute_dtype=cd)

    pin = (px, pd, pa, pb, pb)
    return local_map(run, out_placements=list(px), in_placements=pin,
                     in_grad_placements=grad_partials(pin, px),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, dt, A, Bm, Cm)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _on_heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """``t`` (B, S, nh · P), the channels of ``nh`` heads, placed as its
    (B, S, nh) head view ("batch", "seq", "heads"): where the model axis
    does not divide ``nh`` (hymba: 50 heads on a 16-way axis) the
    channels are whole on it, so that neither the head split nor the
    merge, nor their backwards, meets an uneven shard."""

    return pinned(t, ("batch", "seq", "heads"), (*t.shape[:-1], nh))


def _heads_left_whole(nh: int) -> bool:
    """Whether the active mesh leaves ``nh`` heads whole on an axis the
    rules shard "heads" over (their count does not divide it)."""

    ctx = current_ctx()
    if ctx is None:
        return False
    from ..distribute.sharding import spec_placements
    return ctx.placements(("heads",), (nh,)) != spec_placements(
        ctx.rules.spec(("heads",)), ctx.mesh)


def ssm_forward(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block. x: (B,S,d) -> (B,S,d)."""

    di, nh, P, N, W = _dims(cfg)
    proj = x @ p["w_in"]
    if _heads_left_whole(nh):
        # whole channels before the split: its backward concatenates the
        # pieces' gradients, which DTensor otherwise shards over the
        # sequence, and the weight's gradient cannot take that layout
        proj = pinned(proj, ("batch", "seq", None))
    z, xin, Bm, Cm, dt = _split_in(cfg, proj)
    conv_out = _causal_conv(torch.cat([xin, Bm, Cm], dim=-1), p["conv_w"],
                            p["conv_b"])
    xin, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    # SSD heads over the model axis: the (B, nc, Q, Q, H) decay tensor is
    # the memory hot-spot and follows these constraints
    xin = _on_heads(xin, nh)
    xh = lc(xin.reshape(*xin.shape[:2], nh, P), "batch", "seq", "heads",
            None)
    dt = lc(dt, "batch", "seq", "heads")
    cd = getattr(torch, cfg.ssd_dtype)
    y = _ssd_on_shards(xh.to(cd), dt, A, Bm.to(cd), Cm.to(cd),
                       cfg.ssm.chunk, cd)
    y = lc(y, "batch", "seq", "heads", None)
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = _on_heads(y.reshape(*xin.shape[:2], di), nh).to(x.dtype)
    y = y * F.silu(z)
    return lc(y @ p["w_out"], "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# O(1) recurrence (serving)
# ---------------------------------------------------------------------------


def ssm_state_specs(cfg: ArchConfig, batch: int, dtype=None) -> dict:
    """One block's recurrent state: ``h`` in f32 whatever the params'
    dtype (its error compounds over the whole sequence), the conv ring in
    the params' dtype."""

    di, nh, P, N, W = _dims(cfg)
    conv_ch = di + 2 * N
    dt = dtype if dtype is not None else DEFAULT_DTYPE
    return {
        "h": PSpec((batch, nh, N, P), ("cache_batch", "heads", None, None),
                   init="zeros", dtype=torch.float32),
        "conv": PSpec((batch, W - 1, conv_ch), ("cache_batch", None, "mlp"),
                      init="zeros", dtype=dt),
    }


def _recurrent(p: dict, cfg: ArchConfig, x: torch.Tensor, state: dict,
               valid: torch.Tensor | None, write: bool) -> torch.Tensor:
    """T tokens of x (B, T, d) through the recurrence, token by token, as
    the reference's scan of one-token steps.  ``valid`` ((B, T) bool, a
    prefix of each row; None = all) gates the state: an invalid token
    leaves (h, conv) as they were.  The per-token projections and the
    conv are computed for the whole chunk at once (a valid token's conv
    window holds only the ring and earlier valid tokens); only the
    ``h`` update runs in the loop.  With ``write``, the final (h, conv)
    are copied into ``state`` in place; without, ``state`` is only read.
    Returns y (B, T, d)."""

    di, nh, P, N, W = _dims(cfg)
    B, T, _ = x.shape
    z, xin, Bm, Cm, dt = _split_in(cfg, x @ p["w_in"])
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)              # (B, T, C)
    hist = torch.cat([state["conv"], conv_in], dim=1)       # (B, W-1+T, C)
    conv_out = F.silu(_depthwise(hist, p["conv_w"]) + p["conv_b"])
    xin, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())      # (B, T, H)
    A = -torch.exp(p["a_log"].float())
    dt = lc(dt, "batch", "seq", "heads")
    xh = _on_heads(xin, nh).reshape(B, T, nh, P).float()
    decay = torch.exp(dt * A)                               # (B, T, H)
    u = dt[..., None] * xh                                  # (B, T, H, P)
    Bf, Cf = Bm.float(), Cm.float()
    h = state["h"]
    ys = []
    for t in range(T):
        h_new = h * decay[:, t, :, None, None] + \
            Bf[:, t, None, :, None] * u[:, t, :, None, :]
        h = h_new if valid is None else torch.where(
            valid[:, t, None, None, None], h_new, h)
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h_new))
    y = torch.stack(ys, dim=1)                              # (B, T, H, P)
    y = y + p["D"].float()[None, None, :, None] * xh
    y = _on_heads(y.reshape(B, T, di), nh).to(x.dtype) * F.silu(z)
    if write:
        # the ring after a slot's valid tokens: the W-1 history rows that
        # end at its last valid token (all T when ungated)
        n = (torch.full((B,), T, device=x.device) if valid is None
             else valid.sum(dim=1))
        rows = n[:, None] + torch.arange(W - 1, device=x.device)[None, :]
        state["conv"].copy_(torch.take_along_dim(hist, rows[..., None],
                                                 dim=1))
        state["h"].copy_(h)
    return y @ p["w_out"]


def ssm_decode_step(p: dict, cfg: ArchConfig, x: torch.Tensor, state: dict,
                    active: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
    """One-token SSD step, x: (B, 1, d), writing ``state`` in place for
    the slots that ``active`` ((B,) bool, default all) marks.  Returns
    (y (B, 1, d), state)."""

    valid = None if active is None else active[:, None]
    return _recurrent(p, cfg, x, state, valid, write=True), state


def ssm_prefill_step(p: dict, cfg: ArchConfig, x: torch.Tensor, state: dict,
                     valid: torch.Tensor, *, write: bool = True
                     ) -> tuple[torch.Tensor, dict]:
    """Advance a chunk of T tokens through the recurrence.  x: (B, T, d);
    valid: (B, T), the tokens each slot really holds (a prefix): padding
    tokens leave (h, conv) untouched.  ``write=False`` (the speculative
    verifier's forward) leaves ``state`` untouched.  Returns (y (B, T,
    d), state)."""

    return _recurrent(p, cfg, x, state, valid, write=write), state


__all__ = ["ssm_specs", "ssm_forward", "ssm_state_specs", "ssm_decode_step",
           "ssm_prefill_step", "ssd_chunked"]
