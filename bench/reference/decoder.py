"""A plain dense decoder in float32: the yardstick the benchmark holds the
program's outputs to.

Pre-norm blocks of RMSNorm, attention with optional QKV bias, rotary
positions on the two halves of each head (the Llama and Qwen convention)
and grouped K/V heads, then a SwiGLU MLP; a final RMSNorm and logits
through the unembedding, or the embedding itself when tied.  Weights are
the flat, layer-stacked dict of ``bench/model.py``: they are read, never
written, and upcast to float32 one layer at a time.

Everything runs in float32 with TF32 off (:func:`exact_f32`).  With
``fp8=True`` each linear layer's two operands are rounded to float8
e4m3 under one scale per tensor before an f32 product: the control, the
reference at the precision below the configuration's bfloat16.

It imports nothing but torch.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored on exit."""

    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448), back in float32."""

    x = x.detach()
    scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _ste(x: torch.Tensor) -> torch.Tensor:
    """fp8-rounded ``x`` whose gradient passes straight through."""

    return x + (fp8_round(x) - x).detach()


class Layer:
    """One block's weights in float32 (a view of layer ``i`` upcast)."""

    def __init__(self, weights: dict, i: int, fp8: bool = False):
        self.w = {k.split(".", 1)[1]: v[i].float()
                  for k, v in weights.items() if k.startswith("layers.")}
        if fp8:
            for k in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
                self.w[k] = fp8_round(self.w[k])
        self.fp8 = fp8


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (H, S, hd), pos: (S,)."""

    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (..., din) against w (din, ...out dims)."""

    if fp8:
        x = _ste(x)
    return (x.reshape(-1, x.shape[-1]) @ w.reshape(w.shape[0], -1)
            ).reshape(*x.shape[:-1], *w.shape[1:])


def block(x: torch.Tensor, lw: Layer, dims) -> torch.Tensor:
    """One pre-norm block over one sequence x (S, d), positions 0..S-1."""

    w, fp8 = lw.w, lw.fp8
    S = x.shape[0]
    pos = torch.arange(S, device=x.device)
    h = rms_norm(x, w["ln1"], dims.eps)
    q = linear(h, w["wq"], fp8)                     # (S, H, hd)
    k = linear(h, w["wk"], fp8)
    v = linear(h, w["wv"], fp8)
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))  # (H, S, hd)
    q, k = rope(q, pos, dims.rope_theta), rope(k, pos, dims.rope_theta)
    rep = dims.heads // dims.kv_heads
    k, v = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
    s = (q @ k.transpose(1, 2)) * dims.hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).transpose(0, 1)    # (S, H, hd)
    x = x + linear(o.reshape(S, -1), w["wo"].reshape(-1, dims.d), fp8)
    h = rms_norm(x, w["ln2"], dims.eps)
    m = F.silu(linear(h, w["wg"], fp8)) * linear(h, w["wu"], fp8)
    return x + linear(m, w["wd"], fp8)


def unembedding(weights: dict, dims, fp8: bool = False) -> torch.Tensor:
    """(d, V) float32."""

    u = weights["embed"].float().t() if dims.tied else \
        weights["unembed"].float()
    return fp8_round(u) if fp8 else u


def hidden(weights: dict, dims, seqs: list[torch.Tensor],
           fp8: bool = False) -> list[torch.Tensor]:
    """Each token sequence's final-normed hidden states (S, d), layer by
    layer over all sequences, so that one layer's f32 weights live at a
    time."""

    emb = weights["embed"]
    xs = [emb[t.long()].float() for t in seqs]
    for i in range(dims.layers):
        lw = Layer(weights, i, fp8)
        xs = [block(x, lw, dims) for x in xs]
        del lw
    ln_f = weights["ln_f"].float()
    return [rms_norm(x, ln_f, dims.eps) for x in xs]


def logits_at(weights: dict, dims, seqs: list[torch.Tensor],
              rows: list[torch.Tensor], fp8: bool = False,
              block_rows: int = 256):
    """For each sequence, the logits (len(rows), V) at positions
    ``rows`` (a LongTensor), in blocks of ``block_rows`` positions;
    yields (sequence index, first row, logits block)."""

    hs = hidden(weights, dims, seqs, fp8)
    u = unembedding(weights, dims, fp8)
    for i, (h, r) in enumerate(zip(hs, rows)):
        sel = h[r]
        for j in range(0, sel.shape[0], block_rows):
            yield i, j, linear(sel[j:j + block_rows], u, fp8)


class _GradLayer(Layer):
    """Layer ``i`` of float32 params, sliced so gradients flow back."""

    def __init__(self, params: dict, i: int, fp8: bool = False):
        self.w = {k.split(".", 1)[1]: v[i] for k, v in params.items()
                  if k.startswith("layers.")}
        if fp8:
            for k in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
                self.w[k] = _ste(self.w[k])
        self.fp8 = fp8


def loss(params: dict, dims, tokens: torch.Tensor,
         fp8: bool = False) -> torch.Tensor:
    """Summed next-token cross entropy of the rows of ``tokens`` (R, S)
    over positions 0..S-2; ``params`` is the flat dict in float32 (leaves
    that may require grad).  ``fp8`` rounds every linear layer's
    operands, the gradient passing straight through the rounding."""

    emb = params["embed"]
    u = emb.t() if dims.tied else params["unembed"]
    if fp8:
        u = _ste(u)
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for row in tokens:
        x = emb[row.long()]
        for i in range(dims.layers):
            x = block(x, _GradLayer(params, i, fp8), dims)
        x = rms_norm(x, params["ln_f"], dims.eps)
        lg = linear(x[:-1], u, fp8)
        total = total + F.cross_entropy(lg, row[1:].long(), reduction="sum")
    return total


__all__ = ["exact_f32", "fp8_round", "hidden", "logits_at", "loss",
           "rms_norm", "rope"]
