"""The yardstick's arithmetic: the chip's published peaks, the model
FLOPs of useful tokens, and each matrix product's operations and bytes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, without
sparsity), stated at the card's full 700 W; a share of them is given
with the card's power limit beside it.
"""

from __future__ import annotations

import math

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
MFU_PEAK = PEAK_FLOPS["bf16"]

_DTYPES = {  # profiler dtype name -> (peak key, bytes an element)
    "c10::BFloat16": ("bf16", 2), "c10::Half": ("fp16", 2),
    "float": ("f32", 4), "double": (None, 8),
}


def attention_flops(dims, keys: int) -> float:
    """Forward FLOPs of one query token's attention over ``keys``
    positions in every layer: Q·K and P·V, 2 FLOPs a multiply-add."""

    return 4.0 * dims.layers * dims.heads * dims.hd * keys


def forward_flops(dims, matmul_params: int, tokens: int,
                  key_sum: int) -> float:
    """2 FLOPs per matrix parameter per token (``launch/roofline.py``'s
    2·N·D, counting only parameters that enter a product), plus attention
    over ``key_sum`` = the keys summed over the tokens."""

    return 2.0 * matmul_params * tokens + attention_flops(dims, key_sum)


def causal_key_sum(start: int, end: int) -> int:
    """Σ (p + 1) for positions p in [start, end): the keys a causal
    token at p attends."""

    return (end * (end + 1) - start * (start + 1)) // 2


def matmul_cost(name: str, shapes, dtypes, tf32: bool):
    """(FLOPs, bytes, peak FLOP/s) of one aten matrix product, or None
    when its dtype or shapes are not ones it knows.  Bytes: each input
    read once and the output written once."""

    mats = [(s, d) for s, d in zip(shapes, dtypes) if s]
    if len(mats) < (3 if name in ("aten::addmm", "aten::baddbmm") else 2):
        return None
    if name in ("aten::mm", "aten::bmm"):
        (a, da), (b, db) = mats[0], mats[1]
        bias = None
    elif name in ("aten::addmm", "aten::baddbmm"):
        (bias, _), (a, da), (b, db) = mats[0], mats[1], mats[2]
    else:
        return None
    kind = _DTYPES.get(da)
    if kind is None or kind[0] is None or _DTYPES.get(db) != kind:
        return None
    peak_key, size = kind
    if peak_key == "f32" and tf32:
        peak_key = "tf32"
    if len(a) == 2 and len(b) == 2:
        batch, (m, k), n = 1, a, b[1]
    elif len(a) == 3 and len(b) == 3:
        batch, m, k, n = a[0], a[1], a[2], b[2]
    else:
        return None
    flops = 2.0 * batch * m * n * k
    nbytes = size * (batch * m * k + math.prod(b) + batch * m * n)
    if bias is not None:
        nbytes += size * math.prod(bias)
    return flops, nbytes, PEAK_FLOPS[peak_key]


def matmul_roofline(ops, tf32: bool):
    """Σ ideal times ÷ Σ device times over ``ops`` ((name, shapes,
    dtypes, device seconds)), as a percentage; None when no op could be
    priced or none took device time.  An op's ideal time is the larger of
    its FLOPs over the peak of its dtype and its bytes over the HBM
    bandwidth."""

    ideal = spent = 0.0
    for name, shapes, dtypes, dev_s in ops:
        cost = matmul_cost(name, shapes, dtypes, tf32)
        if cost is None or dev_s <= 0:
            continue
        flops, nbytes, peak = cost
        ideal += max(flops / peak, nbytes / HBM_BYTES_PER_S)
        spent += dev_s
    if spent <= 0:
        return None
    return 100.0 * ideal / spent


__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "MFU_PEAK", "attention_flops",
           "forward_flops", "causal_key_sum", "matmul_cost",
           "matmul_roofline"]
