"""The attention's share of its roofline over the live keys: Σ over the
decode and prefill phases of the least time of what they had to do (the
larger of the live K/V's bytes, ``kv_tokens`` × layers × 2 × kv heads ×
head size × the dtype's size, over the HBM bandwidth, and the real
query-key pairs' FLOPs, ``qk_pairs``, over the bf16 peak) ÷ Σ the device
time of their ``attn.kv`` and ``attn.core`` ranges."""

from bench import model
from bench.flops import HBM_BYTES_PER_S, MFU_PEAK, attention_flops
from bench.metrics._spans import step_phases

LAYER = "attention (models/attention.py)"
UNIT = "%"
MOVES = "itl_p95_ms"


def read(run):
    dims = model.Dims.of(run.conf)
    size = model.dtype_of(run.conf).itemsize
    ideal = spent = 0.0
    for e in step_phases(run):
        r = e.get("ranges", {})
        us = sum(r[n]["total_us"] for n in ("attn.kv", "attn.core")
                 if n in r)
        if us <= 0:
            continue
        kv_bytes = (e["kv_tokens"] * dims.layers * 2 * dims.kv_heads *
                    dims.hd * size)
        ideal += max(kv_bytes / HBM_BYTES_PER_S,
                     attention_flops(dims, e["qk_pairs"]) / MFU_PEAK)
        spent += us / 1e6
    if spent <= 0:
        return None
    return 100.0 * ideal / spent
