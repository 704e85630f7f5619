"""Device time a window tick of the attention's ``attn.core`` ranges in
the decode and prefill phases: every layer's upcast, scores, mask,
softmax and values over the gathered K/V, timed by CUDA events on the
stream."""

from bench.metrics._spans import range_ms_per_tick

LAYER = "attention (models/attention.py)"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(run):
    return range_ms_per_tick(run, "attn.core")
