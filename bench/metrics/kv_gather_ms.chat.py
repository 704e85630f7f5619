"""Device time a window tick of the attention's ``attn.kv`` ranges in
the decode and prefill phases: every layer's paged K/V write and
page-table gather, timed by CUDA events on the stream."""

from bench.metrics._spans import range_ms_per_tick

LAYER = "attention (models/attention.py)"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(run):
    return range_ms_per_tick(run, "attn.kv")
