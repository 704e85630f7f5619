"""Host time a window tick of the Server's ``serve.dispatch`` ranges in
the decode and prefill phases: the call of ``decode_step`` and
``prefill_step``, which launches the step's kernels (the readback after
it, which waits for them, is outside)."""

from bench.metrics._spans import range_ms_per_tick

LAYER = "Server tick (runtime/serve.py)"
UNIT = "ms"
MOVES = "itl_p95_ms"


def read(run):
    return range_ms_per_tick(run, "serve.dispatch")
