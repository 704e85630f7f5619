"""Model FLOPs of the useful tokens the window served (every position
forwarded past a shared prefix, attention over its real keys, one
unembedding a served token; padding counts for nothing) ÷ (window ×
989 TFLOP/s, the H100's bf16 peak at 700 W)."""

from bench.flops import MFU_PEAK

LAYER = "whole step"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(run):
    work = run.counters.get("useful_flops")
    if not work or not run.window_s or run.device.type != "cuda":
        return None
    return 100.0 * work / (run.window_s * MFU_PEAK)
