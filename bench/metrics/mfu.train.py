"""Model FLOPs of the steps the window completed (3 × the forward:
2 a matrix parameter a token, the unembedding at each predicted
position, causal attention) ÷ (window × 989 TFLOP/s, the H100's bf16
peak at 700 W)."""

from bench.flops import MFU_PEAK

LAYER = "whole step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(run):
    work = run.counters.get("useful_flops")
    if not work or not run.window_s or run.device.type != "cuda":
        return None
    return 100.0 * work / (run.window_s * MFU_PEAK)
