"""Share of the positions the window's prefill steps computed that held
a chunk token: ``tokens`` ÷ ``positions`` (every slot's row × the chunk,
which the padded step computes) of the Server's prefill phase."""

LAYER = "Server tick (runtime/serve.py)"
UNIT = "%"
MOVES = "ttft_p90_ms"


def read(run):
    phase = run.spans.get("prefill") or {}
    if run.device.type != "cuda" or not phase.get("positions"):
        return None
    return 100.0 * phase["tokens"] / phase["positions"]
