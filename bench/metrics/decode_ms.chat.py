"""Mean synchronised time of a tick's decode phase (the ``Server``'s
``decode`` phase span from ``obs.profile``; one ``decode_step`` over
every slot)."""

LAYER = "model step (models/api.py prefill_step, decode_step)"
UNIT = "ms"
MOVES = "itl_p95_ms"


def read(run):
    phase = run.spans.get("decode")
    if not phase or not phase["count"]:
        return None
    return phase["mean_us"] / 1e3
