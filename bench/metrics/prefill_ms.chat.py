"""Mean synchronised time of a tick's prefill phase (the ``Server``'s
``prefill`` phase span from ``obs.profile``; one ``prefill_step`` of
every prefilling slot, padded to the slots and the chunk)."""

LAYER = "model step (models/api.py prefill_step, decode_step)"
UNIT = "ms"
MOVES = "ttft_p90_ms"


def read(run):
    phase = run.spans.get("prefill")
    if not phase or not phase["count"]:
        return None
    return phase["mean_us"] / 1e3
