"""Share of the profiled slice in which no kernel or copy ran on the
device: 1 - the union of their intervals ÷ the slice's wall time."""

LAYER = "device"
UNIT = "%"
MOVES = "serve_tokens_per_s"


def read(run):
    sl = run.slice
    if sl is None or sl.busy_s is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
