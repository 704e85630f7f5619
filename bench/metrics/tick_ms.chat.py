"""Mean host time of one ``Server.tick`` over the traced run's window:
the window's length ÷ the ticks the Server counted in it."""

LAYER = "Server tick (runtime/serve.py)"
UNIT = "ms"
MOVES = "serve_tokens_per_s"


def read(run):
    ticks = run.counters.get("ticks")
    if not ticks or not run.window_s:
        return None
    return 1e3 * run.window_s / ticks
