"""Device kernels launched per ``Server.tick`` in the profiled slice:
the host's dispatch work a tick, whatever the kernels' size."""

LAYER = "Server tick (runtime/serve.py)"
UNIT = "launches"
MOVES = "itl_p95_ms"


def read(run):
    sl = run.slice
    if sl is None or sl.busy_s is None or not sl.units:
        return None
    return sl.kernels / sl.units
