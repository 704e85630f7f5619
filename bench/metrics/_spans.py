"""What the chat metrics read of the program's own ranges and counters:
``run.spans``, the Server's phase profile over the traced window
(``repro_torch.obs.profile``), whose ``decode`` and ``prefill`` entries
hold ``ranges`` (``{name: {total_us, count}}``) and counters.  Device
numbers only: off a CUDA device every reader returns None."""

STEP_PHASES = ("decode", "prefill")


def step_phases(run) -> list[dict]:
    """The decode and prefill entries of a CUDA run's profile (none off
    the card or without them)."""

    if run.device.type != "cuda":
        return []
    return [run.spans[p] for p in STEP_PHASES if p in run.spans]


def range_ms_per_tick(run, name: str):
    """Milliseconds of range ``name`` in the decode and prefill phases,
    a window tick."""

    ticks = run.counters.get("ticks")
    found = [e["ranges"][name] for e in step_phases(run)
             if name in e.get("ranges", {})]
    if not found or not ticks:
        return None
    return sum(r["total_us"] for r in found) / 1e3 / ticks
