"""Per-tick phase profiling with device sync (the port's copy of
``repro.obs.profile``).

The serving tick interleaves device work (decode step, verify chunk,
commit/prefill step, COW page copies) with host-side work (admission,
draft proposal, bookkeeping).  Kernels launch asynchronously, so a host
clock around a phase measures its launches, not its device work: when
profiling is on, the engine hands each phase's tensors to
:meth:`PhaseProfiler.phase_end`, and the profiler synchronizes EVERY
CUDA device among them (``torch.cuda.synchronize(d)``, not only the
current stream) inside the timed region.  Without that sync the next
phase's time would absorb this one's device work.  The residual between
a tick's wall time and its summed phase times is attributed to ``host``
(scheduling, drafting, bookkeeping).  CPU tensors need no sync.

Syncing per phase serializes the tick's launch overlap, so a profiled
drain is slower than a traced-only drain: profiling is a diagnosis mode
(``--profile``), never on by default.  ``warmup_ticks`` excludes the
first ticks from the totals.

:func:`span` names a range of the program where its work happens (the
Server's admission and dispatch, the attention's KV gather and core).
While a ``torch.profiler`` records, the range is a ``record_function``,
so the profiler's trace names it; while a profiler's tick is open, the
range is timed into the report: inside a phase into that phase's entry,
outside any phase into ``host``'s, under ``ranges[name]`` as
``{total_us, count}``.  A ``"device"`` range inside a phase on a CUDA
device is timed by a pair of CUDA events on the phase's stream, read
once the phase has synced: while the next phase's step runs, or by
:meth:`PhaseProfiler.report`; every other range on the host clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import torch

# is a torch profiler recording?  One C call, where an unguarded
# ``record_function`` costs ~16 us even with no profiler on
_recording = torch._C._autograd._profiler_enabled

# The profiler whose tick is open, for the ranges that the model's
# layers open with no profiler in reach; set by ``tick_begin`` and
# cleared when the tick ends, so it is None between ticks.
_open: "PhaseProfiler | None" = None

_OFF = contextlib.nullcontext()


class _Range:
    """An open :func:`span`: its ``record_function`` and its clock."""

    __slots__ = ("name", "clock", "prof", "rf", "into", "t0")

    def __init__(self, name: str, clock: str | None, prof):
        self.name, self.clock, self.prof = name, clock, prof

    def __enter__(self):
        self.rf = None
        if _recording():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.into = None
        prof = self.prof
        if prof is not None and self.clock is not None:
            self.into, self.t0 = prof._range_begin(self.clock)
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            self.into.append((self.name, self.t0,
                              self.prof._range_end(self.t0)))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, clock: str | None = "device"):
    """``with span(name):`` around a range of the program's work.

    ``clock``: ``"device"`` (the device stream's time inside a phase),
    ``"host"`` (the host clock's) or None (named in a profiler's trace,
    never timed: a range that a phase's own time already covers).  With
    no profiler recording and no tick open it costs one flag read and
    one C call."""

    if _open is None and not _recording():
        return _OFF
    return _Range(name, clock, _open)


def _cuda_devices(tree: Any, out: set) -> set:
    """The CUDA devices of every tensor in a nested dict/list/tuple."""

    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def sync_devices(tree: Any) -> None:
    """Wait for all work on each CUDA device that holds a tensor of
    ``tree``; a no-op for CPU tensors."""

    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)


class PhaseProfiler:
    """Accumulates synchronized per-phase durations across ticks."""

    def __init__(self, warmup_ticks: int = 1):
        self.warmup_ticks = warmup_ticks
        self.ticks = 0
        self.totals_us: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        # per phase: its ranges' [total_us, count], and its counters
        self.ranges: dict[str, dict[str, list]] = {}
        self.counters: dict[str, dict[str, int]] = {}
        self._tick_t0: float | None = None
        self._tick_phase_us = 0.0
        self._cuda = False
        self._tick_ranges: list = []        # (name, start, end) in host
        self._phase_ranges: list | None = None  # None: no phase open
        self._events: list = []             # CUDA events free for reuse
        self._unread: list = []             # (phase, its event ranges)
        self._stream = None                 # the phase's CUDA stream

    # -- tick bracket ------------------------------------------------------

    def tick_begin(self, device=None) -> None:
        """Open a tick; ranges on ``device`` (a CUDA one) are timed by
        events, on any other by the host clock."""

        global _open
        self._tick_t0 = time.perf_counter()
        self._tick_phase_us = 0.0
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._tick_ranges = []
        self._phase_ranges = None
        _open = self

    def tick_cancel(self) -> None:
        """Drop an open tick that did no work: it counts nothing."""

        self._tick_t0 = None
        self._close()

    def tick_end(self) -> None:
        if self._tick_t0 is None:
            return
        wall_us = (time.perf_counter() - self._tick_t0) * 1e6
        self._tick_t0 = None
        self.ticks += 1
        ranges = self._close()
        if self.ticks <= self.warmup_ticks:
            return
        host = max(0.0, wall_us - self._tick_phase_us)
        self.totals_us["host"] = self.totals_us.get("host", 0.0) + host
        self.counts["host"] = self.counts.get("host", 0) + 1
        self._add_ranges("host", ranges)

    def _close(self) -> list:
        global _open
        if _open is self:
            _open = None
        ranges, self._tick_ranges = self._tick_ranges, []
        return ranges

    # -- phases ------------------------------------------------------------

    def phase_begin(self) -> float:
        self._phase_ranges = []
        # looked up once a phase: ``Event.record()`` without a stream
        # builds the current one anew, ~10 us a record on an H100 host
        self._stream = torch.cuda.current_stream() if self._cuda else None
        return time.perf_counter()

    def phase_end(self, name: str, t0: float, sync=None,
                  counts: dict[str, int] | None = None) -> float:
        """Close a phase opened by :meth:`phase_begin`; the devices of
        ``sync`` (a nested dict/list/tuple of tensors) are synchronized
        before the clock is read, so the duration covers the device work
        the phase launched.  ``counts`` are added to the phase's
        counters."""

        if sync is not None:
            sync_devices(sync)
        dur_us = (time.perf_counter() - t0) * 1e6
        self._tick_phase_us += dur_us
        ranges, self._phase_ranges = self._phase_ranges or [], None
        if self.ticks < self.warmup_ticks:
            ranges = []
        else:
            self.totals_us[name] = self.totals_us.get(name, 0.0) + dur_us
            self.counts[name] = self.counts.get(name, 0) + 1
            if counts:
                mine = self.counters.setdefault(name, {})
                for k, v in counts.items():
                    mine[k] = mine.get(k, 0) + int(v)
        self._unread.append((name, ranges))
        if not self._cuda:
            self._read()
        return dur_us

    # -- ranges (see span) -------------------------------------------------

    # Ranges read the host clock in integer ns (``perf_counter_ns``): a
    # clock apart from the ``perf_counter`` of the ticks and phases, so
    # that a stand-in for that one (a test's stepped clock) is advanced
    # by the ticks and phases alone, however many ranges a tick holds.

    def _range_begin(self, clock: str):
        """(the list the range goes into, its start)"""

        if self._phase_ranges is None:
            return self._tick_ranges, time.perf_counter_ns()
        if clock == "device" and self._cuda:
            return self._phase_ranges, self._record()
        return self._phase_ranges, time.perf_counter_ns()

    def _range_end(self, start):
        if isinstance(start, int):
            end = time.perf_counter_ns()
            if self._unread and self._phase_ranges is not None:
                # a host range closing inside a phase (the Server's
                # dispatch): the device still works through the step it
                # queued, so the host reads the closed phases' events in
                # time it would spend waiting for the step's results
                self._read()
            return end
        return self._record()

    def _record(self):
        ev = self._events.pop() if self._events else \
            torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def _read(self) -> None:
        """Add the ranges of the closed phases to their entries, and
        free their events for reuse."""

        for phase, ranges in self._unread:
            self._add_ranges(phase, ranges)
            for _, a, b in ranges:
                if isinstance(a, torch.cuda.Event):
                    self._events += (a, b)
        self._unread = []

    def _add_ranges(self, phase: str, ranges: list) -> None:
        if not ranges:
            return
        last = ranges[-1][2]
        if isinstance(last, torch.cuda.Event):
            last.synchronize()      # the stream's order: every range done
        mine = self.ranges.setdefault(phase, {})
        for name, a, b in ranges:
            us = (a.elapsed_time(b) * 1e3 if isinstance(a, torch.cuda.Event)
                  else (b - a) / 1e3)
            acc = mine.setdefault(name, [0.0, 0])
            acc[0] += us
            acc[1] += 1

    # -- results -----------------------------------------------------------

    def report(self) -> dict[str, dict[str, Any]]:
        """Per-phase ``{total_us, count, mean_us, share}`` (share of the
        summed phase time, warmup excluded), with the phase's counters
        beside them and, where any range was timed in it, ``ranges``:
        ``{name: {total_us, count}}``."""

        self._read()
        grand = sum(self.totals_us.values())
        out: dict[str, dict[str, Any]] = {}
        for name in sorted(self.totals_us,
                           key=lambda n: -self.totals_us[n]):
            tot, cnt = self.totals_us[name], self.counts.get(name, 0)
            out[name] = {"total_us": tot, "count": float(cnt),
                         "mean_us": tot / cnt if cnt else 0.0,
                         "share": tot / grand if grand else 0.0,
                         **self.counters.get(name, {})}
            if name in self.ranges:
                out[name]["ranges"] = {
                    r: {"total_us": t, "count": float(c)}
                    for r, (t, c) in self.ranges[name].items()}
        return out

    def format(self) -> str:
        rows = self.report()
        if not rows:
            return "phase profile: no samples (all ticks in warmup?)"
        width = max(len(n) for n in rows)
        lines = [f"phase profile ({self.ticks} ticks, "
                 f"{self.warmup_ticks} warmup):"]
        for name, r in rows.items():
            lines.append(f"  {name:<{width}}  total {r['total_us']:>10.0f} us"
                         f"  mean {r['mean_us']:>8.1f} us"
                         f"  x{int(r['count']):<5d} {r['share']:6.1%}")
        return "\n".join(lines)


__all__ = ["PhaseProfiler", "span", "sync_devices"]
