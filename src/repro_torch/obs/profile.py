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
"""

from __future__ import annotations

import time
from typing import Any

import torch


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
        self._tick_t0: float | None = None
        self._tick_phase_us = 0.0

    # -- tick bracket ------------------------------------------------------

    def tick_begin(self) -> None:
        self._tick_t0 = time.perf_counter()
        self._tick_phase_us = 0.0

    def tick_end(self) -> None:
        if self._tick_t0 is None:
            return
        wall_us = (time.perf_counter() - self._tick_t0) * 1e6
        self._tick_t0 = None
        self.ticks += 1
        if self.ticks <= self.warmup_ticks:
            return
        host = max(0.0, wall_us - self._tick_phase_us)
        self.totals_us["host"] = self.totals_us.get("host", 0.0) + host
        self.counts["host"] = self.counts.get("host", 0) + 1

    # -- phases ------------------------------------------------------------

    def phase_begin(self) -> float:
        return time.perf_counter()

    def phase_end(self, name: str, t0: float, sync=None) -> float:
        """Close a phase opened by :meth:`phase_begin`; the devices of
        ``sync`` (a nested dict/list/tuple of tensors) are synchronized
        before the clock is read, so the duration covers the device work
        the phase launched."""

        if sync is not None:
            sync_devices(sync)
        dur_us = (time.perf_counter() - t0) * 1e6
        self._tick_phase_us += dur_us
        if self.ticks >= self.warmup_ticks:
            self.totals_us[name] = self.totals_us.get(name, 0.0) + dur_us
            self.counts[name] = self.counts.get(name, 0) + 1
        return dur_us

    # -- results -----------------------------------------------------------

    def report(self) -> dict[str, dict[str, float]]:
        """Per-phase ``{total_us, count, mean_us, share}`` (share of the
        summed phase time, warmup excluded)."""

        grand = sum(self.totals_us.values())
        out: dict[str, dict[str, float]] = {}
        for name in sorted(self.totals_us,
                           key=lambda n: -self.totals_us[n]):
            tot, cnt = self.totals_us[name], self.counts.get(name, 0)
            out[name] = {"total_us": tot, "count": float(cnt),
                         "mean_us": tot / cnt if cnt else 0.0,
                         "share": tot / grand if grand else 0.0}
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


__all__ = ["PhaseProfiler", "sync_devices"]
