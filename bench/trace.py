"""A ``torch.profiler`` slice of the window and its reduction: the
device's busy time (the union of its kernel and copy intervals), the
kernels launched, the device ops that took most time, the idle gaps by
what the host was doing, and each matrix product's shapes, dtypes and
device time.  The union's arithmetic is ``chip_smoke.py``'s
``tick_profile``.
"""

from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass, field

import torch

MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
TOP = 10
NAME_CHARS = 120


@dataclass
class Slice:
    window_s: float                     # host clock, synchronised ends
    busy_s: float | None                # None: the trace held no device op
    kernels: int = 0
    copies: int = 0
    top_ops: list = field(default_factory=list)     # [name, seconds]
    idle_gaps: list = field(default_factory=list)   # [host op, seconds]
    matmuls: list = field(default_factory=list)     # (name, shapes, dtypes, s)
    units: int = 0                      # ticks or steps inside the slice


class Profiler:
    """Start and stop a profiler around whole steps; the device is
    synchronised at both ends.  ``shapes`` records each op's input shapes
    and dtypes, which costs the host more time an op: a slice that times
    the device's idle share records none."""

    def __init__(self, device: torch.device, shapes: bool = False):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts, record_shapes=shapes)
        self.t0 = self.wall = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.wall = time.perf_counter() - self.t0
        self.prof.stop()

    def reduce(self) -> Slice:
        return reduce(self.prof, self.wall)


def profiled(device, step, n: int) -> Slice:
    """``n`` calls of ``step`` profiled twice: once plain, for the
    device's busy time, launches, top ops and idle gaps, then once with
    shapes, for the matrix products."""

    plain, shaped = Profiler(device), Profiler(device, shapes=True)
    for prof in (plain, shaped):
        prof.start()
        for _ in range(n):
            step()
        prof.stop()
    out = plain.reduce()
    out.matmuls = shaped.reduce().matmuls
    out.units = n
    return out


def _union(intervals):
    """Merged (start, end) runs of sorted intervals and their total."""

    runs, busy = [], 0
    for s, e in intervals:
        if runs and s <= runs[-1][1]:
            if e > runs[-1][1]:
                busy += e - runs[-1][1]
                runs[-1][1] = e
        else:
            runs.append([s, e])
            busy += e - s
    return runs, busy


def _host_op(cpu, starts, t: int) -> str:
    """The latest-starting host op (aten op or range) covering time ``t``
    among the 256 that start last before it."""

    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        name, s, e = cpu[j]
        if e >= t:
            return name
    return "host, outside any op"


def reduce(prof, wall_s: float) -> Slice:
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    dev, cpu = [], []
    for e in events:
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(span)
        elif e.device_type() == DeviceType.CPU:
            cpu.append(span)
    out = Slice(window_s=wall_s, busy_s=None)
    dev.sort(key=lambda ev: ev[1])
    cpu.sort(key=lambda ev: ev[1])
    if dev:
        runs, busy = _union((s, e) for _, s, e in dev)
        out.busy_s = busy / 1e9
        out.copies = sum(n.startswith(("Memcpy", "Memset")) for n, _, _ in dev)
        out.kernels = len(dev) - out.copies
        per_name = collections.Counter()
        for n, s, e in dev:
            per_name[n[:NAME_CHARS]] += e - s
        out.top_ops = [[n, t / 1e9] for n, t in per_name.most_common(TOP)]
        starts = [s for _, s, _ in cpu]
        gaps = collections.Counter()
        for (_, e0), (s1, _) in zip(runs, runs[1:]):
            gaps[_host_op(cpu, starts, (e0 + s1) // 2)[:NAME_CHARS]] += \
                s1 - e0
        out.idle_gaps = [[n, t / 1e9] for n, t in gaps.most_common(TOP)]
    dtypes = {e.correlation_id(): list(e.dtypes()) for e in events
              if e.name() in MATMUL_OPS}
    for fe in prof.events():
        if fe.name in MATMUL_OPS:
            us = getattr(fe, "device_time_total", None)
            if us is None:
                us = fe.cuda_time_total
            out.matmuls.append((fe.name, [list(s) for s in fe.input_shapes],
                                dtypes.get(fe.id, []), us / 1e6))
    return out


__all__ = ["MATMUL_OPS", "Profiler", "Slice", "profiled", "reduce"]
