"""The observability bundle a :class:`~repro_torch.runtime.serve.Server`
publishes into (the port's copy of ``repro.obs.observe``).

``Observability`` composes the four obs facilities behind one object
the engine can hold and null-check: a :class:`.trace.TraceRecorder`
(lifecycle + tick spans), a :class:`.metrics.MetricsRegistry`
(counters/gauges/histograms), an optional :class:`.profile.PhaseProfiler`
(per-tick phase attribution with device sync), and an optional
:class:`.monitor.ConformanceMonitor` (the online direction-2 model
check on the paged allocator's op stream).  Construct one, pass it as
``Server(..., obs=...)``, drain, then :meth:`export` the combined
document — which is simultaneously the schema'd trace artifact and a
Perfetto-loadable timeline.

The engine's contract is narrow: every hook is a no-op-cheap method
call guarded by ``if self.obs is not None`` at the call site, and NO
hook touches device values (everything recorded is host state the
engine already materialized: no ``.item()``, ``.cpu()`` or
``.tolist()`` of a device tensor), so attaching observability cannot
change a drain's outputs.  Only ``profile=True`` alters timing, by
synchronizing the devices after each phase — a diagnosis mode.

Tick stamps on request/slot tracks are the SERVER tick clock
(``server.ticks``); workload-level events driven on the driver clock
(:func:`repro_torch.runtime.workload.drive_trace`) carry their driver-clock
values in ``args`` instead, keeping every track's ``tick`` field
monotone (the property :func:`.trace.validate_trace` enforces).
"""

from __future__ import annotations

import time
from typing import Any

from .metrics import MetricsRegistry
from .monitor import ConformanceMonitor
from .profile import PhaseProfiler
from .trace import TraceRecorder, export_trace


class Observability:
    def __init__(self, *, trace: bool = True, metrics: bool = True,
                 profile: bool = False, monitor: bool = False,
                 monitor_window: int = 256, strict: bool = False,
                 profile_warmup_ticks: int = 1):
        self.recorder = TraceRecorder() if trace else None
        self.registry = MetricsRegistry() if metrics else None
        self.profiler = (PhaseProfiler(warmup_ticks=profile_warmup_ticks)
                         if profile else None)
        self._want_monitor = monitor
        self._strict = strict
        self._monitor_window = monitor_window
        self.monitor: ConformanceMonitor | None = None
        self._server = None
        self._req_ticks: dict[int, dict[str, int]] = {}

    # -- lifecycle ---------------------------------------------------------

    def attach(self, server) -> None:
        if self._server is not None and self._server is not server:
            raise ValueError("Observability is per-Server state; build "
                             "one bundle per Server")
        self._server = server
        if self._want_monitor:
            if server.alloc is None:
                raise ValueError("monitor=True needs Server(paged=True): "
                                 "the conformance monitor checks the "
                                 "paged allocator's op stream")
            self.monitor = ConformanceMonitor(
                server.alloc, window=self._monitor_window,
                strict=self._strict)

    # -- request lifecycle hooks ------------------------------------------

    def on_submit(self, server, req) -> None:
        t = server.ticks
        self._req_ticks[req.rid] = {"submitted": t}
        if self.recorder:
            track = ("request", req.rid)
            self.recorder.begin("request", track=track, tick=t,
                                slo=req.slo, prompt=len(req.prompt),
                                max_new=req.max_new,
                                deadline=req.deadline)
            self.recorder.begin("queued", track=track, tick=t)
        if self.registry:
            self.registry.counter(
                "serve.submitted",
                "requests entering the queue").inc()

    def on_admit(self, server, req, slot: int, shared: int) -> None:
        t = server.ticks
        rt = self._req_ticks.setdefault(req.rid, {"submitted": t})
        waited = t - rt.get("submitted", t)
        rt["admitted"] = t
        if self.recorder:
            track = ("request", req.rid)
            self.recorder.end("queued", track=track, tick=t,
                              waited_ticks=waited)
            self.recorder.begin("running", track=track, tick=t,
                                slot=slot, shared_prefix=shared)
            self.recorder.begin(f"req{req.rid}", track=("slot", slot),
                                tick=t, rid=req.rid, slo=req.slo)
        if self.registry:
            self.registry.counter("serve.admitted",
                                  "queue -> slot placements").inc()
            self.registry.histogram(
                "serve.queue_wait_ticks",
                "ticks between submit and placement",
                slo=req.slo).observe(waited)
            if shared:
                self.registry.counter(
                    "serve.shared_prefix_tokens",
                    "prompt tokens admitted via COW sharing").inc(shared)

    def on_preempt(self, server, req, slot: int, reason: str) -> None:
        t = server.ticks
        if self.recorder:
            track = ("request", req.rid)
            self.recorder.end("running", track=track, tick=t,
                              reason=reason, tokens=len(req.out))
            self.recorder.begin("queued", track=track, tick=t,
                                resumed=True)
            self.recorder.end(f"req{req.rid}", track=("slot", slot),
                              tick=t, reason=reason)
        if self.registry:
            self.registry.counter("serve.preemptions",
                                  "mid-flight evictions",
                                  reason=reason).inc()

    def on_retire(self, server, req, slot: int) -> None:
        t = server.ticks
        rt = self._req_ticks.pop(req.rid, {})
        latency = t - rt.get("submitted", t)
        if self.recorder:
            track = ("request", req.rid)
            self.recorder.end("running", track=track, tick=t,
                              tokens=len(req.out))
            self.recorder.end("request", track=track, tick=t,
                              tokens=len(req.out),
                              latency_ticks=latency,
                              preempted=req.preempted)
            self.recorder.end(f"req{req.rid}", track=("slot", slot),
                              tick=t)
        if self.registry:
            self.registry.counter("serve.retired",
                                  "completed requests").inc()
            self.registry.counter("serve.tokens_out",
                                  "generated tokens across retired "
                                  "requests").inc(len(req.out))
            self.registry.histogram(
                "serve.latency_ticks",
                "submit -> retire, in engine ticks",
                slo=req.slo).observe(latency)

    # -- tick + phase hooks ------------------------------------------------

    def on_tick_begin(self, server, tick: int) -> None:
        if self.profiler:
            self.profiler.tick_begin()
        if self.recorder:
            self.recorder.begin("tick", tick=tick)

    def on_tick_end(self, server, tick: int, *, n_decode: int = 0,
                    n_spec: int = 0, n_prefill: int = 0) -> None:
        if self.recorder:
            self.recorder.end("tick", tick=tick, decode=n_decode,
                              spec=n_spec, prefill=n_prefill)
            self.recorder.counter("active_slots",
                                  n_decode + n_spec + n_prefill,
                                  tick=tick)
            self.recorder.counter("queue_depth", len(server.queue),
                                  tick=tick)
            if server.alloc is not None:
                self.recorder.counter("free_pages",
                                      server.alloc.free_pages,
                                      tick=tick)
        if self.registry:
            self.registry.gauge("serve.queue_depth").set(
                len(server.queue))
            if server.alloc is not None:
                self.registry.gauge("serve.free_pages").set(
                    server.alloc.free_pages)
        if self.monitor is not None:
            ok = self.monitor.poll(tick)
            if not ok and self.recorder and self.monitor.violation and \
                    not self.monitor.violation.get("_traced"):
                self.monitor.violation["_traced"] = True
                self.recorder.instant(
                    "conformance.violation", tick=tick,
                    message=self.monitor.violation["message"][:200])
                if self.registry:
                    self.registry.counter(
                        "serve.conformance_violations",
                        "online monitor trips").inc()
        if self.profiler:
            self.profiler.tick_end()

    def phase_begin(self, name: str, tick: int) -> float:
        t0 = time.perf_counter()
        if self.recorder:
            self.recorder.begin(f"phase.{name}", tick=tick)
        return t0

    def phase_end(self, name: str, tick: int, t0: float, sync=None,
                  **args: Any) -> None:
        if self.profiler:
            self.profiler.phase_end(name, t0, sync=sync)
        if self.recorder:
            self.recorder.end(f"phase.{name}", tick=tick, **args)

    # -- export ------------------------------------------------------------

    def export(self, path: str | None = None) -> dict:
        """Final poll, close truncated spans, compose the document."""

        if self.monitor is not None:
            self.monitor.poll()
        if self._server is not None and self.registry is not None:
            for k, v in self._server.stats().items():
                self.registry.gauge(f"serve.drain.{k}").set(v)
        events: list[dict] = []
        if self.recorder:
            self.recorder.close_open_spans()
            events = self.recorder.events
        return export_trace(
            events, path,
            metrics=(self.registry.snapshot() if self.registry
                     else None),
            phases=(self.profiler.report() if self.profiler else None),
            monitor=(self.monitor.report() if self.monitor
                     else None))


__all__ = ["Observability"]
