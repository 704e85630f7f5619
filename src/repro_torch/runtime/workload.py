"""Seeded serving traces: the workload half of scheduler tuning (the
port's copy of ``repro.runtime.workload``: the same seed gives the same
trace, request for request).

A *trace* is a list of :class:`TraceRequest` — arrival tick, prompt,
output budget, SLO class, per-class deadline — generated
deterministically from a :class:`TraceConfig` seed, so every policy
(and every tuning ``measure()`` call) drains the IDENTICAL workload and
differences in p50/p99/goodput are attributable to the policy alone.

The clock is the ENGINE TICK, not wall time: arrivals, deadlines, and
latencies are all counted in ``Server.tick()`` calls.  That keeps the
trace and its summary bit-reproducible across machines — wall-clock
enters only through :func:`repro_torch.runtime.tunables.timed_trace_drain`,
which times the same deterministic drain.

Two arrival processes:

* ``poisson`` — geometric inter-arrival gaps at ``rate`` requests/tick
  (the memoryless discrete analogue), the steady-load baseline;
* ``bursty`` — ``burst`` requests land together every ``burst_every``
  ticks; the workload where admission order and preemption actually
  matter (a burst of interactive arrivals behind a batch house is the
  p99 story ``bench_traffic`` tables).

``shared_frac`` of requests open with one common ``prefix_len``-token
system prompt — the traffic shape copy-on-write prefix sharing
(:meth:`~repro_torch.runtime.kv.PagedKVAllocator.share`) exists for.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

SLO_CLASSES = ("interactive", "batch")


@dataclass(frozen=True)
class TraceRequest:
    """One arrival: everything :meth:`~repro_torch.runtime.serve.Server.submit`
    needs, plus the absolute deadline tick the summary scores against."""

    rid: int
    arrival: int                 # tick the request becomes visible
    prompt: tuple[int, ...]
    max_new: int
    slo: str = "interactive"
    deadline: int = 0            # absolute tick; 0 = no deadline


@dataclass(frozen=True)
class TraceConfig:
    """Knobs of the generator; every field participates in the
    ``serve.scheduler`` fingerprint via the tunable that embeds them."""

    requests: int = 24
    arrival: str = "bursty"             # "poisson" | "bursty"
    rate: float = 1.0                   # poisson: mean arrivals per tick
    burst: int = 6                      # bursty: arrivals per burst
    burst_every: int = 12               # bursty: ticks between bursts
    prompt_len: tuple[int, int] = (6, 24)       # uniform [lo, hi]
    max_new: tuple[int, int] = (4, 12)          # uniform [lo, hi]
    interactive_frac: float = 0.5
    deadlines: Mapping[str, int] = field(       # ticks after arrival
        default_factory=lambda: {"interactive": 48, "batch": 400})
    shared_frac: float = 0.0            # share of requests opening with
    prefix_len: int = 16                # the common system prompt
    vocab: int = 256
    seed: int = 0


def generate_trace(cfg: TraceConfig) -> list[TraceRequest]:
    """The deterministic trace for ``cfg`` (same config -> same trace,
    token for token), sorted by arrival tick."""

    if cfg.arrival not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrival process {cfg.arrival!r}")
    rng = np.random.default_rng(cfg.seed)
    lo_p, hi_p = cfg.prompt_len
    lo_n, hi_n = cfg.max_new
    prefix = [int(t) for t in
              rng.integers(1, cfg.vocab, max(1, cfg.prefix_len))]

    arrivals: list[int] = []
    t = 0
    if cfg.arrival == "poisson":
        p = min(1.0, max(1e-6, cfg.rate))
        for _ in range(cfg.requests):
            t += int(rng.geometric(p))
            arrivals.append(t)
    else:
        while len(arrivals) < cfg.requests:
            n = min(cfg.burst, cfg.requests - len(arrivals))
            arrivals.extend([t] * n)
            t += cfg.burst_every

    out: list[TraceRequest] = []
    for rid, arr in enumerate(arrivals):
        slo = ("interactive" if rng.random() < cfg.interactive_frac
               else "batch")
        plen = int(rng.integers(lo_p, hi_p + 1))
        body = [int(x) for x in rng.integers(1, cfg.vocab, plen)]
        if cfg.shared_frac > 0 and rng.random() < cfg.shared_frac:
            prompt = tuple(prefix + body)
        else:
            prompt = tuple(body)
        max_new = int(rng.integers(lo_n, hi_n + 1))
        deadline = arr + int(cfg.deadlines.get(slo, 0))
        out.append(TraceRequest(rid=rid, arrival=arr, prompt=prompt,
                                max_new=max_new, slo=slo,
                                deadline=deadline))
    return out


def drive_trace(server, trace: list[TraceRequest], *,
                max_ticks: int = 200_000,
                recorder=None) -> dict[int, dict]:
    """Feed ``trace`` into ``server`` on the tick clock and drain it.

    Requests are submitted when the clock reaches their arrival tick
    (idle gaps fast-forward), the server ticks until every request
    retires, and each request's record — finish tick, latency, deadline
    met, output tokens — is returned keyed by trace rid.

    The per-request bookkeeping is TRACE EVENTS, not a private dict:
    the driver emits ``workload.submitted`` / ``workload.retired``
    instants (driver-clock arrival/finish in their args) into
    ``recorder`` (a :class:`~repro_torch.obs.trace.TraceRecorder`, or a
    local one when none is given) and :func:`records_from_events`
    rebuilds the records from them.  One source of truth: the numbers
    :func:`summarize` reports are exactly the numbers a Perfetto view of
    the trace shows.  (The reference also records into a ``Server``'s
    attached observability bundle; the port's ``Server`` has none yet.)"""

    from ..obs.trace import TraceRecorder
    rec = recorder if recorder is not None else TraceRecorder()
    pending = sorted(trace, key=lambda r: (r.arrival, r.rid))
    nxt = 0
    clock = 0
    requests: dict[int, "object"] = {}  # trace rid -> Request
    live: dict[int, int] = {}           # server rid -> trace rid
    seen_done = 0
    while nxt < len(pending) or server.queue or \
            any(r is not None for r in server.slot_req):
        if nxt < len(pending) and not server.queue and \
                not any(r is not None for r in server.slot_req) and \
                pending[nxt].arrival > clock:
            clock = pending[nxt].arrival        # idle: jump to next burst
        while nxt < len(pending) and pending[nxt].arrival <= clock:
            tr = pending[nxt]
            nxt += 1
            req = server.submit(list(tr.prompt), tr.max_new, slo=tr.slo,
                                deadline=float(tr.deadline))
            live[req.rid] = tr.rid
            requests[tr.rid] = req
            rec.instant("workload.submitted",
                        track=("request", req.rid), tick=server.ticks,
                        rid=tr.rid, arrival=tr.arrival, slo=tr.slo,
                        deadline=tr.deadline)
        server.tick()
        clock += 1
        while seen_done < len(server.completed):
            req = server.completed[seen_done]
            seen_done += 1
            rec.instant("workload.retired",
                        track=("request", req.rid), tick=server.ticks,
                        rid=live[req.rid], finish=clock,
                        tokens=len(req.out))
        if clock > max_ticks:
            raise RuntimeError("trace did not drain")
    return records_from_events(rec.events, requests)


def records_from_events(events: list[dict],
                        requests: Mapping[int, "object"] | None = None,
                        ) -> dict[int, dict]:
    """Per-request records (the :func:`summarize` input) rebuilt from
    ``workload.submitted`` / ``workload.retired`` trace events, keyed
    by trace rid.  ``requests`` (trace rid -> live
    :class:`~repro_torch.runtime.serve.Request`) attaches the concrete
    request objects the benchmarks read outputs from; records parsed
    back from an exported trace simply omit them."""

    records: dict[int, dict] = {}
    for ev in events:
        args = ev.get("args", ev)
        if ev["name"] == "workload.submitted":
            records[args["rid"]] = {"arrival": args["arrival"],
                                    "slo": args["slo"],
                                    "deadline": args["deadline"]}
        elif ev["name"] == "workload.retired":
            r = records[args["rid"]]
            r["finish"] = args["finish"]
            r["latency"] = args["finish"] - r["arrival"]
            r["met"] = (r["deadline"] <= 0
                        or args["finish"] <= r["deadline"])
            r["tokens"] = args["tokens"]
    if requests is not None:
        for rid, req in requests.items():
            if rid in records:
                records[rid]["request"] = req
    return records


def summarize(records: dict[int, dict], ticks: int) -> dict[str, float]:
    """Latency percentiles (per class and overall, in ticks), SLO
    attainment, and goodput = deadline-met tokens per tick — the
    objective ``serve.scheduler`` tunes."""

    summary: dict[str, float] = {"requests": float(len(records)),
                                 "ticks": float(ticks)}
    lats = {"all": []}
    for rec in records.values():
        lats["all"].append(rec["latency"])
        lats.setdefault(rec["slo"], []).append(rec["latency"])
    for cls, ls in lats.items():
        arr = np.asarray(ls, np.float64)
        summary[f"p50_{cls}"] = float(np.percentile(arr, 50))
        summary[f"p99_{cls}"] = float(np.percentile(arr, 99))
    met = [r for r in records.values() if r["met"]]
    summary["slo_attainment"] = len(met) / max(1, len(records))
    good = float(sum(r["tokens"] for r in met))
    summary["goodput_tokens"] = good
    summary["goodput_per_tick"] = good / max(1, ticks)
    summary["tokens"] = float(sum(r["tokens"]
                                  for r in records.values()))
    return summary


__all__ = ["SLO_CLASSES", "TraceRequest", "TraceConfig", "generate_trace",
           "drive_trace", "records_from_events", "summarize"]
