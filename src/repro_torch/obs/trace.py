"""Structured tracing: tick-clock + wall-clock spans with a
Chrome-trace-event exporter (the port's copy of ``repro.obs.trace``; the
documents are the same, ``kind`` included, so either package parses the
other's).

The recorder's event model is deliberately tiny — begin/end spans,
instants, and counter samples, each stamped with BOTH clocks: the
engine tick (the deterministic clock every latency summary and model
check runs on) and wall-clock microseconds (what Perfetto renders).
Events live on *tracks*:

* ``("engine",)`` — per-tick spans and their nested phase spans
  (decode / speculate / verify / prefill / COW copies);
* ``("slot", s)`` — slot occupancy: one span per residency of a
  request in slot ``s``;
* ``("request", rid)`` — the request lifecycle: an outer ``request``
  span containing alternating ``queued`` / ``running`` child spans, so
  a preempted-and-resumed request renders as
  queued→running→queued→running inside one parent.

:func:`export_trace` writes a single JSON document that is BOTH the
schema'd artifact (``kind``/``schema``/``meta`` envelope, optional
``metrics``/``phases``/``monitor`` sections) and directly loadable by
Perfetto / ``chrome://tracing`` — those readers use the standard
``traceEvents`` key and ignore the extra top-level keys.  Tracks map to
pid/tid: pid 1 is the engine process (tid 0 the tick timeline, tid
``1+s`` slot ``s``), pid 2 the requests process (tid ``1+rid``), with
``M``-phase metadata events naming them.  :func:`parse_trace` inverts
the mapping (via those same metadata events), so record → export →
parse is a round trip; :func:`spans_from_events` stack-pairs B/E into
concrete spans for tests and the CLI summary.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

TRACE_KIND = "repro.obs/trace"
TRACE_SCHEMA = 1

ENGINE: tuple = ("engine",)

_PID_ENGINE = 1
_PID_REQUESTS = 2


def _provenance_meta() -> dict[str, str]:
    from ..tune.artifact import provenance_meta
    return provenance_meta()


class TraceRecorder:
    """Append-only event recorder on a monotonic wall clock.

    ``ts`` is microseconds since recorder construction
    (``time.perf_counter`` based, so monotone by construction); ``tick``
    is whatever engine clock the caller passes.  ``origin_ns`` is that
    origin on the Unix-epoch clock (``time.time_ns()``), which is
    ``torch.profiler``'s: ``origin_ns + 1e3 * ts`` lays an event over a
    profiler trace of the same run.  Open spans are tracked per track so
    :meth:`close_open_spans` can truncate cleanly at export time (a
    drain that raised mid-tick still yields a valid, balanced trace)."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.origin_ns = time.time_ns()
        self._t0 = clock()
        self.events: list[dict] = []
        self._open: dict[tuple, list[str]] = {}
        self._last_tick: dict[tuple, int] = {}

    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _emit(self, ph: str, name: str, track: tuple, tick: int,
              args: dict) -> None:
        self._last_tick[track] = int(tick)
        self.events.append({"ph": ph, "name": name, "track": track,
                            "tick": int(tick), "ts": self.now_us(),
                            "args": args})

    def begin(self, name: str, *, track: tuple = ENGINE, tick: int = 0,
              **args: Any) -> None:
        self._open.setdefault(track, []).append(name)
        self._emit("B", name, track, tick, args)

    def end(self, name: str, *, track: tuple = ENGINE, tick: int = 0,
            **args: Any) -> None:
        stack = self._open.get(track)
        if stack and stack[-1] == name:
            stack.pop()
        self._emit("E", name, track, tick, args)

    def instant(self, name: str, *, track: tuple = ENGINE,
                tick: int = 0, **args: Any) -> None:
        self._emit("i", name, track, tick, args)

    def counter(self, name: str, value: float, *, tick: int = 0) -> None:
        self._emit("C", name, ENGINE, tick, {"value": float(value)})

    def open_spans(self, track: tuple) -> list[str]:
        return list(self._open.get(track, ()))

    def close_open_spans(self) -> int:
        """End every still-open span (innermost first), marking each
        ``truncated`` — called at export so a trace is always
        balanced."""

        n = 0
        for track, stack in list(self._open.items()):
            while stack:
                name = stack[-1]
                self.end(name, track=track,
                         tick=self._last_tick.get(track, 0),
                         truncated=True)
                n += 1
        return n


# -- export / parse ---------------------------------------------------------

def _track_pid_tid(track: tuple) -> tuple[int, int]:
    if track == ENGINE:
        return _PID_ENGINE, 0
    kind = track[0]
    if kind == "slot":
        return _PID_ENGINE, 1 + int(track[1])
    if kind == "request":
        return _PID_REQUESTS, 1 + int(track[1])
    raise ValueError(f"unknown track {track!r}")


def _track_name(track: tuple) -> str:
    if track == ENGINE:
        return "ticks"
    return f"{track[0]} {track[1]}"


def chrome_events(events: Iterable[dict]) -> list[dict]:
    """Internal events -> Chrome trace-event dicts (metadata first)."""

    tracks: dict[tuple, tuple[int, int]] = {}
    out: list[dict] = []
    for ev in events:
        track = tuple(ev["track"])
        pid, tid = tracks.get(track) or tracks.setdefault(
            track, _track_pid_tid(track))
        args = dict(ev["args"])
        args["tick"] = ev["tick"]
        rec: dict[str, Any] = {"name": ev["name"], "cat": track[0],
                               "ph": ev["ph"], "ts": ev["ts"],
                               "pid": pid, "tid": tid, "args": args}
        if ev["ph"] == "i":
            rec["s"] = "t"          # thread-scoped instant marker
        out.append(rec)

    meta: list[dict] = []
    pids = {pid for pid, _ in tracks.values()}
    pid_names = {_PID_ENGINE: "engine", _PID_REQUESTS: "requests"}
    for pid in sorted(pids):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": pid_names[pid]}})
    for track, (pid, tid) in sorted(tracks.items(),
                                    key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": _track_name(track)}})
    return meta + out


def export_trace(events: Iterable[dict], path: str | None = None, *,
                 metrics: dict | None = None,
                 phases: dict | None = None,
                 monitor: dict | None = None,
                 meta: dict | None = None,
                 origin_ns: int | None = None) -> dict:
    """Build (and optionally atomically write) the trace document.
    ``origin_ns``: the recorder's :attr:`TraceRecorder.origin_ns`, kept
    as ``meta["ts_origin_unix_ns"]``."""

    doc: dict[str, Any] = {
        "kind": TRACE_KIND,
        "schema": TRACE_SCHEMA,
        "meta": dict(meta) if meta is not None else _provenance_meta(),
        "displayTimeUnit": "ms",
        "traceEvents": chrome_events(events),
    }
    if origin_ns is not None:
        doc["meta"]["ts_origin_unix_ns"] = int(origin_ns)
    if metrics is not None:
        doc["metrics"] = metrics
    if phases is not None:
        doc["phases"] = phases
    if monitor is not None:
        doc["monitor"] = monitor
    if path is not None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    return doc


def parse_trace(doc: dict) -> list[dict]:
    """Chrome events back to the recorder's internal form, skipping
    metadata.  The (pid, tid) -> track map is rebuilt from the
    ``thread_name`` metadata the exporter emits."""

    tracks: dict[tuple[int, int], tuple] = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M" and ev["name"] == "thread_name":
            name = ev["args"]["name"]
            if name == "ticks":
                track: tuple = ENGINE
            else:
                kind, _, idx = name.partition(" ")
                track = (kind, int(idx))
            tracks[(ev["pid"], ev["tid"])] = track
    out: list[dict] = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M":
            continue
        track = tracks[(ev["pid"], ev["tid"])]
        args = dict(ev["args"])
        tick = args.pop("tick", 0)
        if ev["ph"] == "C":
            track = ENGINE
        out.append({"ph": ev["ph"], "name": ev["name"], "track": track,
                    "tick": tick, "ts": ev["ts"], "args": args})
    return out


@dataclass
class Span:
    name: str
    track: tuple
    tick0: int
    tick1: int
    ts: float
    dur: float
    args: dict = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)


def spans_from_events(events: Iterable[dict]) -> list[Span]:
    """Stack-pair B/E per track into :class:`Span` trees (roots
    returned, children nested).  Raises ``ValueError`` on mismatched
    nesting — the property the round-trip test asserts."""

    stacks: dict[tuple, list[Span]] = {}
    roots: list[Span] = []
    for ev in events:
        track = tuple(ev["track"])
        if ev["ph"] == "B":
            span = Span(name=ev["name"], track=track, tick0=ev["tick"],
                        tick1=ev["tick"], ts=ev["ts"], dur=0.0,
                        args=dict(ev["args"]))
            stack = stacks.setdefault(track, [])
            (stack[-1].children if stack else roots).append(span)
            stack.append(span)
        elif ev["ph"] == "E":
            stack = stacks.get(track)
            if not stack:
                raise ValueError(f"E {ev['name']!r} on {track!r} with "
                                 f"no open span")
            span = stack.pop()
            if span.name != ev["name"]:
                raise ValueError(f"E {ev['name']!r} closes open span "
                                 f"{span.name!r} on {track!r}")
            span.tick1 = ev["tick"]
            span.dur = ev["ts"] - span.ts
            span.args.update(ev["args"])
    open_names = [(t, s.name) for t, st in stacks.items() for s in st]
    if open_names:
        raise ValueError(f"unclosed spans: {open_names}")
    return roots


def validate_trace(doc: dict) -> list[str]:
    """Schema + clock sanity problems (empty list = valid): envelope
    keys, per-event fields, wall-clock monotonicity in file order,
    per-track tick monotonicity, and balanced span nesting."""

    problems: list[str] = []
    if doc.get("kind") != TRACE_KIND:
        problems.append(f"kind is {doc.get('kind')!r}, "
                        f"want {TRACE_KIND!r}")
    if doc.get("schema") != TRACE_SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, "
                        f"want {TRACE_SCHEMA}")
    meta = doc.get("meta")
    if not isinstance(meta, dict) or not meta.get("created_utc"):
        problems.append("meta.created_utc missing")
    raw = doc.get("traceEvents")
    if not isinstance(raw, list):
        return problems + ["traceEvents is not a list"]
    for i, ev in enumerate(raw):
        missing = [k for k in ("name", "ph") if k not in ev]
        if ev.get("ph") != "M":
            missing += [k for k in ("ts", "pid", "tid", "args")
                        if k not in ev]
        if missing:
            problems.append(f"event {i} missing {missing}")
            return problems
    try:
        events = parse_trace(doc)
    except (KeyError, ValueError) as exc:
        return problems + [f"unparseable events: {exc}"]
    last_ts = -1.0
    last_tick: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if ev["ts"] < last_ts:
            problems.append(f"event {i} ts {ev['ts']} < predecessor "
                            f"{last_ts}: wall clock not monotone")
            break
        last_ts = ev["ts"]
        prev = last_tick.get(ev["track"])
        if prev is not None and ev["tick"] < prev:
            problems.append(f"event {i} tick {ev['tick']} < {prev} on "
                            f"track {ev['track']}: tick clock not "
                            f"monotone")
            break
        last_tick[ev["track"]] = ev["tick"]
    try:
        spans_from_events(events)
    except ValueError as exc:
        problems.append(str(exc))
    return problems


__all__ = ["TRACE_KIND", "TRACE_SCHEMA", "ENGINE", "TraceRecorder",
           "Span", "chrome_events", "export_trace", "parse_trace",
           "spans_from_events", "validate_trace"]
