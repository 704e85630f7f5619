"""``python -m repro_torch.obs`` — summarize / check / export recorded
traces (the port's copy of ``repro.obs.cli``; the documents share the
``repro.obs/trace`` schema, so it reads the reference's traces too).

* ``summarize TRACE.json`` — human-readable digest: envelope, event
  counts, span totals by name, workload latency summary (when the
  drain was driven by :func:`repro_torch.runtime.workload.drive_trace`),
  phase breakdown, monitor status.
* ``check TRACE.json [--json]`` — machine gate: schema + clock
  validation via :func:`repro_torch.obs.trace.validate_trace`, plus an
  OFFLINE re-run of the direction-2 conformance check (the port's
  :mod:`repro_torch.verify`) over the allocator records embedded by the
  online monitor.  Exit 1 on any schema problem or conformance
  violation.
* ``export TRACE.json --out chrome.json`` — strip the envelope down to
  the pure Chrome trace-event document (some external viewers reject
  unknown top-level keys; Perfetto loads the full artifact as-is).
"""

from __future__ import annotations

import argparse
import json
from collections import Counter as _Counter


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _span_totals(events: list[dict]) -> dict[str, tuple[int, float]]:
    from .trace import spans_from_events
    totals: dict[str, tuple[int, float]] = {}

    def walk(spans):
        for sp in spans:
            n, dur = totals.get(sp.name, (0, 0.0))
            totals[sp.name] = (n + 1, dur + sp.dur)
            walk(sp.children)

    walk(spans_from_events(events))
    return totals


def _recheck_monitor(mon: dict) -> tuple[str, str]:
    """Re-run trace_accepted over the embedded records.  Returns
    (status, detail): ``accepted`` / ``violation`` / ``skipped``."""

    records = mon.get("records")
    if records is None:
        return ("skipped", "no embedded records "
                "(trail truncated or monitor absent)")
    from ..verify.conformance import ConformanceError, trace_accepted
    from ..verify.models import AllocConfig, AllocatorSemantics
    from .monitor import thaw_ret
    sem = AllocatorSemantics(AllocConfig(**mon["config"]),
                             canonical=False)
    trace = [(m, tuple(args), thaw_ret(ret))
             for m, args, ret in records]
    try:
        trace_accepted(sem, trace)
    except ConformanceError as exc:
        return ("violation", str(exc))
    return ("accepted", f"{len(trace)} allocator ops re-checked")


def _cmd_summarize(args: argparse.Namespace) -> int:
    from .trace import parse_trace
    doc = _load(args.trace)
    events = parse_trace(doc)
    meta = doc.get("meta", {})
    print(f"{args.trace}: {doc.get('kind')} schema {doc.get('schema')}")
    print(f"  created {meta.get('created_utc', '?')} on "
          f"{meta.get('host', '?')} ({meta.get('machine', '?')})")
    phs = _Counter(ev["ph"] for ev in events)
    print(f"  events: {len(events)} "
          f"({', '.join(f'{k}={v}' for k, v in sorted(phs.items()))})")
    try:
        totals = _span_totals(events)
    except ValueError as exc:
        print(f"  spans: UNPAIRABLE ({exc})")
        totals = {}
    for name in sorted(totals, key=lambda n: -totals[n][1]):
        n, dur = totals[name]
        print(f"    {name:<16} x{n:<6d} total {dur / 1e3:9.2f} ms  "
              f"mean {dur / n:9.1f} us")
    from ..runtime.workload import records_from_events, summarize
    records = records_from_events(events)
    done = {k: r for k, r in records.items() if "finish" in r}
    if done:
        ticks = max(r["finish"] for r in done.values())
        s = summarize(done, ticks)
        print(f"  workload: {int(s['requests'])} requests over "
              f"{int(s['ticks'])} ticks; p50/p99 all "
              f"{s['p50_all']:.0f}/{s['p99_all']:.0f} ticks; "
              f"SLO attainment {s['slo_attainment']:.1%}; "
              f"goodput {s['goodput_per_tick']:.2f} tok/tick")
    phases = doc.get("phases")
    if phases:
        print("  phases (profiled, device-synced):")
        for name, r in phases.items():
            print(f"    {name:<12} total {r['total_us']:>10.0f} us  "
                  f"mean {r['mean_us']:>8.1f} us  {r['share']:6.1%}")
    mon = doc.get("monitor")
    if mon:
        print(f"  monitor: {mon['status']} ({mon['ops_checked']} ops, "
              f"{mon['polls']} polls, allocator={mon['allocator']})")
        if mon.get("violation"):
            print(f"    {mon['violation']['message']}")
    return 0


def _cmd_check(args: argparse.Namespace) -> int:
    from .trace import parse_trace, validate_trace
    doc = _load(args.trace)
    problems = validate_trace(doc)
    mon = doc.get("monitor")
    stored = mon["status"] if mon else "absent"
    recheck, detail = (_recheck_monitor(mon) if mon
                       else ("skipped", "no monitor section"))
    if mon and recheck != "skipped" and recheck != stored:
        problems.append(f"monitor section says {stored!r} but offline "
                        f"re-check says {recheck!r}")
    ok = not problems and stored != "violation" and \
        recheck != "violation"
    report = {
        "ok": ok,
        "trace": args.trace,
        "events": len(doc.get("traceEvents", [])) if isinstance(
            doc.get("traceEvents"), list) else 0,
        "problems": problems,
        "monitor": stored,
        "monitor_recheck": recheck,
        "monitor_detail": detail,
    }
    if not problems:
        report["spans"] = sum(
            1 for ev in parse_trace(doc) if ev["ph"] == "B")
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(f"{args.trace}: "
              f"{'OK' if ok else 'FAILED'} — {len(problems)} schema "
              f"problem(s), monitor {stored} (re-check: {recheck}, "
              f"{detail})")
        for p in problems:
            print(f"  - {p}")
    return 0 if ok else 1


def _cmd_export(args: argparse.Namespace) -> int:
    doc = _load(args.trace)
    out = {"displayTimeUnit": doc.get("displayTimeUnit", "ms"),
           "traceEvents": doc["traceEvents"]}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {len(out['traceEvents'])} events -> {args.out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="summarize / check / export repro.obs/trace documents")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="human-readable trace digest")
    p.add_argument("trace")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("check", help="schema + conformance gate "
                                     "(exit 1 on failure)")
    p.add_argument("trace")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_check)

    p = sub.add_parser("export", help="strip to pure Chrome trace JSON")
    p.add_argument("trace")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=_cmd_export)

    args = parser.parse_args(argv)
    return args.fn(args)


__all__ = ["main"]
