"""``python -m repro_torch.tune`` — fleet-rollout tooling for the port's
tuning cache (the port's copy of ``repro.tune.cli``).

Subcommands:

* ``warmup <plan.json>`` — run a :class:`~repro_torch.tune.plan.TuningPlan`
  spec against the cache (skip-on-hit; ``--force`` re-tunes;
  ``--workers N`` thread-pools the independent jobs); prints per-job
  progress + a summary, ``--json`` emits the machine-readable report on
  standard output (the progress lines then go to standard error).
  Exit code 1 if any job failed.
* ``export <artifact.json>`` — write the cache as a portable
  schema-versioned bundle (``--platform`` filters, e.g. ``cuda``/``cpu``).
* ``merge <artifact.json>`` — merge a bundle into the cache
  (``--policy prefer_measured|prefer_newer|keep_existing``).
* ``ls`` — list cached entries (``--json`` for scripts).
* ``prune`` — drop entries by ``--backend`` and/or ``--stale-days``.

``--cache PATH`` (before the subcommand) overrides the store; default is
``$REPRO_TORCH_TUNE_CACHE`` or ``~/.cache/repro_torch/tune_cache.json``.
The plan's kernel tunables measure on the card unless a job's params
ask for ``"device": "cpu"``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Sequence

from .artifact import ArtifactError, MERGE_POLICIES, platform_key
from .cache import TuningCache
from .plan import TuningPlan


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Tuning-cache warm-up / export / merge tooling "
                    "(fleet rollout).")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="cache file (default: $REPRO_TORCH_TUNE_CACHE or "
                         "~/.cache/repro_torch/tune_cache.json)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("warmup", help="run a TuningPlan spec into the cache")
    p.add_argument("plan", help="path to a plan JSON spec")
    p.add_argument("--force", action="store_true",
                   help="re-tune even on cache hits (overwrites entries)")
    p.add_argument("--workers", type=int, default=1, metavar="N",
                   help="run plan jobs through an N-thread pool (jobs are "
                        "independent; per-job failure isolation preserved)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the PlanReport as JSON")

    p = sub.add_parser("export", help="write the cache as an artifact")
    p.add_argument("artifact", help="output bundle path")
    p.add_argument("--platform", default=None,
                   help="only entries for this platform "
                        "(backend or backend/device_kind)")

    p = sub.add_parser("merge", help="merge an artifact into the cache")
    p.add_argument("artifact", help="bundle to merge")
    p.add_argument("--policy", default="prefer_measured",
                   choices=MERGE_POLICIES)

    p = sub.add_parser("ls", help="list cached entries")
    p.add_argument("--json", action="store_true", dest="as_json")

    p = sub.add_parser("prune", help="drop entries by backend/staleness")
    p.add_argument("--backend", default=None,
                   help="drop entries tuned for this backend (cuda, cpu)")
    p.add_argument("--stale-days", type=float, default=None,
                   help="drop entries older than this many days")
    return ap


def _cmd_warmup(cache: TuningCache, args) -> int:
    plan = TuningPlan.from_spec(args.plan)
    # under --json standard output carries the report alone
    progress = ((lambda line: print(line, file=sys.stderr, flush=True))
                if args.as_json else print)
    report = plan.run(cache=cache, force=args.force,
                      workers=args.workers, progress=progress)
    if args.as_json:
        print(json.dumps(report.to_json(), indent=1, sort_keys=True))
    return 0 if report.ok else 1


def _cmd_export(cache: TuningCache, args) -> int:
    bundle = cache.export_artifact(args.artifact, platform=args.platform)
    print(f"exported {bundle['entry_count']} entries "
          f"({len(bundle['platforms'])} platform(s)"
          f"{', %d filtered out' % bundle['skipped'] if bundle['skipped'] else ''}) "
          f"-> {args.artifact}")
    return 0


def _cmd_merge(cache: TuningCache, args) -> int:
    report = cache.merge_artifact(args.artifact, policy=args.policy)
    cache.save()
    print(f"merged {args.artifact} (policy={args.policy}): "
          f"{report['added']} added, {report['replaced']} replaced, "
          f"{report['kept']} kept -> {cache.path} "
          f"({len(cache)} entries)")
    meta = report.get("meta")
    if meta:
        print(f"  artifact provenance: {meta.get('tool', '?')} on "
              f"{meta.get('host', '?')} ({meta.get('machine', '?')}) "
              f"at {meta.get('created_utc', '?')}")
    return 0


def _cmd_ls(cache: TuningCache, args) -> int:
    rows = []
    for key, e in sorted(cache.entries.items()):
        fp = e.get("fingerprint") or {}
        rows.append({
            "key": key,
            "tunable": (fp.get("tunable") or {}).get("tunable", "?"),
            "engine": e.get("engine", "?"),
            "provenance": e.get("provenance", "modeled"),
            "platform": platform_key(fp.get("platform")),
            "t_min": e.get("t_min"),
            "age_days": round((time.time()
                               - float(e.get("created", 0))) / 86400, 2),
            # artifact provenance: where a merged entry was exported
            # from (None for entries tuned locally)
            "origin": e.get("origin"),
        })
    if args.as_json:
        print(json.dumps(rows, indent=1, sort_keys=True))
        return 0
    if not rows:
        print(f"{cache.path}: empty")
        return 0
    hdr = f"{'key':<12} {'tunable':<28} {'engine':<10} {'prov':<9} " \
          f"{'platform':<22} {'t_min':>12} {'age_d':>7}"
    print(f"{cache.path}: {len(rows)} entries")
    print(hdr)
    for r in rows:
        t = "?" if r["t_min"] is None else f"{r['t_min']:.4g}"
        print(f"{r['key'][:12]:<12} {r['tunable']:<28} {r['engine']:<10} "
              f"{r['provenance']:<9} {r['platform']:<22} "
              f"{t:>12} {r['age_days']:>7}")
    return 0


def _cmd_prune(cache: TuningCache, args) -> int:
    if args.backend is None and args.stale_days is None:
        print("prune: need --backend and/or --stale-days", file=sys.stderr)
        return 2
    n = cache.prune(backend=args.backend, stale_days=args.stale_days)
    cache.save()
    print(f"pruned {n} entries -> {len(cache)} remain in {cache.path}")
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    cache = TuningCache(args.cache)
    try:
        handler = {"warmup": _cmd_warmup, "export": _cmd_export,
                   "merge": _cmd_merge, "ls": _cmd_ls,
                   "prune": _cmd_prune}[args.cmd]
        return handler(cache, args)
    except (ArtifactError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


__all__ = ["main"]
