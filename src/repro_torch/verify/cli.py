"""``python -m repro_torch.verify`` — the runtime verification gate (the
port's copy of ``repro.verify.cli``).

::

    python -m repro_torch.verify check            # exhaustive model checks
    python -m repro_torch.verify check --json     # machine-readable report
    python -m repro_torch.verify lint [paths...]  # AST rules on the runtime
    python -m repro_torch.verify mutants          # the checker must catch all
    python -m repro_torch.verify replay --trail verify_trails/<name>.json

``check`` explores every model/invariant pair exhaustively on the
bounded configs below; a violation writes a replayable trail JSON to
``--trail-dir`` and exits 1.  ``mutants`` proves the detector detects:
every planted allocator bug must yield a counterexample trail that
``replay`` then reproduces as a concrete real-allocator failure.  An
allocator trail replays against the port's own
:class:`~repro_torch.runtime.kv.PagedKVAllocator` (or the planted mutant
it names); the trail format is the reference's, so a trail written by
either package replays in the other.  ``lint`` with no paths checks
``src/repro_torch/runtime`` (relative to the working directory); a path
that does not exist exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from ..core.explorer import explore
from .conformance import (ConformanceError, coupled_explore, ops_from_trail,
                          replay_ops)
from .harness import ServerConfig, ServerScenario
from .invariants import (allocator_invariants, drain_incomplete,
                         server_invariants, spec_invariants, violated,
                         violates_any)
from .lint import lint_paths
from .models import (AllocConfig, AllocatorSemantics, ServerSemantics,
                     SpecConfig, SpecSemantics, build_driver_model)
from .mutants import MUTANTS

DEFAULT_LINT_PATHS = ["src/repro_torch/runtime"]
DEFAULT_TRAIL_DIR = "verify_trails"

# the acceptance matrix: every config keeps >=2 slots and, for the
# allocator/server machines, the full 6-page over-committed pool with
# share + preemption + rewind reachable
ALLOC_CFG = AllocConfig()          # 3 slots x 3 pages > 6 physical

SERVER_CASES: dict[str, tuple[ServerConfig, ServerScenario]] = {
    "server-fcfs-pressure": (
        ServerConfig(policy="fcfs", batch=3),
        ServerScenario(name="pressure",
                       prompts=((3, 3, 3, 3), (4, 4, 4, 4), (5, 5, 5, 5)),
                       max_new=(2, 2, 2))),
    "server-fcfs-share": (
        ServerConfig(policy="fcfs", batch=3, share_prefix=True),
        ServerScenario(name="share",
                       prompts=((7, 7, 7, 7), (7, 7, 7, 5), (7, 7)),
                       max_new=(2, 1, 1))),
    "server-priority": (
        ServerConfig(policy="priority", batch=2, aging_slack=3),
        ServerScenario(name="slo-mix",
                       prompts=((3, 3, 3), (4, 4), (5, 5, 5)),
                       max_new=(2, 1, 1),
                       slo=("batch", "interactive", "interactive"))),
    "server-prefix": (
        ServerConfig(policy="prefix", batch=3, share_prefix=True),
        ServerScenario(name="prefix-family",
                       prompts=((7, 7, 7, 7), (7, 7, 7, 5), (9, 9)),
                       max_new=(2, 1, 1))),
}

SPEC_CFG = SpecConfig()


def _write_trail(trail_dir: Path, name: str, payload: dict) -> Path:
    trail_dir.mkdir(parents=True, exist_ok=True)
    path = trail_dir / f"{name}.json"
    path.write_text(json.dumps(payload, indent=2))
    return path


def _record(name: str, res, *, kind: str, violations=(), message="",
            trail: str | None = None) -> dict:
    return {
        "name": name,
        "kind": kind,
        "status": res.status,
        "states": res.states,
        "transitions": res.transitions,
        "max_depth": res.max_depth,
        "frontier_peak": getattr(res, "frontier_peak", 0),
        "bound_reason": getattr(res, "bound_reason", None),
        "elapsed_s": round(res.elapsed_s, 3),
        "violations": list(violations),
        "message": message,
        "trail": trail,
    }


# ---------------------------------------------------------------------------
# check
# ---------------------------------------------------------------------------


def _check_alloc_invariants(trail_dir: Path, max_states: int) -> dict:
    sem = AllocatorSemantics(ALLOC_CFG, canonical=True)
    invs = allocator_invariants()
    res = explore(build_driver_model(sem), violates_any(invs),
                  schedule="por", max_states=max_states)
    violations, message, trail = [], "", None
    if res.counterexample is not None:
        violations = violated(invs, res.counterexample.globals)
        message = f"allocator invariants broken: {violations}"
        trail = str(_write_trail(trail_dir, "alloc-invariants", {
            "model": "allocator", "allocator": "real",
            "config": dataclasses.asdict(ALLOC_CFG),
            "ops": ops_from_trail(res.counterexample.trail),
            "violations": violations, "message": message}))
    return _record("alloc-invariants", res, kind="model",
                   violations=violations, message=message, trail=trail)


def _check_alloc_conformance(trail_dir: Path, max_states: int) -> dict:
    sem = AllocatorSemantics(ALLOC_CFG, canonical=True)
    res = coupled_explore(sem, max_states=max_states)
    trail = None
    if not res.ok:
        trail = str(_write_trail(trail_dir, "alloc-conformance", {
            "model": "allocator", "allocator": "real",
            "config": dataclasses.asdict(ALLOC_CFG),
            "ops": [list(op) for op in res.ops],
            "message": res.message}))
    return _record("alloc-conformance", res, kind="conformance",
                   violations=["conformance"] if not res.ok else [],
                   message=res.message, trail=trail)


def _check_server(name: str, cfg: ServerConfig, scen: ServerScenario,
                  trail_dir: Path, max_states: int) -> dict:
    sem = ServerSemantics(cfg, scen)
    invs = server_invariants(cfg)
    res = explore(build_driver_model(sem), violates_any(invs),
                  schedule="por", max_states=max_states,
                  collect_terminals=True)
    violations, message, trail = [], "", None
    if res.counterexample is not None:
        violations = violated(invs, res.counterexample.globals)
        message = f"server invariants broken: {violations}"
        bad_trail = res.counterexample.trail
    else:
        drain = [(t, b) for t in res.terminals
                 for b in drain_incomplete(t.globals)]
        if drain:
            violations = ["drain_complete"]
            message = "; ".join(b for _, b in drain[:3])
            bad_trail = drain[0][0].trail
        else:
            bad_trail = None
    if bad_trail is not None:
        trail = str(_write_trail(trail_dir, name, {
            "model": "server", "policy": cfg.policy,
            "config": dataclasses.asdict(cfg),
            "scenario": dataclasses.asdict(scen),
            "ops": [list(op) for op in ops_from_trail(bad_trail)],
            "violations": violations, "message": message}))
        if not violations:   # pragma: no cover - defensive
            violations = ["unknown"]
    rec = _record(name, res, kind="model", violations=violations,
                  message=message, trail=trail)
    if violations and rec["status"] == "verified":
        rec["status"] = "violated"           # drain failures at terminals
    return rec


def _check_spec(trail_dir: Path, max_states: int) -> dict:
    sem = SpecSemantics(SPEC_CFG)
    invs = spec_invariants(SPEC_CFG)
    res = explore(build_driver_model(sem), violates_any(invs),
                  schedule="por", max_states=max_states)
    violations, message, trail = [], "", None
    if res.counterexample is not None:
        violations = violated(invs, res.counterexample.globals)
        message = f"speculation invariants broken: {violations}"
        trail = str(_write_trail(trail_dir, "spec-cycle", {
            "model": "spec", "config": dataclasses.asdict(SPEC_CFG),
            "ops": [list(op) for op in
                    ops_from_trail(res.counterexample.trail)],
            "violations": violations, "message": message}))
    return _record("spec-cycle", res, kind="model",
                   violations=violations, message=message, trail=trail)


def _cmd_check(args) -> int:
    trail_dir = Path(args.trail_dir)
    checks = [_check_alloc_invariants(trail_dir, args.max_states),
              _check_alloc_conformance(trail_dir, args.max_states)]
    for name, (cfg, scen) in SERVER_CASES.items():
        checks.append(_check_server(name, cfg, scen, trail_dir,
                                    args.max_states))
    checks.append(_check_spec(trail_dir, args.max_states))
    ok = all(c["status"] != "violated" for c in checks)
    exhaustive = all(c["status"] == "verified" for c in checks)
    report = {"ok": ok, "exhaustive": exhaustive, "checks": checks}
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for c in checks:
            line = (f"{c['name']:<24} {c['status']:<9} "
                    f"states={c['states']:<8} trans={c['transitions']:<8} "
                    f"depth={c['max_depth']:<5} {c['elapsed_s']:.1f}s")
            print(line)
            if c["violations"]:
                print(f"  VIOLATED: {c['violations']}  {c['message']}")
                if c["trail"]:
                    print(f"  trail: {c['trail']}")
            elif c["status"] == "bounded":
                print(f"  bound exhausted ({c['bound_reason']}) — NOT a "
                      f"verification result")
        print("result:", "PASS" if ok else "FAIL",
              "(exhaustive)" if exhaustive else "(bounded)")
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# lint / mutants / replay
# ---------------------------------------------------------------------------


def _cmd_lint(args) -> int:
    try:
        rep = lint_paths(args.paths or DEFAULT_LINT_PATHS)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({
            "ok": rep.ok,
            "findings": [dataclasses.asdict(f) for f in rep.findings],
            "bad_waivers": [dataclasses.asdict(f) for f in rep.bad_waivers],
            "waived": [dataclasses.asdict(f) for f in rep.waived],
        }, indent=2))
    else:
        for f in rep.findings:
            print(f)
        for f in rep.bad_waivers:
            print(f)
        print(f"lint: {len(rep.findings)} finding(s), "
              f"{len(rep.bad_waivers)} bad waiver(s), "
              f"{len(rep.waived)} waived")
    return 0 if rep.ok else 1


def _cmd_mutants(args) -> int:
    trail_dir = Path(args.trail_dir)
    sem = AllocatorSemantics(ALLOC_CFG, canonical=True)
    rows, all_ok = [], True
    for name, cls in MUTANTS.items():
        res = coupled_explore(sem, cls, max_states=args.max_states)
        caught = not res.ok
        reproduced = False
        trail = None
        if caught:
            trail = str(_write_trail(trail_dir, f"mutant-{name}", {
                "model": "allocator", "allocator": name,
                "config": dataclasses.asdict(ALLOC_CFG),
                "ops": [list(op) for op in res.ops],
                "message": res.message}))
            try:
                replay_ops(sem, list(res.ops), cls)
            except ConformanceError:
                reproduced = True
        all_ok &= caught and reproduced
        rows.append({"mutant": name, "caught": caught,
                     "reproduced": reproduced, "ops": len(res.ops),
                     "states": res.states, "message": res.message,
                     "trail": trail})
    if args.json:
        print(json.dumps({"ok": all_ok, "mutants": rows}, indent=2))
    else:
        for r in rows:
            print(f"{r['mutant']:<24} caught={r['caught']} "
                  f"reproduced={r['reproduced']} ops={r['ops']}")
            if r["caught"]:
                print(f"  {r['message'][:100]}")
        print("result:", "PASS (checker catches every planted bug)"
              if all_ok else "FAIL (a mutant escaped)")
    return 0 if all_ok else 1


def _scenario_from_json(d: dict) -> ServerScenario:
    return ServerScenario(
        name=d["name"],
        prompts=tuple(tuple(p) for p in d["prompts"]),
        max_new=tuple(d["max_new"]),
        slo=tuple(d.get("slo") or ()),
        deadline=tuple(d.get("deadline") or ()))


def _cmd_replay(args) -> int:
    payload = json.loads(Path(args.trail).read_text())
    ops = [tuple(op) for op in payload["ops"]]
    model = payload["model"]
    print(f"replaying {len(ops)} op(s) from {args.trail} "
          f"(model={model})")
    if model == "allocator":
        cfg = AllocConfig(**payload["config"])
        sem = AllocatorSemantics(cfg, canonical=True)
        cls = MUTANTS.get(payload.get("allocator", "real"))
        from ..runtime.kv import PagedKVAllocator
        try:
            replay_ops(sem, ops, cls or PagedKVAllocator, log=print)
        except ConformanceError as exc:
            print(f"REPRODUCED: {exc}")
            return 1
        print("trail replays clean (no divergence)")
        return 0
    # server/spec trails: guided simulation through the semantics,
    # checking invariants after every op
    if model == "server":
        cfg = ServerConfig(**payload["config"])
        sem = ServerSemantics(cfg, _scenario_from_json(payload["scenario"]))
        invs = server_invariants(cfg)
    elif model == "spec":
        cfg = SpecConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in payload["config"].items()})
        sem = SpecSemantics(cfg)
        invs = spec_invariants(cfg)
    else:
        print(f"unknown trail model {model!r}")
        return 2
    G = sem.init_globals()
    bad: list[str] = []
    for i, op in enumerate(ops):
        sem.apply(G, op)
        bad = violated(invs, G)
        print(f"  [{i}] {op!r}" + (f"  VIOLATES {bad}" if bad else ""))
        if bad:
            break
    if not bad and model == "server":
        bad = drain_incomplete(G)
        for b in bad:
            print(f"  terminal: {b}")
    print("REPRODUCED" if bad else "trail replays clean")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="model-check the serving runtime's state machines")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_check = sub.add_parser("check", help="exhaustive invariant + "
                             "conformance checks on bounded configs")
    p_check.add_argument("--json", action="store_true")
    p_check.add_argument("--max-states", type=int, default=2_000_000)
    p_check.add_argument("--trail-dir", default=DEFAULT_TRAIL_DIR)
    p_check.set_defaults(fn=_cmd_check)

    p_lint = sub.add_parser("lint", help="AST rules over the runtime tree")
    p_lint.add_argument("paths", nargs="*")
    p_lint.add_argument("--json", action="store_true")
    p_lint.set_defaults(fn=_cmd_lint)

    p_mut = sub.add_parser("mutants", help="the checker must catch every "
                           "planted allocator bug")
    p_mut.add_argument("--json", action="store_true")
    p_mut.add_argument("--max-states", type=int, default=200_000)
    p_mut.add_argument("--trail-dir", default=DEFAULT_TRAIL_DIR)
    p_mut.set_defaults(fn=_cmd_mutants)

    p_rep = sub.add_parser("replay", help="re-run a counterexample trail "
                           "against the real code")
    p_rep.add_argument("--trail", required=True)
    p_rep.set_defaults(fn=_cmd_replay)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":   # pragma: no cover
    sys.exit(main())
