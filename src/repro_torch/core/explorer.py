"""Explicit-state exploration engine (the SPIN stand-in; the port's copy
of ``repro.core.explorer``).

Implements Step 3's verification runs: search the model's state space for
a state violating a safety-style property (the paper's Φ_o in the form
``G(FIN → time > T)``; a violation is a reachable state with
``FIN ∧ time ≤ T`` — the counterexample).

Schedules:

* ``"full"``   — all interleavings (textbook DFS; exponential, for tiny
  instances and the interleaving-invariance proof),
* ``"por"``    — partial-order reduction: at each state only the first
  process with enabled transitions is scheduled, keeping all of *its*
  branches (choice nondeterminism, e.g. ``select``, is preserved).  Sound
  for time-optimality because model time is interleaving-invariant
  (tested property: ``tests/test_torch_promela.py``),
* ``"random"`` — a single randomized walk (the swarm building block),
  bounded by depth; choices and scheduling are resolved by the RNG.

State hashing uses Python's ``hash`` over the immutable state (SPIN's
hash-compact analogue).  ``max_states``/``depth_limit`` bound the search
(SPIN's ``-m``).
"""

from __future__ import annotations

import random
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable

from .promela import Model, State


@dataclass
class Terminal:
    """A reached end state (deadlock or FIN): its globals and trail."""

    globals: dict[str, Any]
    trail: tuple[str, ...]
    depth: int


@dataclass
class ExploreResult:
    property_holds: bool                  # True = no counterexample found
    counterexample: Terminal | None       # first violating state (trail)
    states: int = 0
    transitions: int = 0
    max_depth: int = 0
    terminals: list[Terminal] = field(default_factory=list)
    truncated: bool = False               # hit a bound
    elapsed_s: float = 0.0
    frontier_peak: int = 0                # max DFS stack depth observed
    bound_reason: str | None = None       # "max_states" | "depth_limit"

    @property
    def status(self) -> str:
        """Three-way verdict: a truncated run that found no violation is
        ``"bounded"`` — the bound was exhausted, which is NOT a proof —
        while an exhaustive clean run is ``"verified"``."""

        if not self.property_holds:
            return "violated"
        return "bounded" if self.truncated else "verified"


def explore(
    model: Model,
    violates: Callable[[dict], bool],
    *,
    schedule: str = "por",
    seed: int = 0,
    depth_limit: int = 1_000_000,
    max_states: int = 5_000_000,
    stop_on_first: bool = True,
    collect_terminals: bool = False,
    keep_trails: bool = True,
    branch_and_bound: str | None = None,
    on_violation: Callable[[Terminal], None] | None = None,
) -> ExploreResult:
    """DFS for a reachable state with ``violates(globals)``.

    ``violates`` receives the state's global variables as a dict.  The
    trail of the first violation (or of every terminal if
    ``collect_terminals``) is recorded for Step 4's analysis.

    ``branch_and_bound="time"`` enables the Ruys-style optimization the
    paper cites as future work ([11] "Optimal Scheduling Using Branch
    and Bound with SPIN"): model time is monotone along every path, so
    any state whose time already reaches the best terminal time found
    cannot lead to a better one and is pruned — the minimal time drops
    out of ONE verification run instead of a bisection of runs.

    ``on_violation`` streams every violating terminal to the caller as
    it is found (useful with ``stop_on_first=False`` on large models
    where waiting for the full sweep wastes the early signal).  The
    result's ``status`` property distinguishes an exhaustive clean
    sweep (``"verified"``) from one that merely ran out of budget
    (``"bounded"``, with ``bound_reason`` naming the bound hit).
    """

    t0 = _time.perf_counter()
    res = ExploreResult(property_holds=True, counterexample=None)
    rng = random.Random(seed)

    init = model.initial_state()
    if schedule == "random":
        return _random_walk(model, violates, rng, depth_limit, res, t0,
                            collect_terminals=collect_terminals)

    visited: set[int] = set()
    # stack entries: (state, trail tuple)
    stack: list[tuple[State, tuple[str, ...]]] = [(init, ())]
    visited.add(hash(init))
    res.states = 1
    best_time: int | None = None   # branch-and-bound incumbent

    while stack:
        res.frontier_peak = max(res.frontier_peak, len(stack))
        state, trail = stack.pop()
        res.max_depth = max(res.max_depth, len(trail))
        G = dict(state.globals)

        if branch_and_bound == "time":
            if best_time is not None and G.get("time", 0) >= best_time:
                continue            # prune: time is monotone along paths
            if G.get("FIN"):
                best_time = G["time"]
                term = Terminal(G, trail if keep_trails else (), len(trail))
                res.counterexample = term   # current best witness
                res.property_holds = False
                if collect_terminals:
                    res.terminals.append(term)
                continue

        if violates(G):
            term = Terminal(G, trail if keep_trails else (), len(trail))
            if res.counterexample is None:
                res.counterexample = term
            res.property_holds = False
            if collect_terminals:
                res.terminals.append(term)
            if on_violation is not None:
                on_violation(term)
            if stop_on_first:
                break
            continue

        succ = model.successors(state)
        if not succ:
            if collect_terminals:
                res.terminals.append(
                    Terminal(G, trail if keep_trails else (), len(trail)))
            continue

        if schedule == "por":
            # partial-order + symmetry reduction: schedule only the first
            # enabled process; among its transitions keep all *choices*
            # (select / multi-guard if), else a single representative —
            # rendezvous fan-out over symmetric receivers (the paper's
            # "every unit/pex works in exactly the same manner") is
            # collapsed.  Sound for time-optimality: model time is
            # interleaving-invariant (tested).
            first_pid = succ[0].pid
            mine = [t for t in succ if t.pid == first_pid]
            choices = [t for t in mine if t.is_choice]
            succ = choices if choices else mine[:1]

        if len(trail) >= depth_limit:
            res.truncated = True
            res.bound_reason = res.bound_reason or "depth_limit"
            continue

        for tr in succ:
            res.transitions += 1
            h = hash(tr.state)
            if h in visited:
                continue
            visited.add(h)
            res.states += 1
            if res.states > max_states:
                res.truncated = True
                res.bound_reason = "max_states"
                stack.clear()
                break
            stack.append((tr.state, trail + (tr.label,) if keep_trails else ()))

    res.elapsed_s = _time.perf_counter() - t0
    return res


def _random_walk(model, violates, rng, depth_limit, res, t0, *,
                 collect_terminals=False) -> ExploreResult:
    state = model.initial_state()
    trail: tuple[str, ...] = ()
    res.states = 1
    for _ in range(depth_limit):
        G = dict(state.globals)
        if violates(G):
            res.counterexample = Terminal(G, trail, len(trail))
            res.property_holds = False
            break
        succ = model.successors(state)
        if not succ:
            if collect_terminals:
                res.terminals.append(Terminal(G, trail, len(trail)))
            break
        tr = rng.choice(succ)
        res.transitions += 1
        res.states += 1
        state = tr.state
        trail = trail + (tr.label,)
    else:
        res.truncated = True
        res.bound_reason = "depth_limit"
    res.max_depth = len(trail)
    res.elapsed_s = _time.perf_counter() - t0
    return res


def replay(model: Model, trail: tuple[str, ...]) -> State:
    """Replay a trail (sequence of transition labels) from the initial
    state; used to validate counterexamples (SPIN's trail simulation)."""

    state = model.initial_state()
    for label in trail:
        succ = model.successors(state)
        matches = [t for t in succ if t.label == label]
        if not matches:
            raise ValueError(f"trail diverged at {label!r}")
        state = matches[0].state
    return state


__all__ = ["explore", "replay", "ExploreResult", "Terminal"]
