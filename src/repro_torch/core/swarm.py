"""Swarm search (§5, Fig. 5) — randomized bounded verification (the
port's copy of ``repro.core.swarm``).

SPIN's swarm mode launches many small randomized verifications instead of
one exhaustive run.  Here each *walker* is a randomized walk through the
model (random scheduling + random ``select`` choices), bounded in depth.
Walkers reaching ``FIN`` are counterexamples to Φ_t = G(¬FIN) and carry a
termination time + configuration.

The search strategy follows Fig. 5 verbatim:

1. swarm Φ_t → initial minimal time ``T`` and the swarm's execution time;
2. repeatedly swarm Φ_o(T − 1); if a faster counterexample is found
   within the previous swarm's execution time, lower ``T`` and continue;
   otherwise stop — "the criterion for stopping the search is the ability
   of the swarm to find counterexamples, rather than the number of such
   findings".

``n_workers > 1`` fans walkers out over a thread pool (on real SPIN this
is processes/nodes; the walk is pure Python so threads serialize on the
GIL, but the structure is the same and seeds are independent).
"""

from __future__ import annotations

import time as _time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .counterexample import Counterexample
from .explorer import explore
from .promela import Model
from .properties import NonTermination, OverTime


@dataclass
class SwarmStats:
    walks: int = 0
    counterexamples: int = 0
    rounds: int = 0
    elapsed_s: float = 0.0
    all_found: list[Counterexample] = field(default_factory=list)


@dataclass
class SwarmResult:
    t_min: int
    best: Counterexample
    stats: SwarmStats


def _swarm_round(model: Model, violates, *, n_walks: int, depth_limit: int,
                 seed0: int, n_workers: int, keep_trails: bool,
                 config_vars: tuple[str, ...]) -> list[Counterexample]:
    def walk(seed: int) -> Counterexample | None:
        r = explore(model, violates, schedule="random", seed=seed,
                    depth_limit=depth_limit)
        if r.counterexample is None:
            return None
        cex = Counterexample.from_terminal(r.counterexample, config_vars)
        return cex if keep_trails else Counterexample(
            cex.time, cex.config, (), cex.depth)

    seeds = [seed0 + i for i in range(n_walks)]
    if n_workers > 1:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            found = list(pool.map(walk, seeds))
    else:
        found = [walk(s) for s in seeds]
    return [c for c in found if c is not None]


def swarm_search(
    model: Model,
    *,
    n_walks: int = 16,
    depth_limit: int = 200_000,
    seed: int = 0,
    n_workers: int = 1,
    max_rounds: int = 32,
    keep_trails: bool = False,
    config_vars: tuple[str, ...] = ("WG", "TS"),
) -> SwarmResult:
    """Fig. 5's swarm loop over Φ_t then Φ_o(T−1)."""

    stats = SwarmStats()
    t0 = _time.perf_counter()

    # Round 1: non-termination property Φ_t — every FIN is a counterexample.
    found = _swarm_round(model, NonTermination().violates, n_walks=n_walks,
                         depth_limit=depth_limit, seed0=seed,
                         n_workers=n_workers, keep_trails=keep_trails,
                         config_vars=config_vars)
    stats.walks += n_walks
    stats.rounds += 1
    stats.counterexamples += len(found)
    stats.all_found.extend(found)
    if not found:
        raise RuntimeError("swarm found no terminating execution; "
                           "increase depth_limit or n_walks")
    best = min(found, key=lambda c: c.time)
    prev_exec = _time.perf_counter() - t0

    # Fig. 5 loop: keep asking for strictly better times.
    for round_i in range(max_rounds):
        if best.time <= 0:
            break
        target = OverTime(best.time - 1)
        r0 = _time.perf_counter()
        found = _swarm_round(model, target.violates, n_walks=n_walks,
                             depth_limit=depth_limit,
                             seed0=seed + (round_i + 1) * n_walks,
                             n_workers=n_workers, keep_trails=keep_trails,
                             config_vars=config_vars)
        this_exec = _time.perf_counter() - r0
        stats.walks += n_walks
        stats.rounds += 1
        stats.counterexamples += len(found)
        stats.all_found.extend(found)
        if not found:
            break  # swarm can no longer find counterexamples → stop
        cand = min(found, key=lambda c: c.time)
        if cand.time < best.time:
            best = cand
            prev_exec = this_exec
        elif this_exec > prev_exec:
            break  # slower than the previous swarm → stop (Fig. 5)

    stats.elapsed_s = _time.perf_counter() - t0
    return SwarmResult(t_min=best.time, best=best, stats=stats)


__all__ = ["swarm_search", "SwarmResult", "SwarmStats"]
