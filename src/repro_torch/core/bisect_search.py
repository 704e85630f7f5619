"""Minimal-termination-time search (Step 3, Fig. 1 bisection).

``cex_oracle(T)`` plays the role of the paper's predicate ``C_ex(T)``:
it runs a verification of Φ_o(T) and returns the counterexample (or
``None``).  Any engine works as oracle — the explicit-state explorer,
the swarm, or the vectorized sweep.

The paper's Fig. 1 bisects on T; we add *witness acceleration*: every
counterexample reaching time ``t ≤ T`` lets us jump the upper bound to
``t`` directly (each counterexample is a feasible schedule, so ``T_min ≤
t``).  The loop ends when Φ_o(T_min − 1) is verified (no counterexample)
— exactly the paper's termination condition.

The port's own copy of ``repro.core.bisect_search``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from .counterexample import Counterexample


@dataclass
class BisectionLog:
    queries: list[tuple[int, bool, int | None]] = field(default_factory=list)

    def record(self, T: int, found: bool, t: int | None) -> None:
        self.queries.append((T, found, t))


@dataclass
class BisectionResult:
    t_min: int
    witness: Counterexample
    log: BisectionLog
    oracle_calls: int


def find_minimal_time(
    cex_oracle: Callable[[int], Counterexample | None],
    *,
    t_ini: int,
    t_max_doublings: int = 20,
) -> BisectionResult:
    """Find T_min = the minimal reachable termination time.

    ``t_ini`` comes from a simulation run (the paper suggests SPIN's
    simulation mode); if no counterexample exists at ``t_ini`` the bound
    is doubled (the program is slower than the simulated estimate)."""

    log = BisectionLog()
    calls = 0

    # Establish a feasible upper bound.
    T = t_ini
    witness = None
    for _ in range(t_max_doublings):
        calls += 1
        witness = cex_oracle(T)
        log.record(T, witness is not None, witness.time if witness else None)
        if witness is not None:
            break
        T = max(T * 2, T + 1)
    if witness is None:
        raise RuntimeError(f"no terminating execution found up to T={T}")

    best = witness
    hi = best.time          # T_min <= hi (feasible)
    lo = 0                  # largest T proven infeasible is lo-1 => T_min >= lo

    # Invariant: lo <= T_min <= hi;  Cex(hi) known-found (== best).
    while lo < hi:
        mid = (lo + hi) // 2
        calls += 1
        w = cex_oracle(mid)
        log.record(mid, w is not None, w.time if w else None)
        if w is not None:
            best = w if w.time < best.time else best
            hi = w.time     # witness acceleration
        else:
            lo = mid + 1

    return BisectionResult(t_min=hi, witness=best, log=log, oracle_calls=calls)


__all__ = ["find_minimal_time", "BisectionResult", "BisectionLog"]
