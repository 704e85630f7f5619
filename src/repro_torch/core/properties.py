"""Property formulations (Step 2 of the counterexample method; the
port's copy of ``repro.core.properties``).

The paper expresses the tuning objective as LTL over the model:

* over-time      Φ_o = G(FIN → time > T)
  — "whenever the program terminates, more than T time units have
  passed".  A counterexample is an execution reaching ``FIN`` with
  ``time ≤ T``; its configuration is a candidate tuning.
* non-termination Φ_t = G(¬FIN)
  — used in swarm mode (§5): any path reaching FIN is a counterexample
  and carries a termination time.

For the state-reachability engine these reduce to *violation predicates*
over a state's globals (both formulas are of the form ``G p`` with a
state predicate ``p``, so a counterexample is exactly a reachable state
with ``¬p``).  ``trace_satisfies`` provides the genuine LTL-over-a-trace
check used by tests to confirm the reduction is faithful.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class OverTime:
    """Φ_o = G(FIN → time > T)."""

    T: int
    fin_var: str = "FIN"
    time_var: str = "time"

    def state_ok(self, G: dict) -> bool:
        return (not G[self.fin_var]) or (G[self.time_var] > self.T)

    def violates(self, G: dict) -> bool:
        return bool(G[self.fin_var]) and G[self.time_var] <= self.T


@dataclass(frozen=True)
class NonTermination:
    """Φ_t = G(¬FIN)."""

    fin_var: str = "FIN"

    def state_ok(self, G: dict) -> bool:
        return not G[self.fin_var]

    def violates(self, G: dict) -> bool:
        return bool(G[self.fin_var])


def trace_satisfies(prop, trace: Sequence[dict]) -> bool:
    """Evaluate ``G p`` over a concrete finite trace of global states."""

    return all(prop.state_ok(G) for G in trace)


__all__ = ["OverTime", "NonTermination", "trace_satisfies"]
