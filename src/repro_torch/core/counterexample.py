"""Counterexample analysis (Step 4 of the method; the port's copy of
``repro.core.counterexample``).

SPIN writes a ``.trail`` file which is then re-simulated to read off the
tuning parameters; here the explorer already returns the violating
state's globals and the transition trail.  This module packages that as a
:class:`Counterexample`, supports replay-validation against the model
(the analogue of SPIN's guided simulation), and extracts the tuning
configuration.  The ``explorer``, ``swarm`` and ``bnb`` engines return
one with its trail; ``bisect`` and ``sweep+bisection`` one without.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .explorer import Terminal, replay
from .promela import Model


@dataclass(frozen=True)
class Counterexample:
    time: int
    config: dict[str, Any]
    trail: tuple[str, ...]
    depth: int

    @staticmethod
    def from_terminal(term: Terminal,
                      config_vars: tuple[str, ...] = ("WG", "TS")) -> "Counterexample":
        return Counterexample(
            time=term.globals["time"],
            config={k: term.globals[k] for k in config_vars if k in term.globals},
            trail=term.trail,
            depth=term.depth,
        )

    def validate(self, model: Model, *, fin_var: str = "FIN",
                 time_var: str = "time") -> bool:
        """Replay the trail through the model and confirm it reaches the
        same terminating time — the machine-checked analogue of running
        SPIN's trail simulation."""

        if not self.trail:
            return False
        end = replay(model, self.trail)
        G = dict(end.globals)
        return bool(G[fin_var]) and G[time_var] == self.time


__all__ = ["Counterexample"]
