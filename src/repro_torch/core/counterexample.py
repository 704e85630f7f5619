"""Counterexample: the witness of the paper's Step 4.

A counterexample to the over-time property Φ_o(T) is a schedule that
terminates by time ``T``; its configuration is the tuning answer.  The
port's copy of ``repro.core.counterexample`` without the Promela-side
constructors (``from_terminal``) and the trail replay (``validate``),
which need the explicit-state explorer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Counterexample:
    time: int
    config: dict[str, Any]
    trail: tuple[str, ...]
    depth: int


__all__ = ["Counterexample"]
