"""``TuneResult`` — the result dataclass every tuning layer shares (the
port's copy of ``repro.core.autotuner``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from .counterexample import Counterexample


@dataclass
class TuneResult:
    best_config: dict[str, Any]
    t_min: int
    engine: str
    oracle_calls: int = 0
    elapsed_s: float = 0.0
    stats: dict[str, Any] = field(default_factory=dict)
    witness: Counterexample | None = None
    log: Any = None


__all__ = ["TuneResult"]
