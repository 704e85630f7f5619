"""Tuning-parameter search spaces (configuration lattices).

The paper's ``main`` selects each tuning parameter from powers of two
bounded by the input size (Listing 3).  :class:`SearchSpace` generalizes
this: named parameters with finite value lists, cartesian product,
constraint predicates, and export as flat numpy arrays for the vectorized
sweep engine.

The port's own copy of ``repro.core.search_space`` (the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Mapping

import numpy as np


def powers_of_two(lo: int, hi: int) -> tuple[int, ...]:
    """Inclusive powers of two between lo and hi."""

    out = []
    v = 1
    while v <= hi:
        if v >= lo:
            out.append(v)
        v *= 2
    return tuple(out)


@dataclass(frozen=True)
class Param:
    name: str
    values: tuple[Any, ...]


@dataclass
class SearchSpace:
    params: list[Param]
    constraints: list[Callable[[Mapping[str, Any]], bool]] = field(default_factory=list)

    def names(self) -> list[str]:
        return [p.name for p in self.params]

    def __iter__(self) -> Iterator[dict[str, Any]]:
        for combo in itertools.product(*[p.values for p in self.params]):
            cfg = dict(zip(self.names(), combo))
            if all(c(cfg) for c in self.constraints):
                yield cfg

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def size_unconstrained(self) -> int:
        n = 1
        for p in self.params:
            n *= len(p.values)
        return n

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Flat arrays over all constraint-satisfying lattice points."""

        cols: dict[str, list] = {n: [] for n in self.names()}
        for cfg in self:
            for k, v in cfg.items():
                cols[k].append(v)
        return {k: np.asarray(v) for k, v in cols.items()}


def wg_ts_space(size: int, np_elems: int | None = None) -> SearchSpace:
    """The paper's (WG, TS) lattice for input ``size`` (powers of two,
    at least one work item)."""

    space = SearchSpace(params=[
        Param("WG", powers_of_two(1, size)),
        Param("TS", powers_of_two(1, size)),
    ])
    space.constraints.append(lambda c: size // c["TS"] >= 1)
    return space


__all__ = ["Param", "SearchSpace", "powers_of_two", "wg_ts_space"]
