"""The abstract platform's static description (``PlatformSpec``).

The port's copy of the dataclass in ``repro.core.platform``; the
Promela process model built from it (``build_model``) comes with the
explicit-state explorer.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PlatformSpec:
    """Static parameters of the abstract platform + workload.

    size: input data size (power of two), NP: processing elements per unit,
    GMT: global/local memory access-time ratio, L: per-workgroup launch
    overhead, kind: "abstract" | "minimum".
    """

    size: int
    NP: int = 4
    GMT: int = 4
    L: int = 0
    kind: str = "abstract"
    # Optional pinned configuration (skip nondeterministic selection).
    fixed_WG: int | None = None
    fixed_TS: int | None = None

    def config_choices(self) -> list[tuple[int, int]]:
        """All (WG, TS) pairs main may select: powers of two ≤ size,
        restricted by any pinned values."""

        n = self.size.bit_length() - 1
        pows = [1 << i for i in range(0, n + 1)]
        wgs = [self.fixed_WG] if self.fixed_WG is not None else pows
        tss = [self.fixed_TS] if self.fixed_TS is not None else pows
        return [(wg, ts) for wg in wgs for ts in tss]


__all__ = ["PlatformSpec"]
