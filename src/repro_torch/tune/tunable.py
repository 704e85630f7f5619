"""The ``Tunable`` protocol — the one contract every tunable workload
implements (the paper's Step 1 "model" generalized).  The port's copy of
``repro.tune.tunable``.

A tunable names itself, exposes its configuration lattice
(:class:`~repro_torch.core.search_space.SearchSpace`), prices a configuration
through an analytic cost model (the abstract machine's ``time``), and
fingerprints itself so tuned configs can be cached across runs.  An
optional ``measure(cfg)`` method prices a configuration by actually
executing it (hardware-in-the-loop); engines fall back to ``cost`` when
it is absent.

Implementations live next to their workloads:

* :class:`PlatformTunable` (here) — the paper's abstract OpenCL platform,
* ``MatmulTunable`` / ``ReductionTunable`` / ``SweepEvalTunable`` in
  ``repro_torch.kernels.*.ops`` — the CUDA kernels' launch parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Protocol, runtime_checkable

from ..core.search_space import SearchSpace, wg_ts_space
from ..core.wave_model import WaveParams, model_time


@runtime_checkable
class Tunable(Protocol):
    """What an engine needs to tune a workload.

    ``measure(cfg) -> float`` is an *optional* extra method: when present,
    engines asked to run with ``use_measure=True`` price configurations by
    executing them instead of through ``cost``, and the ``measure`` engine
    shortlists through ``cost`` then lets wall-clock pick the winner.
    A tunable that implements both must report ``cost`` and ``measure``
    in the same unit (the in-tree tunables use microseconds), so modeled
    and measured times stay comparable in results and cache entries.
    """

    name: str

    def space(self) -> SearchSpace:
        """The configuration lattice to search."""
        ...

    def cost(self, cfg: Mapping[str, Any]) -> float:
        """Modeled execution time of one configuration (the machine
        model's ``time`` variable; lower is better, ``inf`` = infeasible)."""
        ...

    def fingerprint(self) -> Mapping[str, Any]:
        """JSON-serializable identity for the persistent cache: everything
        the tuned config depends on *except* the platform (the cache adds
        backend/chip-generation itself)."""
        ...


def _space_fingerprint(space: SearchSpace) -> dict[str, Any]:
    return {"params": {p.name: list(p.values) for p in space.params},
            "n_constraints": len(space.constraints)}


def _function_identity(fn: Callable) -> dict[str, Any]:
    """Best-effort identity of a cost function for cache keying: code
    location + bytecode hash + captured closure values.  Two lambdas
    with the same body but different captured constants (e.g.
    ``lambda c: cost(c, n=n)`` for different n) key differently."""

    import hashlib
    ident: dict[str, Any] = {
        "module": getattr(fn, "__module__", None),
        "qualname": getattr(fn, "__qualname__", repr(fn)),
    }
    code = getattr(fn, "__code__", None)
    if code is not None:
        ident["code_sha"] = hashlib.sha256(
            code.co_code + repr(code.co_consts).encode()).hexdigest()
    closure = getattr(fn, "__closure__", None)
    if closure:
        try:
            ident["closure"] = [repr(c.cell_contents) for c in closure]
        except ValueError:                             # pragma: no cover
            pass
    return ident


class FunctionTunable:
    """Adapt a bare ``cost_fn`` + space to the protocol (the seed's
    ``FunctionTuner`` calling convention).

    For reliable caching pass an explicit ``fingerprint``; the default
    derives one from the space plus the cost function's code/closure
    identity (best effort — opaque callables without ``__code__`` fall
    back to their repr)."""

    def __init__(self, cost_fn: Callable[[Mapping[str, Any]], float],
                 space: SearchSpace, *, name: str = "function",
                 fingerprint: Mapping[str, Any] | None = None):
        self._cost_fn = cost_fn
        self._space = space
        self.name = name
        self._fingerprint = fingerprint

    def space(self) -> SearchSpace:
        return self._space

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return self._cost_fn(cfg)

    def fingerprint(self) -> Mapping[str, Any]:
        if self._fingerprint is not None:
            return dict(self._fingerprint)
        return {"tunable": self.name,
                "cost_fn": _function_identity(self._cost_fn),
                "space": _space_fingerprint(self._space)}


class PlatformTunable:
    """The paper's abstract platform as a tunable: the (WG, TS) lattice
    priced by the closed-form wave model; the explicit-state engines
    additionally read ``spec``/``config_vars`` to build the full process
    model and search it with counterexample oracles."""

    def __init__(self, spec, space: SearchSpace | None = None,
                 config_vars: tuple[str, ...] = ("WG", "TS")):
        self.spec = spec
        self.config_vars = config_vars
        self._space = space
        self.wave = WaveParams(size=spec.size, NP=spec.NP, GMT=spec.GMT,
                               L=spec.L, kind=spec.kind)
        self.name = f"platform.{spec.kind}"

    def space(self) -> SearchSpace:
        return self._space if self._space is not None \
            else wg_ts_space(self.spec.size)

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return model_time(self.wave, cfg["WG"], cfg["TS"])

    def fingerprint(self) -> Mapping[str, Any]:
        s = self.spec
        fp: dict[str, Any] = {
            "tunable": self.name, "size": s.size, "NP": s.NP,
            "GMT": s.GMT, "L": s.L, "kind": s.kind,
            "fixed_WG": s.fixed_WG, "fixed_TS": s.fixed_TS,
            "config_vars": list(self.config_vars)}
        if self._space is not None:     # restricted lattice ≠ full lattice
            fp["space"] = _space_fingerprint(self._space)
        return fp


__all__ = ["Tunable", "FunctionTunable", "PlatformTunable"]
