"""Engine registry: pluggable search backends behind one interface (the
port's copy of ``repro.tune.engines``).

Every engine answers the same question — *the minimal reachable
termination time and a configuration witnessing it* — through
``Engine.run(tunable, budget=...) -> TuneResult``; engines register under
a name with :func:`register_engine` and :func:`get_engine` resolves them.

========== ==================================================================
``grid``    exhaustive cost-model scan (any tunable; alias ``function``)
``bisect``  Fig. 1 bisection with a cost-table C_ex oracle (any tunable)
``measure`` cost-model shortlist, measured verdict (tunables with measure)
``sweep``   vectorized lattice sweep over the wave model (platform tunables)
``explorer`` explicit-state DFS, SPIN-faithful (platform tunables)
``swarm``   Fig. 5 randomized bounded search (platform tunables)
``bnb``     Ruys-style branch-and-bound, one verification run (platform)
========== ==================================================================
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Type

from ..core import bisect_search, explorer, platform, properties, swarm, sweep
from ..core.autotuner import TuneResult
from ..core.counterexample import Counterexample
from ..core.wave_model import model_time
from ..kernels.common import median


class EngineError(ValueError):
    """An engine cannot run on the given tunable."""


class Engine:
    """Common interface: ``run(tunable, budget=None, **kw) -> TuneResult``.

    ``budget`` bounds the engine's work in engine-specific units
    (configurations evaluated, shortlist size, states explored, walks);
    ``None`` means the engine's own default.
    """

    name: str = ""

    def run(self, tunable, *, budget: int | None = None, **kw) -> TuneResult:
        raise NotImplementedError


_REGISTRY: dict[str, Type[Engine]] = {}


def register_engine(name: str):
    """Class decorator: ``@register_engine("sweep")`` adds an
    :class:`Engine` subclass to the registry under ``name`` (a class may
    register under several aliases)."""

    def deco(cls: Type[Engine]) -> Type[Engine]:
        _REGISTRY[name] = cls
        if not cls.name:
            cls.name = name
        return cls
    return deco


def get_engine(name: str) -> Engine:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered engines: "
            f"{', '.join(sorted(_REGISTRY))}") from None
    inst = cls()
    inst.name = name
    return inst


def available_engines() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _require_platform(tunable, engine: str):
    spec = getattr(tunable, "spec", None)
    if spec is None:
        raise EngineError(
            f"engine {engine!r} needs a platform tunable (an object with a "
            f"PlatformSpec `spec` attribute, e.g. repro_torch.tune."
            f"PlatformTunable); got {type(tunable).__name__}")
    return spec


def _config_vars(tunable) -> tuple[str, ...]:
    return tuple(getattr(tunable, "config_vars", ("WG", "TS")))


def _explorer_oracle(model, config_vars, *, schedule="por",
                     max_states=2_000_000):
    def oracle(T: int) -> Counterexample | None:
        prop = properties.OverTime(T)
        r = explorer.explore(model, prop.violates, schedule=schedule,
                             max_states=max_states)
        if r.counterexample is None:
            return None
        return Counterexample.from_terminal(r.counterexample, config_vars)
    return oracle


def _simulate_t_ini(model) -> int:
    """The paper obtains T_ini from a SPIN simulation run: one random
    walk to FIN reads off a feasible termination time."""

    for seed in range(16):
        r = explorer.explore(model, properties.NonTermination().violates,
                             schedule="random", seed=seed,
                             depth_limit=2_000_000)
        if r.counterexample is not None:
            return int(r.counterexample.globals["time"])
    raise RuntimeError("simulation never reached FIN")


def _eval_fn(tunable, use_measure: bool):
    if use_measure:
        measure = getattr(tunable, "measure", None)
        if not callable(measure):
            raise EngineError(
                f"use_measure=True but {type(tunable).__name__} has no "
                f"measure(cfg) method")
        return measure
    return tunable.cost


# ---------------------------------------------------------------------------
# generic engines (any Tunable)
# ---------------------------------------------------------------------------


@register_engine("grid")
@register_engine("function")
class GridEngine(Engine):
    """Exhaustive scan of the lattice through the cost model
    (first-wins tie-break)."""

    def run(self, tunable, *, budget: int | None = None,
            keep_trace: bool = False, use_measure: bool = False
            ) -> TuneResult:
        evaluate = _eval_fn(tunable, use_measure)
        best_cfg, best_t = None, None
        trace: list[tuple[float, dict]] = []
        n = 0
        for cfg in tunable.space():
            if budget is not None and n >= budget:
                break
            t = evaluate(cfg)
            n += 1
            if keep_trace:
                trace.append((t, dict(cfg)))
            if best_t is None or t < best_t:
                best_cfg, best_t = dict(cfg), t
        if best_cfg is None:
            raise RuntimeError("empty search space")
        stats: dict[str, Any] = {"evaluated": n}
        if keep_trace:
            stats["trace"] = trace
        return TuneResult(best_config=best_cfg, t_min=best_t,
                          engine=self.name, oracle_calls=n, stats=stats)


@register_engine("bisect")
class BisectEngine(Engine):
    """The paper's Fig. 1 protocol over an arbitrary cost tunable: the
    cost table answers C_ex(T) and :func:`find_minimal_time` bisects.
    Times are rounded to integers (the paper's setting); use ``grid``
    for fractional cost models."""

    def run(self, tunable, *, budget: int | None = None,
            use_measure: bool = False) -> TuneResult:
        evaluate = _eval_fn(tunable, use_measure)
        table: list[tuple[int, dict]] = []
        for i, cfg in enumerate(tunable.space()):
            if budget is not None and i >= budget:
                break
            t = evaluate(cfg)
            if math.isfinite(t):
                table.append((int(round(t)), dict(cfg)))
        if not table:
            raise RuntimeError("empty search space")

        def oracle(T: int) -> Counterexample | None:
            ok = [e for e in table if e[0] <= T]
            if not ok:
                return None
            t, cfg = min(ok, key=lambda e: e[0])
            return Counterexample(time=t, config=cfg, trail=(), depth=0)

        t_ini = max(t for t, _ in table)
        br = bisect_search.find_minimal_time(oracle, t_ini=t_ini)
        return TuneResult(best_config=br.witness.config, t_min=br.t_min,
                          engine=self.name, oracle_calls=br.oracle_calls,
                          witness=br.witness, log=br.log,
                          stats={"evaluated": len(table)})


@register_engine("measure")
class MeasureEngine(Engine):
    """Model-guided empirical tuning.

    Score every configuration through ``cost``, shortlist the ``top_k``
    best modeled points (``budget`` overrides ``top_k``), time each
    candidate for real through the tunable's ``measure(cfg)`` — median
    of ``repeats`` calls, with the warmup discipline inside ``measure``
    itself — and return the measured winner.  The shortlist always holds
    the pure cost-model pick, so the winner's measured time is ≤ the
    modeled pick's.  ``stats`` records both rankings
    (``provenance="measured"``)."""

    def run(self, tunable, *, budget: int | None = None, top_k: int = 4,
            repeats: int = 3) -> TuneResult:
        measure = getattr(tunable, "measure", None)
        if not callable(measure):
            raise EngineError(
                f"engine 'measure' needs a tunable with a measure(cfg) "
                f"method (hardware-in-the-loop oracle); "
                f"got {type(tunable).__name__}")

        scored: list[tuple[float, dict]] = []
        for cfg in tunable.space():
            t = tunable.cost(cfg)
            if math.isfinite(t):
                scored.append((t, dict(cfg)))
        if not scored:
            raise RuntimeError("empty search space (all configs infeasible)")
        scored.sort(key=lambda e: e[0])

        k = top_k if budget is None else budget
        k = max(1, min(len(scored), k))
        # warm up once per candidate, not once per repeat: later repeats
        # ask measure to skip its internal warmup when it supports it
        try:
            warmup_aware = "warmup" in inspect.signature(measure).parameters
        except (TypeError, ValueError):                # pragma: no cover
            warmup_aware = False
        candidates: list[dict[str, Any]] = []
        for modeled, cfg in scored[:k]:
            times = []
            for rep in range(max(1, repeats)):
                kw = {"warmup": 0} if (rep and warmup_aware) else {}
                times.append(float(measure(cfg, **kw)))
            times.sort()
            candidates.append({"config": cfg, "modeled": modeled,
                               "measured": median(times),
                               "samples": times})
        best = min(candidates, key=lambda c: c["measured"])
        modeled_pick = candidates[0]            # scored[0] = model's argmin
        return TuneResult(
            best_config=dict(best["config"]), t_min=best["measured"],
            engine=self.name,
            oracle_calls=len(candidates) * max(1, repeats),
            stats={"provenance": "measured",
                   "evaluated": len(scored), "shortlist": k,
                   "repeats": repeats,
                   "modeled_pick": {"config": dict(modeled_pick["config"]),
                                    "modeled": modeled_pick["modeled"],
                                    "measured": modeled_pick["measured"]},
                   "measured_pick": {"config": dict(best["config"]),
                                     "modeled": best["modeled"],
                                     "measured": best["measured"]},
                   "candidates": [{"config": dict(c["config"]),
                                   "modeled": c["modeled"],
                                   "measured": c["measured"]}
                                  for c in candidates]})


# ---------------------------------------------------------------------------
# platform engines (the paper's search backends)
# ---------------------------------------------------------------------------


@register_engine("sweep")
class SweepEngine(Engine):
    """Vectorized lattice evaluation over the closed-form wave model;
    with ``use_bisection=True`` the sweep plays the C_ex oracle inside
    the paper's Fig. 1 loop."""

    def run(self, tunable, *, budget: int | None = None,
            use_bisection: bool = False) -> TuneResult:
        _require_platform(tunable, self.name)
        wave = tunable.wave
        space = tunable.space()
        if use_bisection:
            oracle = sweep.cex_oracle(wave, space)
            t_ini = model_time(wave, WG=1, TS=1)  # trivially feasible config
            br = bisect_search.find_minimal_time(oracle, t_ini=t_ini)
            return TuneResult(best_config=br.witness.config, t_min=br.t_min,
                              engine="sweep+bisection",
                              oracle_calls=br.oracle_calls,
                              witness=br.witness, log=br.log)
        r = sweep.sweep_times(wave, space)
        return TuneResult(best_config=r.best_config, t_min=r.t_min,
                          engine=self.name, oracle_calls=1,
                          stats={"evaluated": r.evaluated})


@register_engine("explorer")
class ExplorerEngine(Engine):
    """Explicit-state search (SPIN-faithful).  ``mode="collect"`` is the
    paper's §6 optimization: one exploration with Φ_t collects *all*
    terminating executions, and the bisection answers from the table;
    ``mode="bisect"`` re-explores per bisection query."""

    def run(self, tunable, *, budget: int | None = None,
            schedule: str = "por", mode: str = "collect",
            max_states: int = 2_000_000) -> TuneResult:
        spec = _require_platform(tunable, self.name)
        config_vars = _config_vars(tunable)
        if budget is not None:
            max_states = budget
        model = platform.build_model(spec)
        if mode == "collect":
            r = explorer.explore(model, properties.NonTermination().violates,
                                 schedule=schedule, max_states=max_states,
                                 stop_on_first=False, collect_terminals=True)
            if not r.terminals:
                raise RuntimeError("no terminating executions found")
            table = [Counterexample.from_terminal(t, config_vars)
                     for t in r.terminals]

            def oracle(T: int) -> Counterexample | None:
                ok = [c for c in table if c.time <= T]
                return min(ok, key=lambda c: c.time) if ok else None

            t_ini = max(c.time for c in table)
            br = bisect_search.find_minimal_time(oracle, t_ini=t_ini)
            return TuneResult(best_config=br.witness.config, t_min=br.t_min,
                              engine=f"explorer/{schedule}+collect",
                              oracle_calls=br.oracle_calls,
                              witness=br.witness, log=br.log,
                              stats={"states": r.states,
                                     "terminals": len(table)})
        oracle = _explorer_oracle(model, config_vars, schedule=schedule,
                                  max_states=max_states)
        t_ini = _simulate_t_ini(model)
        br = bisect_search.find_minimal_time(oracle, t_ini=t_ini)
        return TuneResult(best_config=br.witness.config, t_min=br.t_min,
                          engine=f"explorer/{schedule}",
                          oracle_calls=br.oracle_calls, witness=br.witness,
                          log=br.log)


@register_engine("swarm")
class SwarmEngine(Engine):
    """Fig. 5 randomized bounded search (budget = number of walks).
    ``keep_trails=True`` keeps the witness's trail, so that it can be
    replayed (``Counterexample.validate``); the reference's engine
    drops it, and so does this one by default."""

    def run(self, tunable, *, budget: int | None = None, n_walks: int = 16,
            depth_limit: int = 500_000, seed: int = 0, n_workers: int = 1,
            keep_trails: bool = False) -> TuneResult:
        spec = _require_platform(tunable, self.name)
        if budget is not None:
            n_walks = budget
        model = platform.build_model(spec)
        sr = swarm.swarm_search(model, n_walks=n_walks,
                                depth_limit=depth_limit, seed=seed,
                                n_workers=n_workers, keep_trails=keep_trails,
                                config_vars=_config_vars(tunable))
        return TuneResult(best_config=sr.best.config, t_min=sr.t_min,
                          engine=self.name, oracle_calls=sr.stats.rounds,
                          witness=sr.best,
                          stats={"walks": sr.stats.walks,
                                 "counterexamples": sr.stats.counterexamples})


@register_engine("bnb")
class BranchAndBoundEngine(Engine):
    """Ruys-style branch-and-bound (paper §8 future work [11]): the
    minimal time from ONE verification run — no bisection."""

    def run(self, tunable, *, budget: int | None = None,
            schedule: str = "por", max_states: int = 5_000_000
            ) -> TuneResult:
        spec = _require_platform(tunable, self.name)
        if budget is not None:
            max_states = budget
        model = platform.build_model(spec)
        r = explorer.explore(model, lambda G: False, schedule=schedule,
                             branch_and_bound="time", stop_on_first=False,
                             max_states=max_states)
        if r.counterexample is None:
            raise RuntimeError("no terminating execution found")
        cex = Counterexample.from_terminal(r.counterexample,
                                           _config_vars(tunable))
        return TuneResult(best_config=cex.config, t_min=cex.time,
                          engine=f"bnb/{schedule}", oracle_calls=1,
                          witness=cex, stats={"states": r.states})


__all__ = ["Engine", "EngineError", "register_engine", "get_engine",
           "available_engines", "GridEngine", "BisectEngine", "MeasureEngine",
           "SweepEngine", "ExplorerEngine", "SwarmEngine",
           "BranchAndBoundEngine"]
