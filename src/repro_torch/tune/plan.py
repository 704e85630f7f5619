"""Declarative batches of tuning work (the port's copy of
``repro.tune.plan``).

A :class:`TuningPlan` is a list of :class:`TuningJob`\\ s (tunable or
factory, engine, engine kwargs), built with :meth:`TuningPlan.add` or
from a dict/JSON spec with :meth:`TuningPlan.from_spec`, and executed by
:meth:`TuningPlan.run` against a :class:`~repro_torch.tune.TuningCache`
— skip-on-hit, ``force=`` override, per-job error isolation, optional
``workers=N`` thread-pool execution of the jobs that time nothing, and
a summary :class:`PlanReport`.

Spec format (JSON or dict)::

    {"name": "warmup",
     "jobs": [
       {"tunable": "platform.minimum",
        "params": {"size": 1048576, "NP": 128, "GMT": 16, "L": 8},
        "engine": "sweep"},
       {"tunable": "kernels.tuned_reduction",
        "grid": {"n": [65536, 1048576]},            # expands to 2 jobs
        "engine": "measure", "engine_kwargs": {"repeats": 3}}]}

``tunable`` names resolve through a registry (:func:`register_tunable`):
``platform.abstract``, ``platform.minimum``, ``kernels.tuned_reduction``,
``kernels.sweep_eval``, ``kernels.matmul_tuned`` and
``kernels.flash_attention`` are pre-registered.
``grid`` expands list-valued entries into the cartesian product of jobs.
"""

from __future__ import annotations

import itertools
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

from ..core.autotuner import TuneResult
from ..core.platform import PlatformSpec
from .api import _resolve_engine_name, tune
from .cache import TuningCache, cache_key, default_cache
from .tunable import PlatformTunable

# ---------------------------------------------------------------------------
# tunable registry (name -> factory), for dict/JSON plan specs
# ---------------------------------------------------------------------------

_FACTORIES: dict[str, Callable[..., Any]] = {}


def register_tunable(name: str):
    """``@register_tunable("kernels.mykernel")`` — make a tunable factory
    addressable from plan specs.  The factory receives the spec's
    ``params`` as keyword arguments and returns a Tunable."""

    def deco(factory: Callable[..., Any]) -> Callable[..., Any]:
        _FACTORIES[name] = factory
        return factory
    return deco


def available_tunables() -> tuple[str, ...]:
    _ensure_builtin_factories()
    return tuple(sorted(_FACTORIES))


def build_tunable(name: str, params: Mapping[str, Any] | None = None):
    """Resolve ``name`` in the registry and build the tunable."""

    _ensure_builtin_factories()
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"unknown tunable {name!r}; registered: "
            f"{', '.join(sorted(_FACTORIES))}") from None
    return factory(**dict(params or {}))


_builtins_loaded = False


def _ensure_builtin_factories() -> None:
    # deferred: the kernel modules import repro_torch.tune for @autotune,
    # so registering them at plan-import time would be circular
    global _builtins_loaded
    if _builtins_loaded:
        return

    from ..kernels.flash_attention.ops import FlashAttentionTunable
    from ..kernels.matmul_tuned.ops import MatmulTunable
    from ..kernels.sweep_eval.ops import SweepEvalTunable
    from ..kernels.tuned_reduction.ops import ReductionTunable
    _FACTORIES.setdefault("kernels.flash_attention", FlashAttentionTunable)
    _FACTORIES.setdefault("kernels.matmul_tuned", MatmulTunable)
    _FACTORIES.setdefault("kernels.tuned_reduction", ReductionTunable)
    _FACTORIES.setdefault("kernels.sweep_eval", SweepEvalTunable)
    for kind in ("abstract", "minimum"):
        _FACTORIES.setdefault(
            f"platform.{kind}",
            lambda kind=kind, **spec_kw: PlatformTunable(
                PlatformSpec(kind=kind, **spec_kw)))
    _builtins_loaded = True


# ---------------------------------------------------------------------------
# jobs / plan / report
# ---------------------------------------------------------------------------


@dataclass
class TuningJob:
    """One unit of a plan: a tunable (or zero-arg factory of one), the
    engine to run it with, and the engine kwargs.  ``factory`` is called
    inside :meth:`TuningPlan.run`'s per-job error boundary, so a job
    whose construction fails is an isolated failure, not a crash."""

    factory: Callable[[], Any] | Any
    engine: str = "auto"
    engine_kwargs: dict[str, Any] = field(default_factory=dict)
    label: str = ""
    force: bool = False
    # this job TIMES things (measure engine), so a parallel run must not
    # let other jobs' load pollute its samples
    timed: bool = False

    def materialize(self):
        tunable = self.factory
        if callable(tunable) and not hasattr(tunable, "space"):
            tunable = tunable()
        if not self.label:
            self.label = getattr(tunable, "name", type(tunable).__name__)
        return tunable


@dataclass
class JobResult:
    label: str
    status: str                 # hit | tuned | forced | failed
    engine: str = ""
    t_min: float | None = None
    best_config: dict[str, Any] | None = None
    provenance: str | None = None
    key: str | None = None
    elapsed_s: float = 0.0
    error: str | None = None
    result: TuneResult | None = field(default=None, repr=False)

    def to_json(self) -> dict[str, Any]:
        return {"label": self.label, "status": self.status,
                "engine": self.engine, "t_min": self.t_min,
                "best_config": self.best_config,
                "provenance": self.provenance, "key": self.key,
                "elapsed_s": round(self.elapsed_s, 6), "error": self.error}


@dataclass
class PlanReport:
    plan: str
    results: list[JobResult] = field(default_factory=list)

    @property
    def counts(self) -> dict[str, int]:
        c = {"jobs": len(self.results), "hits": 0, "tuned": 0,
             "forced": 0, "failed": 0}
        bucket = {"hit": "hits", "tuned": "tuned", "forced": "forced",
                  "failed": "failed"}
        for r in self.results:
            c[bucket[r.status]] += 1
        return c

    @property
    def ok(self) -> bool:
        return self.counts["failed"] == 0

    def summary(self) -> str:
        c = self.counts
        return (f"plan {self.plan!r}: {c['jobs']} jobs — {c['hits']} hits, "
                f"{c['tuned']} tuned, {c['forced']} forced, "
                f"{c['failed']} failed")

    def to_json(self) -> dict[str, Any]:
        return {"plan": self.plan, "counts": self.counts,
                "jobs": [r.to_json() for r in self.results]}


class TuningPlan:
    """A declarative batch of tuning jobs; see the module docstring."""

    def __init__(self, jobs: Sequence[TuningJob] | None = None, *,
                 name: str = "plan"):
        self.name = name
        self.jobs: list[TuningJob] = list(jobs or [])

    def add(self, tunable_or_factory, engine: str = "auto", *,
            label: str = "", force: bool = False,
            **engine_kwargs: Any) -> TuningJob:
        """Append a job (a Tunable instance or a zero-arg factory);
        returns it for further tweaking."""

        job = TuningJob(factory=tunable_or_factory, engine=engine,
                        engine_kwargs=dict(engine_kwargs), label=label,
                        force=force, timed=engine == "measure")
        self.jobs.append(job)
        return job

    def __len__(self) -> int:
        return len(self.jobs)

    @classmethod
    def from_spec(cls, spec: Mapping[str, Any] | str | Path) -> "TuningPlan":
        """Build a plan from a dict spec, a JSON string, or a path to a
        JSON file (module docstring documents the format)."""

        if isinstance(spec, (str, Path)):
            # a string starting with "{" is inline JSON; anything else
            # is a file path
            if isinstance(spec, str) and spec.lstrip().startswith("{"):
                text = spec
            else:
                text = Path(spec).expanduser().read_text()
            spec = json.loads(text)
        if not isinstance(spec, Mapping):
            raise ValueError("plan spec must be a mapping with a 'jobs' list")
        if spec.get("calibrate"):
            raise ValueError("plan key 'calibrate' is not supported by the "
                             "port yet (its cost models use data-sheet "
                             "constants)")
        plan = cls(name=str(spec.get("name", "plan")))
        for i, jspec in enumerate(spec.get("jobs", [])):
            for params, suffix in _expand_grid(jspec):
                name = jspec.get("tunable")
                if not name:
                    raise ValueError(f"job #{i}: missing 'tunable' name")
                label = jspec.get("label", name) + suffix
                # bind via defaults: the factory resolves lazily inside
                # run()'s error boundary, so a bad spec fails one job
                plan.add(lambda name=name, params=params:
                         build_tunable(name, params),
                         engine=jspec.get("engine", "auto"), label=label,
                         force=bool(jspec.get("force", False)),
                         **dict(jspec.get("engine_kwargs", {})))
        return plan

    def run(self, *, cache="default", force: bool = False,
            progress: Callable[[str], None] | None = None,
            save: bool = True, workers: int = 1) -> PlanReport:
        """Execute every job through :func:`repro_torch.tune.tune`.

        Cache hits skip the engine (``force=True`` — plan-wide or
        per-job — re-tunes and overwrites); a failing job is recorded
        and the plan continues.  ``save=True`` flushes a dirty
        :class:`TuningCache` at the end.

        ``workers=N`` runs the untimed jobs through a thread pool; jobs
        that TIME things (``engine="measure"``) run serially after the
        pool drains, so no neighbour's load skews their samples.
        Pooled jobs with the same cache key run serially within one pool
        task (the first tunes, the rest hit).  The report lists results
        in plan order either way."""

        store = default_cache() if cache == "default" else cache
        report = PlanReport(plan=self.name)
        say = progress or (lambda line: None)

        def run_one(i: int, job: TuningJob) -> JobResult:
            t0 = time.perf_counter()
            label = job.label or f"job#{i}"
            try:
                tunable = job.materialize()
                label = job.label
                res = tune(tunable, engine=job.engine, cache=store,
                           force=force or job.force, **job.engine_kwargs)
                status = {"hit": "hit", "force": "forced"}.get(
                    res.stats.get("cache"), "tuned")
                jr = JobResult(
                    label=label, status=status, engine=res.engine,
                    t_min=res.t_min, best_config=dict(res.best_config),
                    provenance=res.stats.get("provenance"),
                    key=res.stats.get("key"),
                    elapsed_s=time.perf_counter() - t0, result=res)
                say(f"[{i + 1}/{len(self.jobs)}] {label}: {status} "
                    f"({res.engine}) t_min={res.t_min:g} "
                    f"config={jr.best_config} [{jr.elapsed_s:.2f}s]")
            except Exception as e:          # per-job isolation
                jr = JobResult(label=label, status="failed",
                               engine=job.engine,
                               elapsed_s=time.perf_counter() - t0,
                               error=f"{type(e).__name__}: {e}")
                say(f"[{i + 1}/{len(self.jobs)}] {label}: FAILED — "
                    f"{jr.error}")
            return jr

        def resolve_key(i: int, job: TuningJob) -> str:
            # the key tune() will use for this job; a job whose tunable
            # cannot even be built gets a group of its own (run_one then
            # records the failure)
            try:
                tunable = job.materialize()
                eng = _resolve_engine_name(tunable, job.engine)
                key, _ = cache_key(tunable, eng,
                                   params=dict(job.engine_kwargs) or None)
                return key
            except Exception:
                return f"@unresolvable-job-{i}"

        if workers > 1 and len(self.jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor
            slots: list[JobResult | None] = [None] * len(self.jobs)
            pooled = [(i, j) for i, j in enumerate(self.jobs) if not j.timed]
            timed = [(i, j) for i, j in enumerate(self.jobs) if j.timed]
            groups: dict[str, list[tuple[int, TuningJob]]] = {}
            for i, job in pooled:
                groups.setdefault(resolve_key(i, job), []).append((i, job))

            def run_group(members: list[tuple[int, TuningJob]]) -> None:
                for i, job in members:
                    slots[i] = run_one(i, job)

            with ThreadPoolExecutor(max_workers=workers) as pool:
                futures = [pool.submit(run_group, members)
                           for members in groups.values()]
                for f in futures:
                    f.result()
            for i, job in timed:         # quiet machine: pool is drained
                slots[i] = run_one(i, job)
            report.results.extend(slots)
        else:
            report.results.extend(run_one(i, job)
                                  for i, job in enumerate(self.jobs))
        if save and isinstance(store, TuningCache) and store.dirty:
            store.save()
        say(report.summary())
        return report


def _expand_grid(jspec: Mapping[str, Any]):
    """Yield (params, label_suffix) for each point of the job's ``grid``
    (cartesian product over list-valued entries), merged over ``params``."""

    base = dict(jspec.get("params", {}))
    grid = {k: list(v) for k, v in dict(jspec.get("grid", {})).items()}
    if not grid:
        yield base, ""
        return
    names = sorted(grid)
    for combo in itertools.product(*(grid[n] for n in names)):
        point = dict(zip(names, combo))
        suffix = "[" + ",".join(f"{k}={v}" for k, v in point.items()) + "]"
        yield {**base, **point}, suffix


__all__ = ["TuningPlan", "TuningJob", "JobResult", "PlanReport",
           "register_tunable", "available_tunables", "build_tunable"]
