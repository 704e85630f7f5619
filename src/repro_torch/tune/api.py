"""``repro_torch.tune.tune`` — the one front door for all tuning (the
port's copy of ``repro.tune.api``).

    from repro_torch.tune import tune, PlatformTunable
    res = tune(PlatformTunable(spec), engine="sweep")
    res.best_config, res.t_min

The front door is engine-agnostic (Step 3 of the paper's method as a
component): resolve the engine from the registry, consult the persistent
:class:`~repro_torch.tune.cache.TuningCache` (fingerprint + platform + engine),
run the engine on a miss, store the result.
"""

from __future__ import annotations

import time as _time
from typing import Any

from ..core.autotuner import TuneResult
from ..core.counterexample import Counterexample
from .cache import TuningCache, cache_key, default_cache
from .engines import get_engine


def _resolve_engine_name(tunable, engine: str) -> str:
    if engine != "auto":
        return engine
    # platform tunables get the exact vectorized sweep; everything else
    # walks its lattice through the cost model
    return "sweep" if getattr(tunable, "spec", None) is not None else "grid"


def _resolve_cache(cache) -> TuningCache | None:
    if cache == "default":
        return default_cache()
    return cache            # a TuningCache instance, or None = disabled


def tune(tunable, engine: str = "auto", *, cache="default",
         budget: int | None = None, force: bool = False,
         **engine_kw: Any) -> TuneResult:
    """Tune ``tunable`` with the named engine, through the cache.

    Parameters
    ----------
    tunable: an object implementing the :class:`~repro_torch.tune.Tunable`
        protocol (``name``/``space``/``cost``/``fingerprint``).
    engine: registry name (``sweep``/``explorer``/``swarm``/``bnb``/
        ``grid``/``bisect``/``measure``/...); ``auto`` picks ``sweep``
        for platform tunables and ``grid`` otherwise.
    cache: ``"default"`` (process-wide persistent cache), a
        :class:`TuningCache`, or ``None`` to disable caching.
    budget: engine-specific work bound (configs / shortlist size /
        states / walks).
    force: re-run the engine even on a cache hit (the result overwrites
        the cached entry; such a re-tune reports ``stats["cache"] ==
        "force"``, a cold forced run plain ``"miss"``).
    engine_kw: forwarded to ``Engine.run`` (e.g. ``schedule="por"``,
        ``use_bisection=True``, ``n_walks=8``, ``top_k=4``).
    """

    eng = get_engine(_resolve_engine_name(tunable, engine))
    store = _resolve_cache(cache)

    key = doc = None
    overwrote = False
    if store is not None:
        extras = dict(engine_kw)
        if budget is not None:
            extras["budget"] = budget
        key, doc = cache_key(tunable, eng.name, params=extras or None)
        if force:
            # a forced re-run over an existing entry is a re-tune, not a
            # cold miss — rollout reports tag it "force" below
            overwrote = key in store
        else:
            hit = store.get(key)
            if hit is not None:
                witness = None
                if hit.get("witness") is not None:
                    w = hit["witness"]
                    witness = Counterexample(time=w["time"],
                                             config=dict(w["config"]),
                                             trail=tuple(w["trail"]),
                                             depth=w["depth"])
                stats = {**hit.get("stats", {}), "cache": "hit", "key": key}
                # measured-vs-modeled provenance survives the round-trip
                stats.setdefault("provenance",
                                 hit.get("provenance", "modeled"))
                return TuneResult(best_config=dict(hit["best_config"]),
                                  t_min=hit["t_min"],
                                  engine=hit.get("engine", eng.name),
                                  oracle_calls=hit.get("oracle_calls", 0),
                                  elapsed_s=0.0, witness=witness,
                                  stats=stats)

    t0 = _time.perf_counter()
    res = eng.run(tunable, budget=budget, **engine_kw)
    res.elapsed_s = _time.perf_counter() - t0
    res.stats.setdefault("provenance", "modeled")

    if store is not None:
        store.put(key, res, fingerprint=doc)
        res.stats.setdefault("cache", "force" if overwrote else "miss")
        res.stats.setdefault("key", key)
    return res


__all__ = ["tune"]
