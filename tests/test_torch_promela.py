"""The port's model checker against the JAX package's: the Promela
substrate, the explorer, the swarm, the ``explorer``/``swarm``/``bnb``
engines and the witness they return.

Every spec is built from the same field values in ``repro`` and in
``repro_torch``; state counts, terminals, picks, witness trails and
verdicts must be equal, and each engine's t_min equal to the port's
``sweep``.  Then the reference's own model-checking checks
(``tests/test_core_model_checking.py``) on the port's copy.  All of it
is pure Python: nothing here touches a device.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import (NonTermination as JaxNonTermination,  # noqa: E402
                        OverTime as JaxOverTime, build_model as jax_build_model,
                        explore as jax_explore, replay as jax_replay,
                        swarm_search as jax_swarm_search)
from repro.core.platform import PlatformSpec as JaxPlatformSpec  # noqa: E402
from repro.tune import PlatformTunable as JaxPlatformTunable  # noqa: E402
from repro.tune import tune as jax_tune  # noqa: E402
from repro_torch.core import (Counterexample, NonTermination,  # noqa: E402
                              OverTime, PlatformSpec, WaveParams, build_model,
                              explore, model_time, replay, swarm_search,
                              trace_satisfies)
from repro_torch.interop import platform_spec_from_dict  # noqa: E402
from repro_torch.tune import (PlatformTunable, TuningCache,  # noqa: E402
                              available_engines, tune)

SPECS = {
    "abstract-8": {"size": 8, "NP": 4, "GMT": 4, "kind": "abstract"},
    "minimum-8": {"size": 8, "NP": 4, "GMT": 4, "kind": "minimum"},
    "minimum-16": {"size": 16, "NP": 4, "GMT": 4, "kind": "minimum"},
}
# (engine, keyword arguments): each the same in both packages
ENGINES = {
    "explorer-collect": ("explorer", {}),
    "explorer-bisect": ("explorer", {"mode": "bisect"}),
    "bnb": ("bnb", {}),
    "swarm": ("swarm", {"n_walks": 8, "seed": 1, "n_workers": 1}),
}
FULL_BUDGET = 20_000        # states of the exponential "full" schedule


def _models(spec):
    return (build_model(platform_spec_from_dict(spec)),
            jax_build_model(JaxPlatformSpec(**spec)))


def _terminals(res):
    return [(t.globals["time"], t.globals["WG"], t.globals["TS"],
             t.globals["FIN"], t.trail, t.depth) for t in res.terminals]


def _summary(res):
    return {"states": res.states, "transitions": res.transitions,
            "max_depth": res.max_depth, "frontier_peak": res.frontier_peak,
            "status": res.status, "bound_reason": res.bound_reason,
            "truncated": res.truncated, "terminals": _terminals(res)}


# ---------------------------------------------------------------------------
# explore, schedule by schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("schedule", ["por", "full"])
def test_explore_matches_jax(spec, schedule):
    """The same states, transitions, depth, frontier, verdict and
    terminals (with their trails); ``por`` exhausts the space
    ("verified"), ``full`` runs into its state budget ("bounded")."""

    port, ref = _models(SPECS[spec])
    kw = dict(schedule=schedule, stop_on_first=False, collect_terminals=True,
              max_states=FULL_BUDGET if schedule == "full" else 5_000_000)
    got = explore(port, lambda G: False, **kw)
    want = jax_explore(ref, lambda G: False, **kw)
    assert _summary(got) == _summary(want)
    if schedule == "por":
        assert got.status == "verified" and got.terminals
        assert all(t.globals["FIN"] for t in got.terminals)
    else:
        assert got.status == "bounded"
        assert got.bound_reason == "max_states"


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 5])
def test_random_walk_matches_jax(spec, seed):
    """A seeded random walk to FIN: the same counterexample, trail and
    counts."""

    port, ref = _models(SPECS[spec])
    got = explore(port, NonTermination().violates, schedule="random",
                  seed=seed, depth_limit=2_000_000)
    want = jax_explore(ref, JaxNonTermination().violates, schedule="random",
                       seed=seed, depth_limit=2_000_000)
    assert got.status == want.status == "violated"
    assert (got.states, got.transitions, got.max_depth) == \
        (want.states, want.transitions, want.max_depth)
    assert got.counterexample.globals == want.counterexample.globals
    assert got.counterexample.trail == want.counterexample.trail


@pytest.mark.parametrize("spec", SPECS)
def test_over_time_verdicts_match_jax(spec):
    """Φ_o(T) at the optimum holds a counterexample, one below it none:
    the same verdicts and state counts in both packages."""

    port, ref = _models(SPECS[spec])
    t_min = tune(PlatformTunable(platform_spec_from_dict(SPECS[spec])),
                 engine="sweep", cache=None).t_min
    for T, status in ((t_min, "violated"), (t_min - 1, "verified")):
        got = explore(port, OverTime(T).violates)
        want = jax_explore(ref, JaxOverTime(T).violates)
        assert got.status == want.status == status
        assert got.states == want.states
        if got.counterexample is not None:
            assert got.counterexample.trail == want.counterexample.trail
            assert got.counterexample.globals["time"] <= T


def test_property_predicates_match_jax():
    states = [{"FIN": fin, "time": t} for fin in (False, True)
              for t in (0, 9, 10, 11)]
    for T in (9, 10):
        for G in states:
            assert OverTime(T).violates(G) == JaxOverTime(T).violates(G)
            assert OverTime(T).state_ok(G) == JaxOverTime(T).state_ok(G)
            assert NonTermination().violates(G) == \
                JaxNonTermination().violates(G)
    assert trace_satisfies(OverTime(10), [{"FIN": False, "time": 0},
                                          {"FIN": True, "time": 11}])
    assert not trace_satisfies(OverTime(10), [{"FIN": False, "time": 0},
                                              {"FIN": True, "time": 9}])
    assert not trace_satisfies(NonTermination(), [{"FIN": True, "time": 3}])


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def test_engine_registry_has_the_model_checkers():
    assert {"explorer", "swarm", "bnb"} <= set(available_engines())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("spec", SPECS)
def test_engine_matches_jax(spec, engine):
    """t_min equal to the port's ``sweep``; configuration, witness trail
    and depth, oracle calls and state/walk counts equal to ``repro``'s
    engine of the same name; the witness replays on the port's model."""

    name, kw = ENGINES[engine]
    got = tune(PlatformTunable(platform_spec_from_dict(SPECS[spec])),
               engine=name, cache=None, **kw)
    want = jax_tune(JaxPlatformTunable(JaxPlatformSpec(**SPECS[spec])),
                    engine=name, cache=None, **kw)
    sweep = tune(PlatformTunable(platform_spec_from_dict(SPECS[spec])),
                 engine="sweep", cache=None)
    assert got.t_min == want.t_min == sweep.t_min
    assert got.best_config == want.best_config
    assert got.engine == want.engine
    assert got.oracle_calls == want.oracle_calls
    assert got.witness.trail == want.witness.trail
    assert got.witness.depth == want.witness.depth
    assert got.witness.time == got.t_min
    for key in ("states", "terminals", "walks", "counterexamples"):
        assert got.stats.get(key) == want.stats.get(key), key
    model = build_model(platform_spec_from_dict(SPECS[spec]))
    if name == "swarm":
        # the reference's swarm engine drops its witness's trail; the
        # port's keeps it on request, equal to repro's swarm_search's
        assert got.witness.trail == ()
        kept = tune(PlatformTunable(platform_spec_from_dict(SPECS[spec])),
                    engine=name, cache=None, keep_trails=True, **kw)
        ref = jax_swarm_search(jax_build_model(JaxPlatformSpec(
            **SPECS[spec])), n_walks=8, seed=1, keep_trails=True)
        assert kept.witness.trail == ref.best.trail
        assert (kept.t_min, kept.best_config) == (got.t_min, got.best_config)
        got = kept
    assert got.witness.trail and got.witness.validate(model)


@pytest.mark.parametrize("spec", SPECS)
def test_replay_and_validate_match_jax(spec):
    """``repro``'s witness trail replays on the port's model to the same
    end state; a trail cut short fails validation, a tampered one is
    rejected by replay, in both packages."""

    port, ref = _models(SPECS[spec])
    w = jax_tune(JaxPlatformTunable(JaxPlatformSpec(**SPECS[spec])),
                 engine="bnb", cache=None).witness
    assert dataclasses.astuple(replay(port, w.trail)) == \
        dataclasses.astuple(jax_replay(ref, w.trail))
    cex = Counterexample(time=w.time, config=dict(w.config), trail=w.trail,
                         depth=w.depth)
    assert cex.validate(port) and w.validate(ref)
    short = Counterexample(cex.time, cex.config, cex.trail[:-1], cex.depth)
    assert not short.validate(port)
    assert not w.__class__(w.time, w.config, w.trail[:-1],
                           w.depth).validate(ref)
    late = Counterexample(cex.time + 1, cex.config, cex.trail, cex.depth)
    assert not late.validate(port)
    assert not Counterexample(cex.time, cex.config, (), 0).validate(port)
    tampered = cex.trail[:3] + ("main[0]:0:select=999",) + cex.trail[4:]
    for fn, model in ((replay, port), (jax_replay, ref)):
        with pytest.raises(ValueError, match="diverged"):
            fn(model, tampered)
    with pytest.raises(ValueError):
        Counterexample(cex.time, cex.config, tampered,
                       cex.depth).validate(port)


def test_swarm_search_matches_jax():
    spec = SPECS["minimum-16"]
    port, ref = _models(spec)
    got = swarm_search(port, n_walks=8, seed=2, keep_trails=True)
    want = jax_swarm_search(ref, n_walks=8, seed=2, keep_trails=True)
    assert (got.t_min, got.best.config, got.best.trail) == \
        (want.t_min, want.best.config, want.best.trail)
    assert (got.stats.walks, got.stats.rounds, got.stats.counterexamples) == \
        (want.stats.walks, want.stats.rounds, want.stats.counterexamples)
    wp = WaveParams(size=16, NP=4, GMT=4, kind="minimum")
    assert model_time(wp, got.best.config["WG"], got.best.config["TS"]) \
        == got.t_min


def test_swarm_thread_pool_finds_the_optimum():
    """``n_workers > 1`` fans the walks over threads; the walks keep
    their seeds, so the pick is the single-thread one."""

    spec = platform_spec_from_dict(SPECS["minimum-8"])
    one = swarm_search(build_model(spec), n_walks=8, seed=1)
    pool = swarm_search(build_model(spec), n_walks=8, seed=1, n_workers=4)
    assert pool.t_min == one.t_min == 16
    assert pool.stats.walks == one.stats.walks


# ---------------------------------------------------------------------------
# the reference's own model-checking checks, on the port
# ---------------------------------------------------------------------------


def sim_time(kind, size, NP, GMT, WG, TS, L=0):
    spec = PlatformSpec(size=size, NP=NP, GMT=GMT, L=L, kind=kind,
                        fixed_WG=WG, fixed_TS=TS)
    r = explore(build_model(spec), NonTermination().violates, schedule="por")
    assert r.counterexample is not None, "model deadlocked"
    return r.counterexample.globals["time"]


@pytest.mark.parametrize("kind", ["abstract", "minimum"])
@pytest.mark.parametrize("size,NP,GMT", [(4, 2, 2), (8, 4, 4), (16, 2, 8)])
def test_sim_equals_wave_model(kind, size, NP, GMT):
    """The process model's termination time is the wave model's at every
    (WG, TS) of the lattice (L = 0, and L = 3 at the smallest)."""

    for L in ((0, 3) if size == 4 else (0,)):
        wp = WaveParams(size=size, NP=NP, GMT=GMT, L=L, kind=kind)
        for WG, TS in PlatformSpec(size=size).config_choices():
            assert sim_time(kind, size, NP, GMT, WG, TS, L) == \
                model_time(wp, WG, TS), (WG, TS, L)


def test_paper_table1_row1():
    """Paper Table 1 row 1: size=8, TS=4, WG=4, 4 PEs -> model time 44."""

    assert sim_time("abstract", 8, 4, 4, 4, 4) == 44
    assert model_time(WaveParams(size=8, NP=4, GMT=4), 4, 4) == 44


@pytest.mark.parametrize("kind", ["abstract", "minimum"])
def test_interleaving_invariance_full_schedule(kind):
    """Exhaustive DFS over all schedules reaches FIN with one time value
    only, and the same state count as ``repro``."""

    spec = {"size": 4, "NP": 2, "GMT": 2, "kind": kind, "fixed_WG": 2,
            "fixed_TS": 2}
    port, ref = _models(spec)
    kw = dict(schedule="full", stop_on_first=False, collect_terminals=True,
              keep_trails=False, max_states=2_000_000)
    r = explore(port, NonTermination().violates, **kw)
    assert not r.truncated
    times = {t.globals["time"] for t in r.terminals if t.globals["FIN"]}
    assert len(times) == 1
    assert r.states == jax_explore(ref, JaxNonTermination().violates,
                                   **kw).states


def test_no_deadlocks_small_grid():
    spec = PlatformSpec(size=8, NP=4, GMT=4, kind="minimum")
    r = explore(build_model(spec), lambda G: False, schedule="por",
                stop_on_first=False, collect_terminals=True, keep_trails=False)
    assert r.terminals, "no terminal states found"
    assert all(t.globals["FIN"] for t in r.terminals)
    assert len(r.terminals) == len(spec.config_choices())


def test_counterexample_replay_validates():
    m = build_model(PlatformSpec(size=8, NP=4, GMT=4, kind="abstract"))
    r = explore(m, OverTime(44).violates, schedule="por")
    cex = Counterexample.from_terminal(r.counterexample)
    assert cex.time <= 44 and cex.validate(m)
    assert set(cex.config) == {"WG", "TS"}
    assert explore(m, OverTime(43).violates).property_holds


def test_replay_rejects_bogus_trail():
    m = build_model(PlatformSpec(size=4, NP=2, GMT=2, kind="abstract",
                                 fixed_WG=2, fixed_TS=2))
    with pytest.raises(ValueError):
        replay(m, ("nonexistent-transition",))


def test_max_states_budget_is_bounded_not_verified():
    m = build_model(PlatformSpec(size=8, NP=4, GMT=4, kind="minimum"))
    r = explore(m, lambda G: False, max_states=50)
    assert r.status == "bounded" and r.property_holds
    assert r.bound_reason == "max_states"
    assert r.frontier_peak > 0 and r.states <= 51
    d = explore(m, lambda G: False, depth_limit=5)
    assert d.status == "bounded" and d.bound_reason == "depth_limit"
    full = explore(m, lambda G: False)
    assert full.status == "verified" and full.bound_reason is None


def test_explorer_budget_reaches_the_engine():
    """``budget`` caps the explorer engine's states: too small a budget
    finds no terminating execution."""

    t = PlatformTunable(platform_spec_from_dict(SPECS["minimum-8"]))
    with pytest.raises(RuntimeError, match="no terminat"):
        tune(t, engine="bnb", cache=None, budget=20)
    with pytest.raises(RuntimeError, match="no terminat"):
        tune(t, engine="explorer", cache=None, budget=20)


@pytest.mark.parametrize("engine", ["explorer", "bnb", "swarm"])
def test_witness_survives_the_cache(tmp_path, engine):
    """A model-checked witness goes to disk and back: the second ``tune``
    (a fresh cache object on the same file) hits, and the trail it
    rebuilds still replays to the witness's time."""

    spec = platform_spec_from_dict(SPECS["minimum-8"])
    path = tmp_path / "cache.json"
    kw = {"keep_trails": True} if engine == "swarm" else {}
    cache = TuningCache(path)
    first = tune(PlatformTunable(spec), engine=engine, cache=cache, **kw)
    assert first.stats["cache"] == "miss"
    cache.save()
    again = tune(PlatformTunable(spec), engine=engine,
                 cache=TuningCache(path), **kw)
    assert again.stats["cache"] == "hit"
    assert (again.t_min, again.best_config) == \
        (first.t_min, first.best_config)
    assert isinstance(again.witness.trail, tuple)
    assert again.witness.trail == first.witness.trail
    assert again.witness.validate(build_model(spec))


def test_platform_engines_refuse_a_plain_tunable():
    from repro_torch.tune import EngineError, FunctionTunable
    from repro_torch.core import SearchSpace, Param
    ft = FunctionTunable(lambda c: c["x"], SearchSpace([Param("x", [1, 2])]))
    for engine in ("explorer", "swarm", "bnb"):
        with pytest.raises(EngineError, match="platform tunable"):
            tune(ft, engine=engine, cache=None)
