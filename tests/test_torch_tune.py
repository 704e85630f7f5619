"""The port's tuning front door against the JAX package's: engines,
the measure engine on the CPU, the cache, ``@autotune`` and plans."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro.core.platform import PlatformSpec as JaxPlatformSpec  # noqa: E402
from repro.tune import PlatformTunable as JaxPlatformTunable  # noqa: E402
from repro.tune import tune as jax_tune  # noqa: E402
from repro_torch.interop import platform_spec_from_dict  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FlashAttentionTunable)
from repro_torch.kernels.matmul_tuned.ops import MatmulTunable  # noqa: E402
from repro_torch.kernels.sweep_eval.ops import SweepEvalTunable  # noqa: E402
from repro_torch.kernels.tuned_reduction.ops import (  # noqa: E402
    ReductionTunable, reduce_1d)
from repro_torch.tune import (PlatformTunable, TuningCache,  # noqa: E402
                              TuningPlan, autotune, available_engines,
                              build_tunable, cache_key, platform_fingerprint,
                              set_default_cache, tune)

SMALL = {"size": 16, "NP": 4, "GMT": 4, "kind": "minimum"}
PAPER = {"size": 2**20, "NP": 128, "GMT": 16, "L": 8, "kind": "minimum"}


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


@pytest.mark.parametrize("engine", ["sweep", "grid", "bisect"])
@pytest.mark.parametrize("spec,best,t_min", [
    (SMALL, {"WG": 4, "TS": 4}, 24),
    (PAPER, {"WG": 128, "TS": 8192}, 131224)])
def test_platform_engines_agree_with_jax(engine, spec, best, t_min):
    ref = jax_tune(JaxPlatformTunable(JaxPlatformSpec(**spec)),
                   engine=engine, cache=None)
    got = tune(PlatformTunable(platform_spec_from_dict(spec)),
               engine=engine, cache=None)
    assert got.best_config == ref.best_config == best
    assert got.t_min == ref.t_min == t_min


def test_sweep_with_bisection_speaks_the_papers_protocol():
    res = tune(PlatformTunable(platform_spec_from_dict(PAPER)),
               engine="sweep", cache=None, use_bisection=True)
    assert res.engine == "sweep+bisection"
    assert (res.best_config, res.t_min) == ({"WG": 128, "TS": 8192}, 131224)
    assert res.oracle_calls > 1 and res.witness.time == 131224


def test_engine_registry():
    assert set(available_engines()) == {"bisect", "function", "grid",
                                        "measure", "sweep"}
    with pytest.raises(ValueError, match="unknown engine"):
        tune(ReductionTunable(64), engine="swarm", cache=None)


def test_measure_engine_runs_on_cpu_tensors_and_records_provenance():
    res = tune(ReductionTunable(4096, device="cpu"), engine="measure",
               cache=None, top_k=3, repeats=2)
    st = res.stats
    assert st["provenance"] == "measured"
    assert len(st["candidates"]) == 3 and res.oracle_calls == 6
    assert res.best_config == st["measured_pick"]["config"]
    assert st["measured_pick"]["measured"] <= st["modeled_pick"]["measured"]
    assert res.t_min == st["measured_pick"]["measured"]


def test_measure_engine_times_the_sweep_kernel_on_cpu():
    res = tune(SweepEvalTunable(2**12, device="cpu"), engine="measure",
               cache=None, top_k=2, repeats=1)
    assert res.stats["provenance"] == "measured"
    assert set(res.best_config) == {"threads", "ept"}


def test_cache_miss_hit_force_and_key(tmp_path, monkeypatch):
    cache = TuningCache(tmp_path / "c.json")
    t = ReductionTunable(2**20)
    first = tune(t, engine="grid", cache=cache)
    assert first.stats["cache"] == "miss"
    second = tune(t, engine="grid", cache=cache)
    assert second.stats["cache"] == "hit"
    assert second.best_config == first.best_config
    forced = tune(t, engine="grid", cache=cache, force=True)
    assert forced.stats["cache"] == "force"
    key, doc = cache_key(t, "grid")
    assert key == first.stats["key"] and key in cache
    assert doc["platform"] == platform_fingerprint()
    assert doc["platform"]["torch"] == torch.__version__
    assert doc["platform"]["backend"] == "cpu"     # no card here
    cache.save()
    reloaded = TuningCache(tmp_path / "c.json")
    assert tune(t, engine="grid", cache=reloaded).stats["cache"] == "hit"
    # the port has its own store, never the JAX package's
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert TuningCache().path == tmp_path / ".cache/repro_torch/tune_cache.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "x.json"))
    assert TuningCache().path == tmp_path / "x.json"


def test_measured_provenance_survives_the_cache(tmp_path):
    cache = TuningCache(tmp_path / "c.json")
    t = ReductionTunable(2048, device="cpu")
    tune(t, engine="measure", cache=cache, top_k=1, repeats=1)
    hit = tune(t, engine="measure", cache=cache, top_k=1, repeats=1)
    assert hit.stats["cache"] == "hit"
    assert hit.stats["provenance"] == "measured"


def test_autotune_pinned_and_omitted_parameters():
    x = torch.arange(-500, 500, dtype=torch.int32)
    omitted = reduce_1d.tune(x, op="min")
    assert set(omitted.best_config) == {"WG", "TS"}
    pinned = reduce_1d.tune(x, op="min", WG=256)
    assert pinned.best_config["WG"] == 256
    assert int(reduce_1d(x, op="min", WG=256)) == -500
    assert int(reduce_1d(x, op="min")) == -500
    # everything pinned: no tuning at all
    calls = []

    @autotune(lambda n, **kw: calls.append(n) or ReductionTunable(n),
              params=("WG", "TS"))
    def f(n, *, WG=None, TS=None):
        return WG, TS

    assert f(4096, WG=64, TS=2) == (64, 2) and calls == []
    assert f(4096) == f(4096)
    assert len(calls) == 2                 # the memo skips the tune, not
    #                                        the tunable construction


def test_plan_from_spec_round_trip(tmp_path):
    spec = {"name": "port-warmup", "jobs": [
        {"tunable": "platform.minimum",
         "params": {k: v for k, v in PAPER.items() if k != "kind"},
         "engine": "sweep", "label": "paper"},
        {"tunable": "platform.minimum",
         "params": {k: v for k, v in SMALL.items() if k != "kind"},
         "engine": "grid"},
        {"tunable": "kernels.tuned_reduction", "grid": {"n": [4096, 8192]},
         "engine": "grid"},
        {"tunable": "kernels.sweep_eval", "params": {"n": 128},
         "engine": "grid"},
        {"tunable": "kernels.matmul_tuned",
         "params": {"M": 128, "N": 128, "K": 128, "dtype_bytes": 4},
         "engine": "grid"},
        {"tunable": "kernels.tuned_reduction",
         "params": {"n": 2048, "device": "cpu"}, "engine": "measure",
         "engine_kwargs": {"top_k": 1, "repeats": 1}}]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(spec))
    cache = TuningCache(tmp_path / "c.json")
    plan = TuningPlan.from_spec(str(path))
    assert len(plan) == 7 and plan.jobs[-1].timed
    report = plan.run(cache=cache, workers=3)
    assert report.ok, report.summary()
    assert report.results[0].best_config == {"WG": 128, "TS": 8192}
    assert report.results[0].t_min == 131224
    assert report.results[1].best_config == {"WG": 4, "TS": 4}
    assert [r.label for r in report.results][2:4] == [
        "kernels.tuned_reduction[n=4096]", "kernels.tuned_reduction[n=8192]"]
    again = TuningPlan.from_spec(spec).run(cache=TuningCache(tmp_path /
                                                             "c.json"))
    assert again.counts["hits"] == 7
    assert build_tunable("platform.abstract", {"size": 16}).name == \
        "platform.abstract"
    with pytest.raises(ValueError, match="calibrate"):
        TuningPlan.from_spec({"calibrate": True, "jobs": []})


def test_plan_isolates_a_failing_job(tmp_path):
    plan = TuningPlan.from_spec({"jobs": [
        {"tunable": "no.such.tunable"},
        {"tunable": "platform.minimum", "params": {"size": 16},
         "engine": "sweep"}]})
    report = plan.run(cache=TuningCache(tmp_path / "c.json"))
    assert [r.status for r in report.results] == ["failed", "tuned"]


@pytest.mark.parametrize("make,maker", [
    (lambda: ReductionTunable(4096, device="cpu"), "randn"),
    (lambda: SweepEvalTunable(4096, device="cpu"), "randint"),
    (lambda: MatmulTunable(64, 64, 64, dtype_bytes=4, device="cpu"), "randn"),
    (lambda: FlashAttentionTunable(S=64, D=64, BH=2, dtype_bytes=4,
                                   device="cpu"), "randn")])
def test_measure_makes_its_input_once_per_tunable(monkeypatch, make, maker):
    """Two ``measure()`` calls on one Tunable draw its random input once:
    a plan job's ``elapsed_s`` then times the kernel, not the data."""

    calls = []
    real = getattr(torch, maker)
    monkeypatch.setattr(torch, maker,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    t = make()
    cfg = next(iter(t.space()))
    t.measure(cfg, warmup=0, iters=1)
    made = len(calls)
    assert made > 0
    t.measure(cfg, warmup=0, iters=1)
    assert len(calls) == made
    # another Tunable of the same shape makes its own
    make().measure(cfg, warmup=0, iters=1)
    assert len(calls) == 2 * made
