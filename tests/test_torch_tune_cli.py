"""The port's fleet-rollout layer against the JAX package's: the plan
registry's ``platform`` and ``meta.engine`` names, ``MetaEngineTunable``,
cache artifacts (export / merge / prune) and ``python -m
repro_torch.tune``.

The reference's plan file, ``examples/plans/fleet_warmup.json``, runs
whole through both packages' ``TuningPlan`` on the CPU (no calibration;
``"device": "cpu"`` on the port's tunables that take it) under one set of
platform constants installed into both packages, as
``tests/test_torch_tunables.py`` does.  The platform and serving jobs
share their models with the reference, so their picks and costs are
held equal; the kernel tunables search each package's own launch
lattice (the card's, the TPU's), so there only the job's status is
compared.  The reference's ``test_meta_engine_*``, ``test_artifact_*``,
``test_cache_prune_*`` and ``test_cli_*`` cases run against the port,
and bundles and merge counts cross between the packages.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import calibrate as jax_calibrate  # noqa: E402
from repro import tune as jax_tune  # noqa: E402
from repro.core.platform import PlatformSpec as JaxPlatformSpec  # noqa: E402
from repro.core.search_space import Param as JaxParam  # noqa: E402
from repro.core.search_space import SearchSpace as JaxSearchSpace  # noqa: E402
from repro.tune.cli import main as jax_cli_main  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.core.platform import PlatformSpec  # noqa: E402
from repro_torch.core.search_space import Param, SearchSpace  # noqa: E402
from repro_torch.kernels.matmul_tuned.ops import (matmul_ref,  # noqa: E402
                                                  matmul_tuned)
from repro_torch.tune import (ArtifactError, MetaEngineTunable,  # noqa: E402
                              PlatformTunable, TuningCache, TuningPlan,
                              available_tunables, cache_key,
                              set_default_cache, tune)
from repro_torch.tune.artifact import ARTIFACT_KIND, ARTIFACT_SCHEMA  # noqa: E402
from repro_torch.tune.cli import main as cli_main  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FLEET_PLAN = ROOT / "examples" / "plans" / "fleet_warmup.json"
REL = 1e-12


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "default_cache.json"))
    yield
    set_default_cache(prev)


@pytest.fixture(params=["reference_defaults", "port_defaults"])
def shared_spec(request):
    """One constants dict installed into both packages: the JAX
    package's own defaults (here only as shared input to the
    comparison) or the port's H100 data-sheet ones."""

    src = (jax_calibrate.DEFAULT_SPEC if request.param == "reference_defaults"
           else calibrate.DEFAULT_SPEC).constants()
    jprev = jax_calibrate.set_platform_spec(
        jax_calibrate.PlatformSpec(**src))
    prev = calibrate.set_platform_spec(calibrate.PlatformSpec(**src))
    try:
        yield src
    finally:
        jax_calibrate.set_platform_spec(jprev)
        calibrate.set_platform_spec(prev)


def _make_counting(param_cls, space_cls):
    class CountingTunable:
        name = "test.counting"

        def __init__(self, ident="a"):
            self.ident = ident
            self.cost_calls = 0

        def space(self):
            return space_cls(params=[param_cls("block", (1, 2, 4))])

        def cost(self, cfg):
            self.cost_calls += 1
            return 10 // cfg["block"]

        def fingerprint(self):
            return {"tunable": self.name, "ident": self.ident}

    class MeasuredTunable(CountingTunable):
        """cost ranks block=4 best; wall-clock says block=2 (measured
        1 + |block - 2|, floored at 1 so the meta search-effort penalty
        stays discriminating)."""

        def __init__(self, ident="a"):
            super().__init__(ident)
            self.measure_calls = 0

        def measure(self, cfg):
            self.measure_calls += 1
            return 1.0 + abs(cfg["block"] - 2)

    return CountingTunable, MeasuredTunable


CountingTunable, MeasuredTunable = _make_counting(Param, SearchSpace)
JaxCountingTunable, JaxMeasuredTunable = _make_counting(JaxParam,
                                                        JaxSearchSpace)


def _cpu_spec(spec: dict) -> dict:
    """The plan spec with no calibration and every port tunable that
    takes a device on the CPU (the meta job's inner one included)."""

    spec = json.loads(json.dumps(spec))
    spec["calibrate"] = False
    for job in spec["jobs"]:
        name = job["tunable"]
        if name.startswith("kernels.") or name == "serve.scheduler":
            job["params"] = dict(job.get("params", {}), device="cpu")
        if name == "meta.engine":
            job["params"]["inner"]["params"]["device"] = "cpu"
    return spec


# ---------------------------------------------------------------------------
# the registry and the reference's plan file
# ---------------------------------------------------------------------------


def test_registry_names_every_tunable_of_the_reference_plan():
    names = set(available_tunables())
    assert {"platform", "meta.engine", "platform.abstract",
            "platform.minimum"} <= names
    spec = json.loads(FLEET_PLAN.read_text())
    assert {j["tunable"] for j in spec["jobs"]} <= names
    # the distributed machine model: a reference-style job resolves and
    # picks the reference's config under the same constants
    assert "tpu.distributed" in names
    job = {"tunable": "tpu.distributed",
           "params": {"arch": "smollm-135m", "shape": "train_4k",
                      "chips_per_pod": 8, "hbm_bytes": 16e9}}
    one = {"name": "distributed-only", "jobs": [job]}
    src = calibrate.DEFAULT_SPEC.constants()
    jprev = jax_calibrate.set_platform_spec(jax_calibrate.PlatformSpec(**src))
    prev = calibrate.set_platform_spec(calibrate.PlatformSpec(**src))
    try:
        got = TuningPlan.from_spec(one).run(cache=None).results[0]
        want = jax_tune.TuningPlan.from_spec(one).run(cache=None).results[0]
    finally:
        jax_calibrate.set_platform_spec(jprev)
        calibrate.set_platform_spec(prev)
    assert got.status == want.status == "tuned"
    assert got.best_config == want.best_config
    assert got.t_min == want.t_min
    from repro_torch.runtime import register_scheduler
    from repro_torch.runtime.scheduler import \
        register_scheduler as defined
    assert register_scheduler is defined


def test_plan_platform_job_matches_reference_and_explorer():
    spec = json.loads(FLEET_PLAN.read_text())
    (job,) = [j for j in spec["jobs"] if j["tunable"] == "platform"]
    one = {"name": "platform-only", "jobs": [job]}
    got = TuningPlan.from_spec(one).run(cache=None).results[0]
    want = jax_tune.TuningPlan.from_spec(one).run(cache=None).results[0]
    assert got.status == want.status == "tuned"
    assert got.label == want.label == "paper.minimum-16"
    assert got.best_config == want.best_config
    assert got.t_min == want.t_min
    # the model checker reaches the same minimum; at size 16 it is tied
    # ((4, 4) and (16, 4) both take 24), and the explorer's witness is
    # the other optimum, as in the reference
    tunable = PlatformTunable(PlatformSpec(**job["params"]))
    explorer = tune(tunable, engine="explorer", cache=None)
    ref_explorer = jax_tune.tune(jax_tune.PlatformTunable(
        JaxPlatformSpec(**job["params"])), engine="explorer", cache=None)
    assert explorer.t_min == got.t_min == 24
    assert explorer.best_config == ref_explorer.best_config
    assert tunable.cost(explorer.best_config) == \
        tunable.cost(got.best_config) == got.t_min


def test_fleet_warmup_plan_runs_whole_in_both_packages(tmp_path,
                                                       shared_spec):
    spec = json.loads(FLEET_PLAN.read_text())
    port_plan = TuningPlan.from_spec(_cpu_spec(spec))
    ref_spec = dict(spec, calibrate=False)
    ref_plan = jax_tune.TuningPlan.from_spec(ref_spec)
    assert [j.timed for j in port_plan.jobs] == \
        [j.timed for j in ref_plan.jobs]
    got = port_plan.run(cache=TuningCache(tmp_path / "port.json"),
                        workers=4)
    want = ref_plan.run(cache=jax_tune.TuningCache(tmp_path / "ref.json"),
                        workers=4)
    assert got.ok and want.ok, (got.to_json(), want.to_json())
    assert len(got.results) == len(want.results) == 12
    for g, w in zip(got.results, want.results):
        assert (g.label, g.status, g.engine) == (w.label, w.status, w.engine)
        name = g.label.split("[")[0]
        if name.startswith(("paper.", "serve.")) and g.engine != "measure":
            assert g.best_config == w.best_config, g.label
            assert g.t_min == pytest.approx(w.t_min, rel=REL), g.label
        elif g.engine == "measure":              # the scheduler's job
            gs, ws = g.result.stats, w.result.stats
            assert gs["modeled_pick"]["config"] == ws["modeled_pick"]["config"]
            assert [c["config"] for c in gs["candidates"]] == \
                [c["config"] for c in ws["candidates"]]
        elif name.startswith("meta."):
            assert g.result.oracle_calls == w.result.oracle_calls == 2
            assert set(g.best_config) == {"top_k", "repeats"}
        else:                                    # each package's lattice
            assert g.engine == "grid" and g.best_config
    again = TuningPlan.from_spec(_cpu_spec(spec)).run(
        cache=TuningCache(tmp_path / "port.json"))
    assert again.counts["hits"] == 12


def test_reference_plan_unmodified_fails_the_card_jobs_on_the_cpu(
        tmp_path, monkeypatch, capsys):
    """No fallback: without a card, the two jobs that time on the card
    (the scheduler's measure job and the meta job's inner measure
    tunes) fail, the rest tune, and the warm-up exits 1."""

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setenv("REPRO_TORCH_PLATFORM_SPEC",
                       str(tmp_path / "spec.json"))
    prev = calibrate.set_platform_spec(None)
    try:
        rc = cli_main(["--cache", str(tmp_path / "c.json"), "warmup",
                       str(FLEET_PLAN), "--json"])
    finally:
        calibrate.set_platform_spec(prev)
    out = capsys.readouterr()
    rep = json.loads(out.out)
    assert rc == 1
    failed = [j["label"] for j in rep["jobs"] if j["status"] == "failed"]
    assert failed == ["serve.scheduler-smoke", "meta.measure-reduction"]
    assert all("no CUDA device" in j["error"] for j in rep["jobs"]
               if j["status"] == "failed")
    assert rep["counts"] == {"jobs": 12, "hits": 0, "tuned": 10,
                             "forced": 0, "failed": 2}
    # the progress lines (the calibration's first) went to stderr
    assert out.err.splitlines()[0].startswith("[calibrate] probed cpu/")


# ---------------------------------------------------------------------------
# MetaEngineTunable — tuning the tuner through the same tune() path
# ---------------------------------------------------------------------------


def test_meta_engine_tunable_selects_top_k_and_repeats(tmp_path):
    cache = TuningCache(tmp_path / "cache.json")
    inner = MeasuredTunable()
    meta = MetaEngineTunable(inner, engine="measure",
                             space={"top_k": [1, 2, 4], "repeats": [1]})
    res = tune(meta, engine="grid", cache=cache)
    assert res.best_config == {"top_k": 2, "repeats": 1}
    # every meta point really searched (1 + 2 + 3 measure calls)
    assert inner.measure_calls == 6
    t1 = meta.trials[(("repeats", 1), ("top_k", 1))]
    t2 = meta.trials[(("repeats", 1), ("top_k", 2))]
    assert t1.best_config == {"block": 4}       # model's pick, measured 3.0
    assert t2.best_config == {"block": 2}       # wall-clock winner, 1.0

    r2 = tune(meta, engine="grid", cache=cache)
    assert r2.stats["cache"] == "hit" and inner.measure_calls == 6


def test_meta_engine_fingerprint_keys_space_and_inner():
    a = MetaEngineTunable(MeasuredTunable("a"), space={"top_k": [1, 2]})
    b = MetaEngineTunable(MeasuredTunable("b"), space={"top_k": [1, 2]})
    c = MetaEngineTunable(MeasuredTunable("a"), space={"top_k": [1, 4]})
    assert cache_key(a, "grid")[0] != cache_key(b, "grid")[0]
    assert cache_key(a, "grid")[0] != cache_key(c, "grid")[0]
    assert a.fingerprint() == jax_tune.MetaEngineTunable(
        JaxMeasuredTunable("a"), space={"top_k": [1, 2]}).fingerprint()


def test_meta_engine_matches_reference_trial_for_trial():
    space = {"top_k": [1, 2, 4], "repeats": [1, 3]}
    port_inner, ref_inner = MeasuredTunable(), JaxMeasuredTunable()
    port = MetaEngineTunable(port_inner, space=space)
    ref = jax_tune.MetaEngineTunable(ref_inner, space=space)
    got = tune(port, engine="grid", cache=None)
    want = jax_tune.tune(ref, engine="grid", cache=None)
    assert got.best_config == want.best_config == {"top_k": 2, "repeats": 1}
    assert got.t_min == want.t_min
    assert port_inner.measure_calls == ref_inner.measure_calls == 24
    assert port.trials.keys() == ref.trials.keys()
    for key, trial in port.trials.items():
        assert (trial.best_config, trial.t_min, trial.oracle_calls) == \
            (ref.trials[key].best_config, ref.trials[key].t_min,
             ref.trials[key].oracle_calls)


# ---------------------------------------------------------------------------
# cache artifacts
# ---------------------------------------------------------------------------


def _warm_cache(tmp_path, name, tunables):
    cache = TuningCache(tmp_path / name)
    for t in tunables:
        tune(t, engine="grid", cache=cache)
    return cache


def test_artifact_export_merge_roundtrip_across_caches(tmp_path):
    src = _warm_cache(tmp_path, "src.json",
                      [CountingTunable("a"), CountingTunable("b")])
    art = tmp_path / "artifact.json"
    bundle = src.export_artifact(art)
    assert bundle["schema"] == ARTIFACT_SCHEMA == jax_tune.ARTIFACT_SCHEMA
    assert bundle["kind"] == ARTIFACT_KIND
    assert bundle["entry_count"] == 2

    dst = _warm_cache(tmp_path, "dst.json", [CountingTunable("c")])
    report = dst.merge_artifact(art)
    assert report["added"] == 2 and report["replaced"] == 0
    assert len(dst) == 3

    probe = CountingTunable("a")
    res = tune(probe, engine="grid", cache=dst)
    assert res.stats["cache"] == "hit" and probe.cost_calls == 0


def test_artifact_prefer_measured_policy(tmp_path):
    modeled = _warm_cache(tmp_path, "modeled.json", [MeasuredTunable()])
    key_mod, _ = cache_key(MeasuredTunable(), "grid")
    assert key_mod in modeled.entries

    entry = dict(modeled.entries[key_mod])
    entry["provenance"] = "measured"
    entry["created"] = entry["created"] - 1e6
    entry["best_config"] = {"block": 2}
    art = tmp_path / "a.json"
    bundle = {"kind": ARTIFACT_KIND, "schema": ARTIFACT_SCHEMA,
              "created": time.time(),
              "platforms": {"cpu/x": {"platform": {"backend": "cpu"},
                                      "entries": {key_mod: entry}}}}
    art.write_text(json.dumps(bundle))

    rep = modeled.merge_artifact(art)               # measured wins
    assert rep["replaced"] == 1
    assert modeled.entries[key_mod]["best_config"] == {"block": 2}

    entry2 = dict(entry)
    entry2["provenance"] = "modeled"
    entry2["created"] = time.time() + 1e6           # even though newer
    bundle["platforms"]["cpu/x"]["entries"] = {key_mod: entry2}
    art.write_text(json.dumps(bundle))
    rep2 = modeled.merge_artifact(art)
    assert rep2["kept"] == 1 and rep2["replaced"] == 0
    assert modeled.entries[key_mod]["provenance"] == "measured"


def test_artifact_provenance_meta_travels_with_entries(tmp_path, capsys):
    src = _warm_cache(tmp_path, "src.json", [CountingTunable("a")])
    art = tmp_path / "a.json"
    bundle = src.export_artifact(art)
    meta = bundle["meta"]
    assert meta["host"] and meta["python"] and meta["created_utc"]
    assert meta["tool"].startswith("repro_torch ")

    dst = TuningCache(tmp_path / "dst.json")
    report = dst.merge_artifact(art)
    assert report["meta"] == meta
    (entry,) = dst.entries.values()
    assert entry["origin"] == meta
    dst.save()

    assert cli_main(["--cache", str(tmp_path / "dst.json"),
                     "ls", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows[0]["origin"] == meta

    (local_entry,) = src.entries.values()
    assert "origin" not in local_entry

    (key,) = dst.entries
    dst._entries[key]["origin"] = {"host": "the-original-tuner"}
    art2 = tmp_path / "relay.json"
    dst.export_artifact(art2)
    dst2 = TuningCache(tmp_path / "dst2.json")
    dst2.merge_artifact(art2)
    assert dst2.entries[key]["origin"] == {"host": "the-original-tuner"}


def test_plan_parallel_serializes_timed_jobs(tmp_path):
    import threading
    events: list[str] = []
    lock = threading.Lock()

    class Tracker(CountingTunable):
        def __init__(self, ident, tag):
            super().__init__(ident)
            self.tag = tag

        def cost(self, cfg):
            with lock:
                events.append(self.tag)
            return super().cost(cfg)

        def measure(self, cfg):
            with lock:
                events.append(self.tag)
            return 1.0

    plan = TuningPlan(name="timed")
    plan.add(Tracker("m", "timed"), engine="measure", budget=1, repeats=1)
    plan.add(Tracker("a", "pooled"), engine="grid")
    plan.add(Tracker("b", "pooled"), engine="grid")
    plan.add(MetaEngineTunable(Tracker("q", "timed"),
                               space={"top_k": [1], "repeats": [1]}),
             engine="grid")
    assert [j.timed for j in plan.jobs] == [True, False, False, True]

    report = plan.run(cache=TuningCache(tmp_path / "c.json"), workers=4)
    assert report.ok
    assert [r.label for r in report.results][0] == "test.counting"
    first_timed = events.index("timed")
    assert all(e == "timed" for e in events[first_timed:])

    spec = {"jobs": [
        {"tunable": "meta.engine",
         "params": {"engine": "measure",
                    "inner": {"tunable": "kernels.tuned_reduction",
                              "params": {"n": 4096}},
                    "space": {"top_k": [1], "repeats": [1]}},
         "engine": "grid"},
        {"tunable": "kernels.tuned_reduction", "params": {"n": 4096},
         "engine": "grid"}]}
    assert [j.timed for j in TuningPlan.from_spec(spec).jobs] == [True, False]


def test_artifact_stale_schema_rejected(tmp_path):
    src = _warm_cache(tmp_path, "src.json", [CountingTunable()])
    art = tmp_path / "a.json"
    bundle = src.export_artifact(art)
    doc = json.loads(art.read_text())
    doc["schema"] = ARTIFACT_SCHEMA + 1
    art.write_text(json.dumps(doc))
    with pytest.raises(ArtifactError, match="schema"):
        src.merge_artifact(art)
    (tmp_path / "junk.json").write_text('{"hello": 1}')
    with pytest.raises(ArtifactError, match="not a"):
        src.merge_artifact(tmp_path / "junk.json")
    assert bundle["entry_count"] == 1


def test_artifact_platform_filter(tmp_path, monkeypatch):
    cache = TuningCache(tmp_path / "c.json")
    tune(CountingTunable("cpu-side"), engine="grid", cache=cache)
    monkeypatch.setattr("repro_torch.tune.cache.platform_fingerprint",
                        lambda: {"backend": "cuda",
                                 "device_kind": "NVIDIA H100 80GB HBM3"})
    tune(CountingTunable("card-side"), engine="grid", cache=cache)
    b_all = cache.export_artifact(tmp_path / "all.json")
    assert len(b_all["platforms"]) == 2
    b_cuda = cache.export_artifact(tmp_path / "cuda.json", platform="cuda")
    assert list(b_cuda["platforms"]) == ["cuda/NVIDIA H100 80GB HBM3"]
    assert b_cuda["entry_count"] == 1 and b_cuda["skipped"] == 1
    b_key = cache.export_artifact(tmp_path / "key.json",
                                  platform="cuda/NVIDIA H100 80GB HBM3")
    assert b_key["entry_count"] == 1


def test_dirty_cache_survives_gc_until_flushed(tmp_path):
    import gc
    import weakref

    from repro_torch.tune.cache import _dirty_caches
    cache = TuningCache(tmp_path / "c.json")
    tune(CountingTunable(), engine="grid", cache=cache)
    assert cache.dirty
    ref = weakref.ref(cache)
    del cache
    gc.collect()
    alive = ref()
    assert alive is not None and alive in _dirty_caches
    alive.save()
    assert alive not in _dirty_caches
    del alive
    gc.collect()
    assert ref() is None
    assert len(TuningCache(tmp_path / "c.json")) == 1


def test_cache_prune_by_backend_and_staleness(tmp_path):
    cache = _warm_cache(tmp_path, "c.json",
                        [CountingTunable("a"), CountingTunable("b")])
    key_a, _ = cache_key(CountingTunable("a"), "grid")
    cache._entries[key_a]["created"] -= 10 * 86400
    with pytest.raises(ValueError, match="prune needs"):
        cache.prune()
    assert cache.prune(backend="cuda") == 0             # no card entries
    assert cache.prune(stale_days=5) == 1               # the aged one
    assert cache.prune(backend="cpu") == 1              # the rest
    assert len(cache) == 0
    assert cache.stats["entries"] == 0


def test_cache_clear_removes_the_file(tmp_path):
    cache = _warm_cache(tmp_path, "c.json", [CountingTunable()])
    cache.save()
    assert cache.path.exists() and len(cache) == 1
    cache.clear()
    assert not cache.path.exists() and len(cache) == 0 and not cache.dirty


# ---------------------------------------------------------------------------
# bundles across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_bundle_from_either_package_merges_into_the_other(tmp_path, writer):
    """A bundle crosses packages whole; its entries keep their own
    platform fingerprints, so none answers the reading package's own
    lookup of the same tunable."""

    port_cache = _warm_cache(tmp_path, "port.json",
                             [CountingTunable("a"), CountingTunable("b")])
    ref_cache = jax_tune.TuningCache(tmp_path / "ref.json")
    for ident in ("a", "b"):
        jax_tune.tune(JaxCountingTunable(ident), engine="grid",
                      cache=ref_cache)
    art = tmp_path / "bundle.json"
    if writer == "repro":
        bundle = ref_cache.export_artifact(art)
        reader, probe_cls, tune_fn = (port_cache, CountingTunable, tune)
    else:
        bundle = port_cache.export_artifact(art)
        reader, probe_cls, tune_fn = (ref_cache, JaxCountingTunable,
                                      jax_tune.tune)
    assert bundle["entry_count"] == 2
    assert bundle["meta"]["tool"].split()[0] == writer
    before = len(reader)
    report = reader.merge_artifact(art)
    assert (report["added"], report["replaced"], report["kept"]) == (2, 0, 0)
    assert len(reader) == before + 2
    assert not set(port_cache.entries) & set(ref_cache.entries) - \
        set(bundle["platforms"][next(iter(bundle["platforms"]))]["entries"])
    probe = probe_cls("a")
    res = tune_fn(probe, engine="grid", cache=reader)
    assert res.stats["cache"] == "hit"          # its own entry, not theirs
    merged = {k: e for k, e in reader.entries.items() if "origin" in e}
    assert res.stats["key"] not in merged
    # the foreign entries prune by their own backend name
    backends = {(e["fingerprint"] or {})["platform"]["backend"]
                for e in merged.values()}
    assert backends == {"cpu"}


def _entry(provenance: str, created: float, block: int) -> dict:
    return {"best_config": {"block": block}, "t_min": float(block),
            "engine": "grid", "oracle_calls": 3, "elapsed_s": 0.0,
            "stats": {}, "witness": None, "created": created,
            "provenance": provenance,
            "fingerprint": {"platform": {"backend": "cpu",
                                         "device_kind": "cpu"}}}


# destination holds k1..k3; the bundle carries k1..k4
_DEST = {"k1": ("modeled", 100.0, 1), "k2": ("measured", 100.0, 2),
         "k3": ("modeled", 300.0, 3)}
_BUNDLE = {"k1": ("measured", 50.0, 4), "k2": ("modeled", 200.0, 4),
           "k3": ("modeled", 200.0, 4), "k4": ("modeled", 100.0, 4)}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
@pytest.mark.parametrize("policy", ["prefer_measured", "prefer_newer",
                                    "keep_existing"])
def test_merge_counts_match_reference_under_each_policy(tmp_path, policy,
                                                        writer):
    caches = {"repro": jax_tune.TuningCache, "repro_torch": TuningCache}
    src = caches[writer](tmp_path / "src.json")
    for key, e in _BUNDLE.items():
        src.put_entry(key, _entry(*e))
    art = tmp_path / "bundle.json"
    src.export_artifact(art)
    reports, tables = {}, {}
    for name, cls in caches.items():
        dst = cls(tmp_path / f"dst-{name}.json")
        for key, e in _DEST.items():
            dst.put_entry(key, _entry(*e))
        rep = dst.merge_artifact(art, policy=policy)
        reports[name] = (rep["added"], rep["replaced"], rep["kept"],
                         rep["platforms"], rep["policy"])
        tables[name] = {k: (e["provenance"], e["created"],
                            e["best_config"]["block"])
                        for k, e in dst.entries.items()}
    assert reports["repro"] == reports["repro_torch"]
    assert tables["repro"] == tables["repro_torch"]
    # which keys took the bundle's entry (block 4): measured beats
    # modeled whatever its age; newer wins on the timestamp alone
    taken = {"prefer_measured": {"k1", "k4"}, "prefer_newer": {"k2", "k4"},
             "keep_existing": {"k4"}}[policy]
    assert reports["repro_torch"][:3] == (1, len(taken) - 1, 4 - len(taken))
    assert {k for k, row in tables["repro_torch"].items()
            if row[2] == 4} == taken


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.tune warmup/export/merge/ls/prune
# ---------------------------------------------------------------------------


def _tiny_plan(tmp_path, device: str | None = "cpu"):
    extra = {"device": device} if device else {}
    spec = {"name": "ci", "jobs": [
        {"tunable": "kernels.matmul_tuned",
         "params": {"M": 128, "N": 128, "K": 128, "dtype_bytes": 4,
                    **extra},
         "engine": "grid"},
        {"tunable": "kernels.tuned_reduction",
         "params": {"n": 4096, **extra}, "engine": "grid"}]}
    p = tmp_path / ("plan.json" if device else "ref_plan.json")
    p.write_text(json.dumps(spec))
    return p


def test_cli_fleet_rollout_end_to_end(tmp_path, capsys):
    """warmup -> export -> merge into a fresh cache -> second warmup is
    100% hits -> @autotune resolves from pure cache hits (0 misses)."""

    plan = _tiny_plan(tmp_path)
    warm = str(tmp_path / "warm.json")
    node = str(tmp_path / "node.json")
    art = str(tmp_path / "artifact.json")
    assert cli_main(["--cache", warm, "warmup", str(plan)]) == 0
    assert cli_main(["--cache", warm, "export", art]) == 0
    assert cli_main(["--cache", node, "merge", art]) == 0
    capsys.readouterr()

    assert cli_main(["--cache", node, "warmup", str(plan), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["counts"]["hits"] == rep["counts"]["jobs"] == 2
    assert rep["counts"]["failed"] == 0

    node_cache = TuningCache(node)
    prev = set_default_cache(node_cache)
    try:
        a = torch.ones((128, 128), dtype=torch.float32)
        decision = matmul_tuned.tune(a, a)
        assert decision.stats["cache"] == "hit"
        out = matmul_tuned(a, a)
        torch.testing.assert_close(out, matmul_ref(a, a))
        assert node_cache.misses == 0 and node_cache.hits == 2
    finally:
        set_default_cache(prev)


def test_autotune_resolves_from_a_swapped_default_cache(tmp_path):
    """The in-process memo of ``@autotune`` is per cache: after a node
    swaps its default cache, a call resolves from the new one."""

    a = torch.ones((128, 128), dtype=torch.float32)
    first = TuningCache(tmp_path / "first.json")
    prev = set_default_cache(first)
    try:
        matmul_tuned(a, a)
        assert first.misses == 1
        matmul_tuned(a, a)                      # memo: no second lookup
        assert first.misses == 1 and first.hits == 0
        second = TuningCache(tmp_path / "second.json")
        set_default_cache(second)
        matmul_tuned(a, a)
        assert second.misses == 1
    finally:
        set_default_cache(prev)


def test_cli_warmup_exit_code_on_failure(tmp_path, capsys):
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"jobs": [{"tunable": "nope"}]}))
    assert cli_main(["--cache", str(tmp_path / "c.json"),
                     "warmup", str(p)]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_cli_ls_and_prune(tmp_path, capsys):
    plan = _tiny_plan(tmp_path)
    cache = str(tmp_path / "c.json")
    assert cli_main(["--cache", cache, "warmup", str(plan)]) == 0
    capsys.readouterr()
    assert cli_main(["--cache", cache, "ls", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 2
    assert {r["tunable"] for r in rows} == \
        {"kernels.matmul_tuned", "kernels.tuned_reduction"}
    assert all(len(r["key"]) == 64 for r in rows)
    assert {r["platform"] for r in rows} == {"cpu/cpu"}
    assert cli_main(["--cache", cache, "ls"]) == 0
    assert "2 entries" in capsys.readouterr().out
    assert cli_main(["--cache", cache, "prune"]) == 2   # no filters: refuse
    assert cli_main(["--cache", cache, "prune", "--backend", "cuda"]) == 0
    assert "pruned 0 entries -> 2 remain" in capsys.readouterr().out
    assert cli_main(["--cache", cache, "prune", "--stale-days", "0"]) == 0
    capsys.readouterr()
    assert cli_main(["--cache", cache, "ls"]) == 0
    assert "empty" in capsys.readouterr().out


def test_cli_merge_rejects_non_artifact(tmp_path, capsys):
    junk = tmp_path / "junk.json"
    junk.write_text("{}")
    assert cli_main(["--cache", str(tmp_path / "c.json"),
                     "merge", str(junk)]) == 2
    assert "error" in capsys.readouterr().err


def test_cli_cache_defaults_to_the_ports_env_var(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "env.json"))
    assert cli_main(["warmup", str(_tiny_plan(tmp_path))]) == 0
    assert (tmp_path / "env.json").exists()
    capsys.readouterr()
    assert cli_main(["ls", "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)) == 2


def _run_sequence(main, tmp_path, plan, capsys):
    """The reference's CLI acceptance sequence; returns each step's exit
    code and what it printed, times and platform stripped."""

    warm, node = str(tmp_path / "warm.json"), str(tmp_path / "node.json")
    art = str(tmp_path / "artifact.json")
    steps = [["--cache", warm, "warmup", str(plan), "--json"],
             ["--cache", warm, "export", art],
             ["--cache", node, "merge", art],
             ["--cache", node, "warmup", str(plan), "--json"],
             ["--cache", node, "ls", "--json"],
             ["--cache", node, "prune"],
             ["--cache", node, "prune", "--backend", "cpu"],
             ["--cache", node, "ls"],
             ["--cache", node, "merge", str(plan)]]
    out = []
    for argv in steps:
        rc = main(argv)
        text = capsys.readouterr()
        if argv[-1] == "--json":
            doc = json.loads(text.out)
            if isinstance(doc, dict):
                doc = {"counts": doc["counts"],
                       "jobs": [(j["label"], j["status"], j["provenance"])
                                for j in doc["jobs"]]}
            else:
                doc = sorted((r["tunable"], r["engine"], r["provenance"],
                              r["origin"] is not None) for r in doc)
            out.append((rc, doc))
        else:
            first = text.out.split("->")[0].replace(str(tmp_path), "T")
            out.append((rc, first, bool(text.err)))
    return out


def test_cli_matches_reference_step_for_step(tmp_path, capsys):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got = _run_sequence(cli_main, tmp_path / "port",
                        _tiny_plan(tmp_path / "port"), capsys)
    want = _run_sequence(jax_cli_main, tmp_path / "ref",
                         _tiny_plan(tmp_path / "ref", device=None), capsys)
    assert [g[0] for g in got] == [0, 0, 0, 0, 0, 2, 0, 0, 2]
    assert got == want


def test_python_m_repro_torch_tune(tmp_path):
    plan = _tiny_plan(tmp_path)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--cache",
         str(tmp_path / "c.json"), "warmup", str(plan), "--json"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout)
    assert rep["counts"]["tuned"] == 2
    assert "[1/2] kernels.matmul_tuned: tuned (grid)" in proc.stderr
