"""The port's calibration against the JAX package's: the probes' fits on
the same synthetic sweeps, a quick calibration on the CPU, load-or-probe,
the wave model's GMT from a measured spec, the plan's ``calibrate`` key,
the modeled-vs-measured trajectory and the ``python -m
repro_torch.calibrate`` CLI.

Every spec-dependent comparison installs one set of constants into both
packages' ``set_platform_spec`` and restores both afterwards; every
artifact goes to ``tmp_path`` (``$REPRO_TORCH_PLATFORM_SPEC`` is pointed
there), never under the home directory.  Tolerances: the fits, GMT and
the trajectory's records are compared exactly; ``fit_link_bw`` divides
the same aggregate by each package's own link count (4 in the reference,
18 NVLink links on the H100), so it is compared after multiplying back,
to 1e-12 relative.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import calibrate as jax_calibrate  # noqa: E402
from repro.calibrate import probes as jax_probes  # noqa: E402
from repro.calibrate import trajectory as jax_trajectory  # noqa: E402
from repro.core import wave_model as jax_wave_model  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.calibrate import probes, trajectory  # noqa: E402
from repro_torch.calibrate.cli import main as calibrate_main  # noqa: E402
from repro_torch.core import wave_model  # noqa: E402
from repro_torch.kernels.tuned_reduction.ops import ReductionTunable  # noqa: E402
from repro_torch.tune import TuningCache, TuningPlan  # noqa: E402
from repro_torch.tune.cache import cache_key  # noqa: E402

# H100-like, CPU-like and a ratio that rounds to a half
CONSTANTS = [dict(peak_flops=989e12, hbm_bw=3.35e12),
             dict(peak_flops=7.1e14, hbm_bw=2.9e12, dispatch_us=11.5),
             dict(peak_flops=150e9, hbm_bw=20e9),
             dict(peak_flops=1e12, hbm_bw=8e11)]


@pytest.fixture(autouse=True)
def _spec_state(tmp_path, monkeypatch):
    """No test reads or writes a spec outside ``tmp_path``, and the
    installed specs of both packages come back as they were."""

    monkeypatch.setenv("REPRO_TORCH_PLATFORM_SPEC",
                       str(tmp_path / "platform_spec.json"))
    monkeypatch.setenv("REPRO_PLATFORM_SPEC",
                       str(tmp_path / "jax_platform_spec.json"))
    prev = calibrate.set_platform_spec(None)
    jprev = jax_calibrate.set_platform_spec(None)
    yield
    calibrate.set_platform_spec(prev)
    jax_calibrate.set_platform_spec(jprev)


def _both(**constants):
    """Install one calibrated set of constants into both packages."""

    spec = calibrate.calibrated_replace(calibrate.DEFAULT_SPEC, **constants)
    jspec = jax_calibrate.spec.calibrated_replace(
        jax_calibrate.DEFAULT_SPEC, **constants)
    calibrate.set_platform_spec(spec)
    jax_calibrate.set_platform_spec(jspec)
    return spec, jspec


def _sweeps(seed):
    rng = np.random.default_rng(seed)
    mm = [{"n": float(n), "flops": float(2 * n ** 3),
           "us": float(rng.uniform(1, 5000))}
          for n in rng.integers(64, 8193, 5)]
    tr = [{"footprint": float(fp), "bytes": float(fp // 12 * 12),
           "us": float(rng.uniform(1, 2000))}
          for fp in rng.integers(1 << 16, 1 << 32, 6)]
    dp = [float(x) for x in rng.uniform(1, 80, int(rng.integers(1, 20)))]
    co = [{"size": float(s), "devices": 4,
           "bytes_per_device": float(1.5 * s), "us": float(rng.uniform(5, 900))}
          for s in rng.integers(1 << 10, 1 << 26, 3)]
    return mm, tr, dp, co


# -- fits -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_fits_equal_the_reference(seed):
    mm, tr, dp, co = _sweeps(seed)
    assert probes.fit_peak_flops(mm) == jax_probes.fit_peak_flops(mm)
    assert probes.fit_bandwidth(tr) == jax_probes.fit_bandwidth(tr)
    assert probes.fit_dispatch_us(dp) == jax_probes.fit_dispatch_us(dp)
    got = probes.fit_link_bw(co) * calibrate.DEFAULT_SPEC.links
    want = jax_probes.fit_link_bw(co) * jax_calibrate.DEFAULT_SPEC.links
    assert math.isclose(got, want, rel_tol=1e-12)
    assert calibrate.DEFAULT_SPEC.links == 18


def test_fits_refuse_empty_sweeps_as_the_reference_does():
    for fit in ("fit_peak_flops", "fit_bandwidth", "fit_dispatch_us"):
        with pytest.raises(calibrate.CalibrationError, match="empty"):
            getattr(probes, fit)([])
        with pytest.raises(jax_calibrate.CalibrationError, match="empty"):
            getattr(jax_probes, fit)([])
    assert probes.fit_link_bw([]) is None
    assert jax_probes.fit_link_bw([]) is None


def test_fit_bandwidth_reads_the_largest_footprint():
    sweep = [{"bytes": 3e6, "us": 1.0}, {"bytes": 3e9, "us": 1500.0},
             {"bytes": 3e8, "us": 50.0}]
    assert probes.fit_bandwidth(sweep) == 3e9 / 1500e-6


# -- the probes on the CPU --------------------------------------------------


def test_quick_calibration_on_the_cpu_has_the_reference_layout():
    spec = probes.run_calibration(quick=True, dispatch_reps=5, iters=2)
    ref = jax_probes.run_calibration(quick=True, dispatch_reps=5, iters=2)
    assert spec.source == "calibrated" and spec.backend == "cpu"
    assert spec.device_kind == "cpu" and spec.matches_device()
    assert set(spec.probes) == set(ref.probes)
    assert spec.probes["fitted"] == ["dispatch_us", "hbm_bw", "peak_flops"]
    assert spec.probes["fitted"] == ref.probes["fitted"]
    assert spec.probes["collective"] == [] == ref.probes["collective"]
    assert spec.probes["quick"] is True
    for name, keys in (("matmul", ("n", "flops")),
                       ("triad", ("footprint", "bytes"))):
        assert [{k: p[k] for k in keys} for p in spec.probes[name]] == \
            [{k: p[k] for k in keys} for p in ref.probes[name]]
        assert all(set(p) == set(q) for p, q in
                   zip(spec.probes[name], ref.probes[name]))
        assert all(p["us"] > 0 for p in spec.probes[name])
    assert len(spec.probes["dispatch"]) == 5
    assert spec.peak_flops == probes.fit_peak_flops(spec.probes["matmul"])
    assert spec.hbm_bw == probes.fit_bandwidth(spec.probes["triad"])
    assert spec.dispatch_us == probes.fit_dispatch_us(spec.probes["dispatch"])
    assert spec.link_bw == calibrate.DEFAULT_SPEC.link_bw
    assert spec.calibration_hash() != "default"


def test_quick_ladders_are_the_reference_ones_and_the_card_ladders_reach_past_l2():
    assert probes.QUICK_MATMUL_SIZES == jax_probes.QUICK_MATMUL_SIZES
    assert probes.QUICK_TRIAD_FOOTPRINTS == jax_probes.QUICK_TRIAD_FOOTPRINTS
    assert probes.CPU_MATMUL_SIZES == jax_probes.MATMUL_SIZES
    assert probes.CPU_TRIAD_FOOTPRINTS == jax_probes.TRIAD_FOOTPRINTS
    assert max(probes.TRIAD_FOOTPRINTS) >= 1 << 30       # >> 50 MB of L2
    assert max(probes.MATMUL_SIZES) >= 8192


def test_triad_is_one_add_into_a_preallocated_output(monkeypatch):
    calls = []
    real = torch.add

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(torch, "add", spy)
    sweep = probes.memory_bw_sweep([1 << 16], warmup=0, iters=2)
    assert len(calls) == 2
    assert all(kw.get("alpha") == 1.5 and "out" in kw for kw in calls)
    assert sweep[0]["bytes"] == 3 * 4 * ((1 << 16) // 12)


def test_dispatch_samples_are_one_launch_each():
    samples = probes.dispatch_latency_sweep(7, warmup=1)
    assert len(samples) == 7 and all(s > 0 for s in samples)


def test_collective_sweep_is_empty_without_two_cards():
    assert probes.collective_bw_sweep() == []


# -- load or probe ----------------------------------------------------------


def test_ensure_calibrated_probes_then_loads_then_forces(tmp_path):
    path = tmp_path / "spec.json"
    kw = dict(quick=True, dispatch_reps=3, iters=1)
    first, probed = probes.ensure_calibrated(path, **kw)
    assert probed and path.exists()
    assert calibrate.get_platform_spec() == first          # installed
    again, probed = probes.ensure_calibrated(path, **kw)
    assert not probed and again == first                   # a pure load
    forced, probed = probes.ensure_calibrated(path, force=True, **kw)
    assert probed and forced.created >= first.created
    assert calibrate.load_spec(path) == forced


def test_ensure_calibrated_reprobes_a_foreign_artifact(tmp_path):
    path = tmp_path / "spec.json"
    calibrate.calibrated_replace(calibrate.DEFAULT_SPEC, backend="cuda",
                                 device_kind="NVIDIA H100 80GB HBM3"
                                 ).save(path)
    spec, probed = probes.ensure_calibrated(path, quick=True,
                                            dispatch_reps=3, iters=1,
                                            install=False)
    assert probed and spec.backend == "cpu"
    # install=False leaves the active spec alone
    assert calibrate.get_platform_spec().source == "default"


def test_ensure_calibrated_defaults_to_the_port_artifact(tmp_path):
    spec, probed = probes.ensure_calibrated(quick=True, dispatch_reps=3,
                                            iters=1)
    assert probed
    assert (tmp_path / "platform_spec.json").exists()
    assert not (tmp_path / "jax_platform_spec.json").exists()


# -- the wave model under a measured spec -----------------------------------


@pytest.mark.parametrize("constants", CONSTANTS)
@pytest.mark.parametrize("el_bytes", [2, 4])
def test_gmt_from_spec_equals_the_reference(constants, el_bytes):
    spec, jspec = _both(**constants)
    want = jax_wave_model.gmt_from_spec(el_bytes=el_bytes)
    assert wave_model.gmt_from_spec(el_bytes=el_bytes) == want
    assert wave_model.gmt_from_spec(spec, el_bytes=el_bytes) == \
        jax_wave_model.gmt_from_spec(jspec, el_bytes=el_bytes) == want


@pytest.mark.parametrize("constants", CONSTANTS)
@pytest.mark.parametrize("size", [8, 64, 2**20])
def test_wave_params_from_platform_equal_the_reference(constants, size):
    spec, jspec = _both(**constants)
    kw = dict(NP=4, kind="minimum", L=2)
    got = wave_model.WaveParams.from_platform(size, spec=spec, **kw)
    want = jax_wave_model.WaveParams.from_platform(size, spec=jspec, **kw)
    assert (got.size, got.NP, got.GMT, got.L, got.kind, got.ND, got.NU,
            got.warp) == (want.size, want.NP, want.GMT, want.L, want.kind,
                          want.ND, want.NU, want.warp)
    assert got == wave_model.WaveParams.from_platform(size, **kw)  # active
    assert wave_model.model_time(got, 2, 2) == \
        jax_wave_model.model_time(want, 2, 2)


def test_the_h100_data_sheet_gmt():
    assert wave_model.gmt_from_spec(calibrate.DEFAULT_SPEC) == \
        round(989e12 * 4 / 3.35e12) == 1181


# -- the plan's "calibrate" key ---------------------------------------------


def _plan_spec(calibrated: bool) -> dict:
    spec = {"name": "cal", "jobs": [
        {"tunable": "platform.minimum", "params": {"size": 16},
         "engine": "sweep"}]}
    if calibrated:
        spec["calibrate"] = True
    return spec


def test_plan_calibrate_key_gates_and_rekeys(tmp_path):
    plain = TuningPlan.from_spec(_plan_spec(False))
    assert plain.require_calibration is False
    lines: list[str] = []
    plain_report = plain.run(cache=TuningCache(tmp_path / "c.json"),
                             progress=lines.append)
    assert not any(ln.startswith("[calibrate]") for ln in lines)

    plan = TuningPlan.from_spec(json.dumps(_plan_spec(True)))
    assert plan.require_calibration is True
    lines = []
    report = plan.run(cache=TuningCache(tmp_path / "c.json"),
                      progress=lines.append)
    assert lines[0].startswith("[calibrate] probed cpu/cpu hash=")
    assert report.ok and report.results[0].status == "tuned"
    assert report.results[0].key != plain_report.results[0].key
    assert report.results[0].best_config == plain_report.results[0].best_config
    # a second calibrated plan loads the artifact and hits
    lines = []
    again = TuningPlan.from_spec(_plan_spec(True)).run(
        cache=TuningCache(tmp_path / "c.json"), progress=lines.append)
    assert lines[0].startswith("[calibrate] loaded cpu/cpu hash=")
    assert again.results[0].status == "hit"
    assert again.results[0].key == report.results[0].key


def test_calibration_hash_enters_the_cache_key():
    tb = ReductionTunable(4096, device="cpu")
    default_key, _ = cache_key(tb, "grid")
    _both(peak_flops=1e12, hbm_bw=1e11)
    assert cache_key(tb, "grid")[0] != default_key


# -- the trajectory ---------------------------------------------------------


STATS = [
    {"modeled_pick": {"config": {"WG": 8, "TS": 4}, "measured": 12.5},
     "measured_pick": {"config": {"WG": 16, "TS": 4}, "measured": 10.0},
     "candidates": [1, 2, 3]},
    {"modeled_pick": {"config": {"batch": 8}, "measured": 3.0},
     "measured_pick": {"config": {"batch": 8}, "measured": 3.0},
     "candidates": [1]},
    {"modeled_pick": {"config": {"c": 1}, "measured": 5.0},
     "measured_pick": {"config": {"c": 2}, "measured": 0.0}},
]


@pytest.mark.parametrize("stats", STATS)
def test_gap_from_stats_equals_the_reference(stats):
    assert trajectory.gap_from_stats(stats) == \
        jax_trajectory.gap_from_stats(stats)


def test_gap_from_stats_needs_a_measure_result():
    with pytest.raises(calibrate.CalibrationError, match="measure-engine"):
        trajectory.gap_from_stats({"candidates": []})


def test_append_run_accumulates_and_refuses_foreign_files(tmp_path):
    path = tmp_path / "traj.json"
    recs = [dict(trajectory.gap_from_stats(STATS[0]), tunable="a")]
    run = trajectory.append_run(recs, path=path, extra={"note": "x"})
    trajectory.append_run(recs, path=path)
    doc = trajectory.load_trajectory(path)
    assert doc["kind"] == "repro_torch.calibrate/trajectory"
    assert len(doc["runs"]) == 2 and doc["runs"][0]["note"] == "x"
    assert run["tunables"] == recs
    assert run["meta"]["tool"].startswith("repro_torch ")
    assert run["created_utc"] == run["meta"]["created_utc"]
    assert run["source"] == "default" and run["calibration"] == "default"
    # the reference's run document has the same layout
    jrun = jax_trajectory.append_run(recs, path=tmp_path / "jax.json",
                                     extra={"note": "x"})
    assert set(run) == set(jrun) and set(run["meta"]) == set(jrun["meta"])
    assert run["tunables"] == jrun["tunables"]
    # the reference's file is some other artifact: refused, not clobbered
    with pytest.raises(calibrate.CalibrationError, match="not a calibration"):
        trajectory.load_trajectory(tmp_path / "jax.json")
    with pytest.raises(calibrate.CalibrationError):
        trajectory.append_run(recs, path=tmp_path / "jax.json")
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"kind": trajectory.TRAJECTORY_KIND,
                                 "schema": 99, "runs": []}))
    with pytest.raises(calibrate.CalibrationError, match="stale"):
        trajectory.load_trajectory(stale)
    assert trajectory.load_trajectory(tmp_path / "missing.json")["runs"] == []
    assert trajectory.TRAJECTORY_PATH != jax_trajectory.TRAJECTORY_PATH


def test_run_trajectory_measures_on_the_cpu(tmp_path):
    path = tmp_path / "traj.json"
    run = trajectory.run_trajectory(
        [("reduction-4096", ReductionTunable(4096, device="cpu")),
         ReductionTunable(2048, device="cpu")],
        path=path, top_k=2, repeats=1)
    labels = [r["tunable"] for r in run["tunables"]]
    assert labels == ["reduction-4096", "kernels.tuned_reduction"]
    for rec in run["tunables"]:
        assert rec["gap"] >= 1.0 and rec["candidates"] == 2
        assert rec["agree"] == (rec["modeled_config"]
                                == rec["measured_config"])
    # the platform the run was priced on: the active spec's (here the
    # data-sheet defaults), as in the reference
    assert run["platform"] == {"backend": "cuda",
                               "device_kind": "NVIDIA H100 SXM"}
    assert len(trajectory.load_trajectory(path)["runs"]) == 1


# -- the CLI ----------------------------------------------------------------


def test_cli_run_twice_is_a_pure_load(tmp_path, capsys):
    path = str(tmp_path / "cli.json")
    assert calibrate_main(["--spec", path, "run", "--quick", "--json"]) == 0
    first = json.loads(capsys.readouterr().out)
    assert first["status"] == "calibrated" and first["probes_run"] == 3
    assert first["backend"] == "cpu" and first["path"] == path
    assert calibrate_main(["--spec", path, "run", "--quick", "--json"]) == 0
    second = json.loads(capsys.readouterr().out)
    assert second["status"] == "loaded" and second["probes_run"] == 0
    assert second["calibration"] == first["calibration"]
    assert calibrate_main(["--spec", path, "run", "--quick"]) == 0
    out = capsys.readouterr().out
    assert "[calibrate] loaded (0 probes)" in out
    assert "dispatch_us" in out and "fitted" in out


def test_cli_show_and_export(tmp_path, capsys):
    path = tmp_path / "cli.json"
    assert calibrate_main(["--spec", str(path), "run", "--quick"]) == 0
    capsys.readouterr()
    assert calibrate_main(["--spec", str(path), "show", "--json"]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert shown["source"] == "calibrated"
    assert calibrate.get_platform_spec().source == "calibrated"
    out = tmp_path / "copy.json"
    assert calibrate_main(["--spec", str(path), "export", str(out)]) == 0
    assert "exported" in capsys.readouterr().out
    assert calibrate.load_spec(out) == calibrate.load_spec(path)
    # show without --spec resolves the active spec
    calibrate.set_platform_spec(None)
    assert calibrate_main(["show"]) == 0
    assert "source=default" in capsys.readouterr().out


def test_cli_errors_exit_1(tmp_path, capsys):
    missing = str(tmp_path / "missing.json")
    assert calibrate_main(["--spec", missing, "export",
                           str(tmp_path / "o.json")]) == 1
    assert "[calibrate] error" in capsys.readouterr().err
    foreign = tmp_path / "foreign.json"
    foreign.write_text(json.dumps({"kind": "something-else"}))
    assert calibrate_main(["--spec", str(foreign), "show"]) == 1
    assert calibrate_main(["--spec", str(foreign), "export",
                           str(tmp_path / "o.json")]) == 1
    with pytest.raises(SystemExit):
        calibrate_main(["no-such-command"])
