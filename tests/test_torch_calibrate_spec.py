"""The port's platform spec: H100 data-sheet defaults, the artifact's
JSON round trip and its rejections, the resolver's order (override,
then ``$REPRO_TORCH_PLATFORM_SPEC`` or the port's own default path, then
the defaults), the calibration id in the tuning cache's platform
fingerprint, and a cost model repriced by the constants."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro import calibrate as jax_calibrate  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.calibrate import (DEFAULT_SPEC, CalibrationError,  # noqa: E402
                                   PlatformSpec, calibrated_replace,
                                   calibration_hash, device_fingerprint,
                                   get_platform_spec, load_spec,
                                   set_platform_spec, spec_path)
from repro_torch.kernels.common import BF16_FLOPS, HBM_BYTES_PER_S  # noqa: E402
from repro_torch.kernels.tuned_reduction.ops import ReductionTunable  # noqa: E402
from repro_torch.runtime.speculate import SpecDepthTunable  # noqa: E402
from repro_torch.tune.cache import cache_key, platform_fingerprint  # noqa: E402


@pytest.fixture
def resolver(tmp_path, monkeypatch):
    """Disk resolution on (no override), the artifact path pointed into
    ``tmp_path``; the previous override is restored after."""

    monkeypatch.setenv("REPRO_TORCH_PLATFORM_SPEC",
                       str(tmp_path / "spec.json"))
    monkeypatch.delenv("REPRO_PLATFORM_SPEC", raising=False)
    prev = set_platform_spec(None)
    yield tmp_path / "spec.json"
    set_platform_spec(prev)


def cpu_like() -> PlatformSpec:
    """A calibrated spec with CPU-magnitude constants for this host."""

    return calibrated_replace(DEFAULT_SPEC, peak_flops=150e9, hbm_bw=20e9,
                              dispatch_us=80.0, **device_fingerprint())


def test_default_spec_is_the_h100_data_sheet():
    assert DEFAULT_SPEC.hbm_bw == HBM_BYTES_PER_S == 3.35e12
    assert DEFAULT_SPEC.peak_flops == BF16_FLOPS == 989e12
    assert (DEFAULT_SPEC.links, DEFAULT_SPEC.link_bw) == (18, 25e9)
    assert DEFAULT_SPEC.ici_bw == 450e9                 # NVLink 4, each way
    assert DEFAULT_SPEC.dispatch_us == 50.0     # a modeling assumption
    assert DEFAULT_SPEC.source == "default"
    # not the reference's constants
    ref = jax_calibrate.DEFAULT_SPEC
    assert DEFAULT_SPEC.hbm_bw != ref.hbm_bw
    assert DEFAULT_SPEC.peak_flops != ref.peak_flops


def test_resolves_to_the_defaults_without_an_artifact(resolver):
    assert not resolver.exists()
    assert get_platform_spec() is DEFAULT_SPEC
    assert calibration_hash() == "default"
    assert platform_fingerprint()["calibration"] == "default"


def test_json_round_trip(tmp_path):
    spec = cpu_like()
    path = spec.save(tmp_path / "a" / "spec.json")
    back = load_spec(path)
    assert back == spec
    assert back.calibration_hash() == spec.calibration_hash()
    doc = json.loads(path.read_text())
    assert doc["kind"] == calibrate.SPEC_KIND and doc["schema"] == 1


def test_stale_schema_and_foreign_kind_rejected(tmp_path):
    path = tmp_path / "spec.json"
    doc = cpu_like().to_json()
    path.write_text(json.dumps(dict(doc, schema=0)))
    with pytest.raises(CalibrationError, match="stale"):
        load_spec(path)
    path.write_text(json.dumps(dict(doc, kind="something/else")))
    with pytest.raises(CalibrationError, match="not a platform-spec"):
        load_spec(path)
    # an artifact the JAX package wrote is foreign to the port
    jax_calibrate.DEFAULT_SPEC.save(path)
    with pytest.raises(CalibrationError, match="not a platform-spec"):
        load_spec(path)
    path.write_text("[1, 2]")
    with pytest.raises(CalibrationError, match="not a JSON object"):
        load_spec(path)


def test_calibration_hash_reaches_the_cache_fingerprint(resolver):
    tb = ReductionTunable(1024, device="cpu")
    set_platform_spec(DEFAULT_SPEC)
    k_default, doc_default = cache_key(tb, "grid")
    assert doc_default["platform"]["calibration"] == "default"
    cal = cpu_like()
    h = cal.calibration_hash()
    assert len(h) == 12 and h != "default"
    assert int(h, 16) >= 0
    set_platform_spec(cal)
    assert calibration_hash() == h
    k_cal, doc_cal = cache_key(tb, "grid")
    assert doc_cal["platform"]["calibration"] == h
    assert k_cal != k_default
    # the constants, not the creation time, identify a calibration
    assert calibrated_replace(cal).calibration_hash() == h


def test_override_wins_over_the_artifact(resolver):
    cpu_like().save(resolver)
    other = calibrated_replace(DEFAULT_SPEC, hbm_bw=1e12,
                               **device_fingerprint())
    set_platform_spec(other)
    assert get_platform_spec() is other
    set_platform_spec(None)
    assert get_platform_spec() == load_spec(resolver)


def test_reads_the_port_variable_not_the_reference_one(resolver, tmp_path,
                                                       monkeypatch):
    cpu_like().save(resolver)
    assert spec_path() == resolver
    assert get_platform_spec().hbm_bw == 20e9
    # the reference's variable names an artifact the port never reads
    theirs = tmp_path / "theirs.json"
    calibrated_replace(DEFAULT_SPEC, hbm_bw=1e9,
                       **device_fingerprint()).save(theirs)
    monkeypatch.setenv("REPRO_PLATFORM_SPEC", str(theirs))
    monkeypatch.setenv("REPRO_TORCH_PLATFORM_SPEC",
                       str(tmp_path / "absent.json"))
    set_platform_spec(None)
    assert get_platform_spec() is DEFAULT_SPEC
    monkeypatch.delenv("REPRO_TORCH_PLATFORM_SPEC")
    assert str(spec_path()).endswith("repro_torch/platform_spec.json")


def test_artifact_of_another_device_is_ignored(resolver):
    calibrated_replace(DEFAULT_SPEC, hbm_bw=1e9, backend="cuda",
                       device_kind="some other card").save(resolver)
    assert get_platform_spec() is DEFAULT_SPEC


def test_spec_depth_ranking_flips_under_cpu_constants():
    tb = SpecDepthTunable(param_bytes=2_000_000_000, layers=24,
                          d_model=2048, kv_width=256, context=2048,
                          prompt_len=128, requests=32, mean_new=128,
                          batch=8, max_depth=8, drafters=("ngram",))
    prev = set_platform_spec(DEFAULT_SPEC)
    try:
        pick_default = min(tb.space(), key=tb.cost)
        set_platform_spec(cpu_like())
        pick_cpu = min(tb.space(), key=tb.cost)
    finally:
        set_platform_spec(prev)
    # on the H100's constants deep speculation pays; on CPU-magnitude
    # constants the extra verify FLOPs dominate and depth collapses
    assert pick_default["depth"] > pick_cpu["depth"]
