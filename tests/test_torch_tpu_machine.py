"""The port's distributed machine model against the JAX package's, on
the CPU: ``step_time`` and ``hbm_fits`` on every lattice point,
``tune_distributed``'s pick and ranking, ``workload_from_arch`` and
``active_params`` for every registered config, and the lattice itself —
all under one set of platform constants installed into both packages
(``set_platform_spec``) and the same ``hbm_bytes``.  Then the port's own
defaults: the H100's constants and memory.

Equality is exact: both packages run the same float arithmetic.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import calibrate as jax_calibrate  # noqa: E402
from repro.core import tpu_machine as J  # noqa: E402
from repro.launch.roofline import active_params as jax_active_params  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import tpu_machine as T  # noqa: E402
from repro_torch.kernels.common import BF16_FLOPS, HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.roofline import active_params  # noqa: E402

SPEC = {"peak_flops": 500e12, "hbm_bw": 2.0e12, "link_bw": 40e9,
        "links": 4, "dci_bw": 20e9, "dispatch_us": 10.0}
# smollm-135m at B = 8, S = 2048 (the card's run), a 4k-token MoE-like
# step over a fleet, and one whose activations overflow small devices
WORKLOADS = {
    "smollm": dict(params=134_515_008, active_params=134_515_008, layers=30,
                   d_model=576, seq=2048, global_batch=8, vocab=49_152),
    "moe": dict(params=140_000_000_000, active_params=39_000_000_000,
                layers=56, d_model=6144, seq=4096, global_batch=256,
                vocab=32_768),
    "wide": dict(params=4_000_000_000, active_params=4_000_000_000,
                 layers=40, d_model=2560, seq=32_768, global_batch=64,
                 vocab=151_936),
}
PLATFORMS = [(1, 1), (8, 1), (256, 1), (8, 4)]   # (chips_per_pod, pods)


@pytest.fixture(autouse=True)
def shared_spec():
    jprev = jax_calibrate.set_platform_spec(jax_calibrate.PlatformSpec(
        **SPEC))
    prev = calibrate.set_platform_spec(calibrate.PlatformSpec(**SPEC))
    yield
    jax_calibrate.set_platform_spec(jprev)
    calibrate.set_platform_spec(prev)


def _lattice(chips, pods):
    space = T.config_space(chips, pods)
    jspace = J.config_space(chips, pods)
    got, want = list(space), list(jspace)
    assert got == want
    return got


@pytest.mark.parametrize("chips,pods", PLATFORMS)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_step_time_and_hbm_fits_on_every_point(name, chips, pods):
    w, jw = T.TPUWorkload(**WORKLOADS[name]), J.TPUWorkload(**WORKLOADS[name])
    tb = T.DistributedTunable(w, chips_per_pod=chips, pods=pods)
    jtb = J.DistributedTunable(jw, chips_per_pod=chips, pods=pods)
    for cfg in _lattice(chips, pods):
        c, jc = tb.to_config(cfg), jtb.to_config(cfg)
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert T.step_time(w, c) == J.step_time(jw, jc)
        assert T.step_time(w, c, overlap=0.3) == J.step_time(jw, jc,
                                                             overlap=0.3)
        for hbm in (16e9, 80e9):
            assert T.hbm_fits(w, c, hbm_bytes=hbm) == \
                J.hbm_fits(jw, jc, hbm_bytes=hbm)


@pytest.mark.parametrize("chips,pods", PLATFORMS)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("hbm", [16e9, 80e9])
def test_tune_distributed_matches(name, chips, pods, hbm):
    w, jw = T.TPUWorkload(**WORKLOADS[name]), J.TPUWorkload(**WORKLOADS[name])
    try:
        jbest, jdec, jranked = J.tune_distributed(
            jw, chips_per_pod=chips, pods=pods, hbm_bytes=hbm)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match=str(e)):
            T.tune_distributed(w, chips_per_pod=chips, pods=pods,
                               hbm_bytes=hbm)
        return
    best, dec, ranked = T.tune_distributed(w, chips_per_pod=chips,
                                           pods=pods, hbm_bytes=hbm)
    assert dataclasses.asdict(best) == dataclasses.asdict(jbest)
    assert dec == jdec
    assert [(t, dataclasses.asdict(c)) for t, c, _ in ranked] == \
        [(t, dataclasses.asdict(c)) for t, c, _ in jranked]
    tb = T.DistributedTunable(w, chips_per_pod=chips, pods=pods,
                              hbm_bytes=hbm)
    jtb = J.DistributedTunable(jw, chips_per_pod=chips, pods=pods,
                               hbm_bytes=hbm)
    assert tb.fingerprint() == jtb.fingerprint()


def test_the_card_run_fits_as_modeled():
    """smollm-135m at B = 8, S = 2048 on one 80 GB card: the model's
    cheapest point (no remat, one microbatch) fits by its count of
    activations (tokens x d x layers x 2 bytes)."""

    w = T.TPUWorkload(**WORKLOADS["smollm"])
    best, _, ranked = T.tune_distributed(w, chips_per_pod=1)
    assert (best.remat, best.microbatches) == ("none", 1)
    assert T.hbm_fits(w, best)
    assert len(ranked) == 24          # every point fits


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_workload_from_arch_and_active_params(arch):
    assert active_params(arch) == jax_active_params(arch)
    assert dataclasses.asdict(T.workload_from_arch(arch, "train_4k")) == \
        dataclasses.asdict(J.workload_from_arch(arch, "train_4k"))


def test_defaults_are_the_h100s():
    calibrate.set_platform_spec(None)
    try:
        assert T.PEAK_FLOPS == BF16_FLOPS == 989e12
        assert T.HBM_BW == HBM_BYTES_PER_S
        assert T.ICI_BW == 18 * 25e9 and T.DCI_BW == 50e9
        assert T.HBM_BYTES == 80e9
        w = T.TPUWorkload(**WORKLOADS["smollm"])
        tb = w.tunable()
        assert (tb.chips_per_pod, tb.pods, tb.hbm_bytes) == (256, 1, 80e9)
        assert T.DistributedTunable(w).fingerprint()["hbm_bytes"] == 80e9
        c = T.TPUConfig(dp=1, tp=1, remat="none")
        flops = 6.0 * w.active_params * w.seq * w.global_batch
        assert T.step_time(w, c)["compute"] == flops / 989e12
    finally:
        calibrate.set_platform_spec(calibrate.PlatformSpec(**SPEC))
