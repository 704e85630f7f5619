"""The whole slice on the CPU at a small size: the plan ``chip_smoke.py``
runs on the card (its phase 4), here with n = 2^14 and the plain
versions, held against the JAX package's plan and kernels."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.platform import PlatformSpec as JaxPlatformSpec  # noqa: E402
from repro.kernels.tuned_reduction.ops import reduce_1d as jax_reduce_1d  # noqa: E402
from repro.tune import PlatformTunable as JaxPlatformTunable  # noqa: E402
from repro.tune import TuningCache as JaxTuningCache  # noqa: E402
from repro.tune import TuningPlan as JaxTuningPlan  # noqa: E402
from repro_torch.interop import from_numpy, platform_spec_from_dict  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul_tuned.ops import MatmulTunable, matmul_tuned  # noqa: E402
from repro_torch.kernels.sweep_eval.ops import SweepEvalTunable, sweep_eval  # noqa: E402
from repro_torch.kernels.tuned_reduction.ops import (  # noqa: E402
    ReductionTunable, reduce_1d, reduce_chunked)
from repro_torch.tune import (PlatformTunable, TuningCache,  # noqa: E402
                              TuningPlan, set_default_cache)
from repro_torch.core.wave_model import WaveParams  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FlashAttentionTunable, flash_attention)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

N = 2**14
PAPER = {"size": 2**20, "NP": 128, "GMT": 16, "L": 8, "kind": "minimum"}
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _plan() -> TuningPlan:
    plan = TuningPlan(name="slice")
    plan.add(PlatformTunable(platform_spec_from_dict(PAPER)), engine="sweep",
             label="abstract-platform")
    plan.add(ReductionTunable(N, device="cpu"), engine="measure", top_k=2,
             repeats=1)
    plan.add(SweepEvalTunable(N, device="cpu"), engine="measure", top_k=2,
             repeats=1)
    plan.add(MatmulTunable(128, 128, 128, device="cpu"), engine="measure",
             top_k=2, repeats=1)
    return plan


def test_slice_plan_matches_jax_then_hits(tmp_path):
    cache = TuningCache(tmp_path / "port.json")
    report = _plan().run(cache=cache)
    assert report.ok, report.summary()
    assert [r.status for r in report.results] == ["tuned"] * 4
    assert all(r.provenance == "measured" for r in report.results[1:])

    jplan = JaxTuningPlan(name="slice")
    jplan.add(JaxPlatformTunable(JaxPlatformSpec(**PAPER)), engine="sweep")
    jres = jplan.run(cache=JaxTuningCache(tmp_path / "jax.json")).results[0]
    assert report.results[0].best_config == jres.best_config \
        == {"WG": 128, "TS": 8192}
    assert report.results[0].t_min == jres.t_min == 131224

    again = _plan().run(cache=TuningCache(tmp_path / "port.json"))
    assert [r.status for r in again.results] == ["hit"] * 4

    # the tuned kernels give what the JAX package gives
    rng = np.random.default_rng(0)
    x_np = rng.integers(-2**31, 2**31, N, dtype=np.int64).astype(np.int32)
    want = int(jax_reduce_1d(jnp.asarray(x_np), op="min", block_rows=16))
    x = from_numpy(x_np, "cpu")
    assert int(reduce_1d(x, op="min")) == want == int(x_np.min())
    decision = reduce_1d.tune(x, op="min")
    assert decision.stats["cache"] == "hit"
    assert int(reduce_chunked(x, "min", **decision.best_config)) == want


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = WaveParams(size=16, kind="minimum")
    api = build_model(get_config("smollm-135m").reduced())
    calls = [
        lambda: reduce_1d(np.arange(8, dtype=np.int32), op="min"),
        lambda: sweep_eval(np.ones(4, np.int32), np.ones(4, np.int32), p),
        lambda: matmul_tuned(np.ones((64, 64), np.float32),
                             np.ones((64, 64), np.float32)),
        lambda: ReductionTunable(1024).measure({"WG": 64, "TS": 1}),
        lambda: SweepEvalTunable(1024).measure({"threads": 64, "ept": 1}),
        lambda: MatmulTunable(64, 64, 64).measure(
            {"bm": 64, "bn": 64, "bk": 32}),
        lambda: from_numpy(np.ones(4, np.float32)),
        lambda: flash_attention(np.ones((1, 2, 128, 64), np.float32),
                                np.ones((1, 2, 128, 64), np.float32),
                                np.ones((1, 2, 128, 64), np.float32)),
        lambda: FlashAttentionTunable(S=128, D=64, BH=2).measure(
            {"block_q": 64, "block_k": 64}),
        lambda: api.init(0),
        lambda: api.init_decode_state(2, 16),
        lambda: serve_main(["--arch", "smollm-135m", "--requests", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # an explicit CPU request runs the plain versions
    assert int(reduce_1d(np.arange(8, dtype=np.int32), op="max",
                         device="cpu")) == 7


def test_the_port_imports_neither_jax_nor_repro():
    code = """
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    __import__(name)
bad = [m for m in sys.modules
       if m in ("jax", "ml_dtypes", "repro") or m.startswith(("jax.", "repro."))]
assert not bad, bad
assert len(names) >= 40, names
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("entry", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(entry):
    """ctypes passes arguments beyond ``argtypes`` as C ints, which cuts
    a pointer: each ``SIGNATURES`` line must list every parameter of its
    ``extern "C"`` function in ``csrc``."""

    src = "\n".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m is not None, entry
    assert len(m.group(1).split(",")) == len(_build.SIGNATURES[entry])
