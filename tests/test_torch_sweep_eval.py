"""The port's sweep-eval kernel and wave model against the JAX package's.

``repro``'s ``sweep_eval`` (the Pallas kernel in interpret mode) and
``model_time`` against ``repro_torch``'s ``sweep_eval`` on CPU tensors
(the plain int32 version) and ``model_time_torch``, exactly, over the
whole (WG, TS) lattice; and the host's magic numbers, through which the
CUDA kernel divides by the wave parameters, against Python's ``//``.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.search_space import Param as JaxParam  # noqa: E402
from repro.core.search_space import SearchSpace as JaxSearchSpace  # noqa: E402
from repro.core.search_space import wg_ts_space as jax_wg_ts_space  # noqa: E402
from repro.core.sweep import sweep_times as jax_sweep_times  # noqa: E402
from repro.core.wave_model import WaveParams as JaxWaveParams  # noqa: E402
from repro.core.wave_model import model_time as jax_model_time  # noqa: E402
from repro.kernels.sweep_eval.ops import sweep_eval as jax_sweep_eval  # noqa: E402
from repro_torch.core.search_space import wg_ts_space  # noqa: E402
from repro_torch.core.sweep import sweep_times, sweep_times_torch  # noqa: E402
from repro_torch.core.wave_model import model_time, model_time_torch  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy, wave_params_from_dict  # noqa: E402
from repro_torch.kernels.sweep_eval.kernel import magic_u31  # noqa: E402
from repro_torch.kernels.sweep_eval.ops import (SENTINEL, sweep_eval,  # noqa: E402
                                                tuning_space)
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _params(size_exp: int, warp):
    return {"size": 1 << size_exp, "NP": 64, "GMT": 16, "L": 4,
            "kind": "minimum", "NU": 15, "warp": warp}


@pytest.mark.parametrize("warp", [None, 8])
@pytest.mark.parametrize("size_exp", range(4, 17))
def test_sweep_eval_matches_jax_kernel(size_exp, warp):
    d = _params(size_exp, warp)
    arrs = jax_wg_ts_space(d["size"]).to_arrays()
    want = np.asarray(jax_sweep_eval(jnp.asarray(arrs["WG"], jnp.int32),
                                     jnp.asarray(arrs["TS"], jnp.int32),
                                     JaxWaveParams(**d), block_rows=8))
    p = wave_params_from_dict(d)
    got = to_numpy(sweep_eval(from_numpy(arrs["WG"].astype(np.int32), "cpu"),
                              from_numpy(arrs["TS"].astype(np.int32), "cpu"),
                              p))
    np.testing.assert_array_equal(got, want)
    truth = [jax_model_time(JaxWaveParams(**d), int(w), int(t))
             for w, t in zip(arrs["WG"], arrs["TS"])]
    np.testing.assert_array_equal(got, np.asarray(truth))


@pytest.mark.parametrize("kind", ["minimum", "abstract"])
@pytest.mark.parametrize("warp", [None, 8])
def test_model_time_torch_matches_jax_model_time(kind, warp):
    d = {**_params(12, warp), "kind": kind}
    arrs = wg_ts_space(d["size"]).to_arrays()
    got = model_time_torch(wave_params_from_dict(d),
                           torch.from_numpy(arrs["WG"]),
                           torch.from_numpy(arrs["TS"]))
    assert got.dtype == torch.int64
    want = [jax_model_time(JaxWaveParams(**d), int(w), int(t))
            for w, t in zip(arrs["WG"], arrs["TS"])]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the scalar, numpy and tensor forms of the port agree too
    p = wave_params_from_dict(d)
    np.testing.assert_array_equal(sweep_times(p).times, np.asarray(want))
    np.testing.assert_array_equal(
        sweep_times_torch(p, torch.from_numpy(arrs["WG"]),
                          torch.from_numpy(arrs["TS"])).numpy(),
        [model_time(p, int(w), int(t)) for w, t in zip(arrs["WG"],
                                                        arrs["TS"])])


@pytest.mark.parametrize("kind", ["minimum", "abstract"])
@pytest.mark.parametrize("warp", [None, 32])
@pytest.mark.parametrize("size", [2**20, 1000])
def test_model_time_torch_follows_the_exact_engine_on_invalid_points(
        kind, warp, size):
    """One rule for invalid points: the reference's exact engine
    ``sweep_times`` gives its 2^62 sentinel where no work item exists
    (TS <= 0, or size // TS < 1) and clamps WG only as a divisor;
    ``model_time_torch`` gives the same times and its own sentinel
    there, and the int32 plain version of the kernel agrees."""

    d = {"size": size, "NP": 8, "GMT": 4, "L": 2, "kind": kind, "NU": 8,
         "warp": warp}
    space = JaxSearchSpace(params=[JaxParam("WG", (-3, 0, 1, 64)),
                                   JaxParam("TS", (-8, 0, 1, 16))])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # size // 0
        want = jax_sweep_times(JaxWaveParams(**d), space).times
    arrs = space.to_arrays()
    p = wave_params_from_dict(d)
    got = model_time_torch(p, torch.from_numpy(arrs["WG"]),
                           torch.from_numpy(arrs["TS"])).numpy()
    no_work = want == 2**62
    assert no_work.sum() == 8                    # TS in {-8, 0}
    np.testing.assert_array_equal(got[no_work], torch.iinfo(torch.int64).max)
    np.testing.assert_array_equal(got[~no_work], want[~no_work])
    if kind == "minimum":
        got32 = sweep_eval(torch.from_numpy(arrs["WG"].astype(np.int32)),
                           torch.from_numpy(arrs["TS"].astype(np.int32)), p,
                           threads=64, ept=1)
        np.testing.assert_array_equal(got32.numpy()[no_work], SENTINEL)
        np.testing.assert_array_equal(got32.numpy()[~no_work], want[~no_work])


def test_no_work_item_gives_sentinel():
    p = wave_params_from_dict(_params(6, None))
    out = sweep_eval(torch.tensor([4, 4], dtype=torch.int32),
                     torch.tensor([64, 128], dtype=torch.int32), p)
    assert out.tolist()[1] == SENTINEL and out.tolist()[0] != SENTINEL


def test_launch_shape_does_not_change_the_answer():
    p = wave_params_from_dict(_params(10, 8))
    # a dense 64 x 64 lattice: every (WG, TS) in [1, 64]^2
    wg, ts = (g.reshape(-1).to(torch.int32) for g in torch.meshgrid(
        torch.arange(1, 65), torch.arange(1, 65), indexing="ij"))
    outs = [sweep_eval(wg, ts, p, **c) for c in tuning_space(wg.numel())]
    assert len(outs) > 10
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_abstract_kind_is_refused():
    p = wave_params_from_dict({"size": 16, "kind": "abstract"})
    with pytest.raises(ValueError, match="Minimum"):
        sweep_eval(torch.ones(4, dtype=torch.int32),
                   torch.ones(4, dtype=torch.int32), p)


# The kernel divides by NP, U and warp through host-computed magic
# numbers; these hold magic_u31 to Python's // over 31-bit dividends.
_EDGE_DIVISORS = sorted({1, 2, 3, 7, 2**31 - 1}
                        | {2**k + e for k in range(1, 31) for e in (-1, 0, 1)
                           if 1 <= 2**k + e < 2**31})


def _magic_quotients(a: np.ndarray, d: int) -> np.ndarray:
    """The kernel's quotients, (umulhi(a, m) if m else a) >> s, exactly
    (a < 2^31 and m < 2^32, so a * m fits 64 bits)."""

    m, s = magic_u31(d)
    assert 0 <= m < 2**32 and 0 <= s <= 31
    a = a.astype(np.uint64)
    return (((a * np.uint64(m)) >> np.uint64(32)) if m else a) >> np.uint64(s)


def test_magic_numbers_divide_exactly_brute_force():
    rng = np.random.default_rng(0)
    a = np.concatenate([np.arange(0, 4097, dtype=np.int64),
                        rng.integers(0, 2**31, 4000),
                        2**31 - 1 - np.arange(0, 64)])
    for d in range(1, 4097):
        np.testing.assert_array_equal(_magic_quotients(a, d), a // d,
                                      err_msg=f"d={d}")


@pytest.mark.parametrize("d", _EDGE_DIVISORS)
def test_magic_numbers_at_the_edges(d):
    top = (2**31 - 1) // d * d
    a = np.array(sorted(v for v in {0, 1, d - 1, d, d + 1, 2 * d - 1,
                                    top - 1, top, 2**31 - 2, 2**31 - 1}
                        if 0 <= v < 2**31), dtype=np.int64)
    np.testing.assert_array_equal(_magic_quotients(a, d), a // d)


def test_magic_numbers_refuse_divisors_outside_31_bits():
    for d in (0, -1, 2**31):
        with pytest.raises(ValueError):
            magic_u31(d)


def test_power_of_two_divisors_are_shifts():
    assert [magic_u31(2**k) for k in range(31)] == [(0, k) for k in range(31)]
