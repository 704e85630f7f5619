"""The port's tuned reduction against the JAX package's.

The same seeded numpy inputs go through ``repro``'s ``reduce_1d`` (the
Pallas kernel in interpret mode) and ``repro_torch``'s ``reduce_1d`` on
CPU tensors (the plain version, which folds in the CUDA kernel's order),
and that order itself, over the paths the kernel takes, against the JAX
package's reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.tuned_reduction.ops import reduce_1d as jax_reduce_1d  # noqa: E402
from repro.kernels.tuned_reduction.ref import reduce_ref as jax_reduce_ref  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels.tuned_reduction.ops import (  # noqa: E402
    reduce_1d, reduce_chunked, tuning_space)
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402

JAX_DTYPES = {"int32": jnp.int32, "float32": jnp.float32,
              "bfloat16": jnp.bfloat16}
SIZES = [1, 100, 128 * 8, 128 * 8 * 3 + 17, 100_000]


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _both(x_np, dtype: str, op: str):
    """(JAX result, port result), both as numpy."""

    xj = jnp.asarray(x_np, JAX_DTYPES[dtype])
    want = np.asarray(jax_reduce_1d(xj, op=op, block_rows=16))
    got = to_numpy(reduce_1d(from_numpy(np.asarray(xj), "cpu"), op=op))
    return want, got


@pytest.mark.parametrize("dtype", list(JAX_DTYPES))
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["min", "max"])
def test_min_max_match_jax_exactly(dtype, n, op):
    rng = np.random.default_rng(n * 7 + len(op))
    want, got = _both(rng.standard_normal(n) * 100, dtype, op)
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("n", SIZES)
def test_int32_sum_wraps_like_jax(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    want, got = _both(x, "int32", "sum")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_f32_sum_matches_jax(n):
    # tolerance: both accumulate in f32, in different orders
    rng = np.random.default_rng(n + 1)
    want, got = _both(rng.standard_normal(n) * 100, "float32", "sum")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * n)


@pytest.mark.parametrize("op", ["min", "max"])
def test_nan_propagates(op):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(3089).astype(np.float32)
    x[1234] = np.nan
    want, got = _both(x, "float32", op)
    assert np.isnan(want) and np.isnan(got)


def test_bf16_sum_rounds_once():
    # the port sums bf16 in f32 and rounds once: within one bf16 ulp of
    # the f64 sum of the same bf16 values
    rng = np.random.default_rng(5)
    x = from_numpy(rng.standard_normal(3089).astype(np.float32),
                   "cpu").to(torch.bfloat16)
    got = float(reduce_1d(x, op="sum"))
    exact = float(x.double().sum())
    assert abs(got - exact) <= abs(exact) * 2**-8 + 1e-6


@pytest.mark.parametrize("dtype,op", [("int32", "min"), ("int32", "max"),
                                      ("int32", "sum"), ("float32", "min"),
                                      ("bfloat16", "max"),
                                      ("float32", "sum")])
def test_result_does_not_depend_on_wg_ts(dtype, op):
    """The tuning parameters must not change the answer (the invariant
    the paper's auto-tuning relies on), over the port's whole lattice."""

    n = 12_345
    rng = np.random.default_rng(11)
    if dtype == "int32":
        x_np = rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
        x_np = x_np.astype(np.int32)
    else:
        x_np = rng.standard_normal(n).astype(np.float32) * 100
    x = from_numpy(np.asarray(jnp.asarray(x_np, JAX_DTYPES[dtype])), "cpu")
    results = {(c["WG"], c["TS"]): to_numpy(reduce_chunked(x, op, c["WG"],
                                                           c["TS"]))
               for c in tuning_space(n)}
    assert len(results) > 100
    first = next(iter(results.values()))
    for cfg, r in results.items():
        if op == "sum" and dtype == "float32":
            np.testing.assert_allclose(r, first, rtol=1e-5, err_msg=str(cfg))
        else:
            np.testing.assert_array_equal(r, first, err_msg=str(cfg))


def test_explicit_launch_parameters_and_autotune_agree():
    rng = np.random.default_rng(2)
    x = from_numpy(rng.integers(-10**6, 10**6, 5000).astype(np.int32), "cpu")
    tuned = reduce_1d(x, op="max")
    decision = reduce_1d.tune(x, op="max")
    assert decision.stats["cache"] == "hit"
    pinned = reduce_1d(x, op="max", WG=96, TS=4)
    assert int(tuned) == int(pinned) == int(x.max())


# (WG, TS) that take each path of the kernel's fold order: TS below the
# 16-byte vector's count (4 int32/f32, 8 bf16), an odd TS, TS = 2 and 4
# mod 8, groups of a whole vector, and WG not a multiple of 32
CHUNKED_CFGS = [(64, 1), (96, 2), (33, 3), (40, 4), (64, 6), (128, 8),
                (1000, 12), (32, 64)]


@pytest.mark.parametrize("dtype", list(JAX_DTYPES))
@pytest.mark.parametrize("op", ["min", "max", "sum"])
@pytest.mark.parametrize("n", [1, 7, 31, 1000, 4099, 12_345])
def test_chunked_order_matches_jax_reference(dtype, op, n):
    """The kernel's fold order (reduce_chunked) against the JAX
    package's reference: exact for min, max and the int32 sum (which
    wraps); a float sum within 1e-5 of sum|x| (f32 accumulation in
    another order), bf16 rounded once more, within 2^-8 of the result."""

    rng = np.random.default_rng(n * 3 + len(op) + len(dtype))
    if dtype == "int32":
        x_np = rng.integers(-2**31, 2**31, size=n, dtype=np.int64)
    else:
        x_np = rng.standard_normal(n) * 100
    xj = jnp.asarray(x_np, JAX_DTYPES[dtype])
    wide = xj.astype(jnp.float32) if dtype == "bfloat16" else xj
    want = np.asarray(jax_reduce_ref(wide, op)).astype(np.float64)
    x = from_numpy(np.asarray(xj), "cpu")
    for WG, TS in CHUNKED_CFGS:
        got = reduce_chunked(x, op, WG, TS)
        assert got.dtype == x.dtype and got.shape == ()
        got = float(got.double()) if dtype != "int32" else int(got)
        if op != "sum" or dtype == "int32":
            assert got == want, (WG, TS)
            continue
        tol = 1e-5 * float(np.abs(np.asarray(wide, np.float64)).sum())
        if dtype == "bfloat16":
            tol += abs(want) * 2**-8
        assert abs(got - want) <= tol, (WG, TS, got, want)
