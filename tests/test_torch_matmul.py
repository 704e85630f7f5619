"""The port's tiled matmul against the JAX package's.

``repro``'s ``matmul_tuned(..., bm=bn=bk=128)`` (the Pallas kernel in
interpret mode) against ``repro_torch``'s ``matmul_tuned`` on CPU
tensors (the plain version: f32 product cast to the inputs' dtype), at
the shapes and tolerances of the JAX package's own kernel tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul_tuned.ops import matmul_tuned as jax_matmul_tuned  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels.matmul_tuned.ops import (MatmulTunable,  # noqa: E402
                                                  matmul_tuned, tuning_space)
from repro_torch.tune import TuningCache, set_default_cache, tune  # noqa: E402

SHAPES = [(128, 128, 128), (256, 384, 512), (512, 128, 256)]


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _operands(shape, dtype):
    M, N, K = shape
    rng = np.random.default_rng(M * 7 + N * 3 + K)
    a = jnp.asarray(rng.standard_normal((M, K)), dtype)
    b = jnp.asarray(rng.standard_normal((K, N)), dtype)
    return a, b


# tolerance: f32 sums in another order; bf16 rounds the output to 8 bits
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-3), (jnp.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape", SHAPES)
def test_matmul_matches_jax(dtype, tol, shape):
    a, b = _operands(shape, dtype)
    want = np.asarray(jax_matmul_tuned(a, b, bm=128, bn=128, bk=128),
                      np.float32)
    ta = from_numpy(np.asarray(a), "cpu")
    tb = from_numpy(np.asarray(b), "cpu")
    got = matmul_tuned(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (shape[0], shape[1])
    K = shape[2]
    np.testing.assert_allclose(to_numpy(got), want, rtol=tol,
                               atol=tol * K ** 0.5)


def test_every_tile_of_the_lattice_gives_the_same_product():
    a, b = _operands((256, 384, 512), jnp.float32)
    ta = from_numpy(np.asarray(a), "cpu")
    tb = from_numpy(np.asarray(b), "cpu")
    space = tuning_space(256, 384, 512, dtype_bytes=4)
    outs = [matmul_tuned(ta, tb, **cfg) for cfg in space]
    assert len(outs) == 8
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_undivisible_dims_and_uncompiled_tiles_raise():
    a = torch.ones(96, 64)
    b = torch.ones(64, 64)
    with pytest.raises(ValueError, match="divisible"):
        matmul_tuned(a, b, bm=64, bn=64, bk=64)
    with pytest.raises(ValueError, match="not compiled"):
        matmul_tuned(torch.ones(128, 128), torch.ones(128, 128),
                     bm=128, bn=128, bk=128)
    with pytest.raises(ValueError, match="no compiled tile"):
        tuning_space(96, 64, 64)


def test_cost_model_prefers_large_tiles_on_the_h100():
    res = tune(MatmulTunable(8192, 8192, 8192), engine="grid", cache=None)
    assert res.best_config == {"bm": 128, "bn": 128, "bk": 64}
    # the f32 product is priced at the FMA rate, well above the bf16 one
    f32 = MatmulTunable(8192, 8192, 8192, dtype_bytes=4)
    assert f32.cost(res.best_config) > \
        MatmulTunable(8192, 8192, 8192).cost(res.best_config)
