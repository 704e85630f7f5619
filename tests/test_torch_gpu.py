"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips without a CUDA device.  Run on
the H100 with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.

This file imports no JAX: the card's machine has none.  Parity with the
JAX package is held on the CPU by the other ``test_torch_*`` files,
through the same plain versions.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.search_space import wg_ts_space  # noqa: E402
from repro_torch.core.wave_model import WaveParams, model_time  # noqa: E402
from repro_torch.kernels.matmul_tuned.kernel import matmul_kernel  # noqa: E402
from repro_torch.kernels.matmul_tuned.ops import (matmul_ref,  # noqa: E402
                                                  matmul_tuned, tuning_space)
from repro_torch.kernels.sweep_eval.kernel import sweep_kernel  # noqa: E402
from repro_torch.kernels.sweep_eval.ops import sweep_eval, sweep_ref  # noqa: E402
from repro_torch.kernels.tuned_reduction.kernel import reduce_kernel  # noqa: E402
from repro_torch.kernels.tuned_reduction.ops import (  # noqa: E402
    ReductionTunable, reduce_1d, reduce_chunked)
from repro_torch.tune import TuningCache, set_default_cache, tune  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m gpu tests/test_torch_gpu.py)")
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield torch.device("cuda", 0)
    set_default_cache(prev)


def _data(dtype, n, device, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                             device=device, dtype=torch.int32)
    return (torch.randn(n, generator=g, device=device) * 100).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
@pytest.mark.parametrize("WG,TS", [(64, 1), (96, 8), (256, 64), (1024, 4)])
def test_reduction_kernel_equals_plain_version(cuda, dtype, op, WG, TS):
    x = _data(dtype, 2**20 + 17, cuda)          # ragged tail
    before = reduce_kernel.launches
    got = reduce_1d(x, op=op, WG=WG, TS=TS)
    assert reduce_kernel.launches == before + 1
    want = reduce_chunked(x, op, WG, TS)        # same fold order
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == ()
    assert torch.equal(got.cpu(), want.cpu()), (got, want)


@pytest.mark.parametrize("op", ["min", "max"])
def test_reduction_kernel_propagates_nan(cuda, op):
    x = _data(torch.float32, 100_000, cuda)
    x[31_337] = float("nan")
    assert torch.isnan(reduce_1d(x, op=op, WG=128, TS=16)).item()


@pytest.mark.parametrize("warp", [None, 32])
@pytest.mark.parametrize("threads,ept", [(64, 1), (256, 4), (1024, 16)])
def test_sweep_kernel_equals_plain_version_and_model(cuda, warp, threads,
                                                     ept):
    p = WaveParams(size=2**20, NP=128, GMT=16, L=8, kind="minimum", NU=132,
                   warp=warp)
    arrs = wg_ts_space(p.size).to_arrays()
    wg = torch.as_tensor(arrs["WG"], dtype=torch.int32, device=cuda)
    ts = torch.as_tensor(arrs["TS"], dtype=torch.int32, device=cuda)
    before = sweep_kernel.launches
    got = sweep_eval(wg, ts, p, threads=threads, ept=ept)
    assert sweep_kernel.launches == before + 1
    assert torch.equal(got, sweep_ref(p, wg, ts))
    want = [model_time(p, int(w), int(t)) for w, t in zip(arrs["WG"],
                                                          arrs["TS"])]
    assert got.cpu().tolist() == want


def test_sweep_kernel_on_a_dense_ragged_lattice(cuda):
    p = WaveParams(size=2**24, NP=64, GMT=16, L=4, kind="minimum", NU=15,
                   warp=8)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    n = 3 * 2**16 + 5
    wg = torch.randint(1, 5000, (n,), generator=g, device=cuda,
                       dtype=torch.int32)
    ts = torch.randint(1, 2**25, (n,), generator=g, device=cuda,
                       dtype=torch.int32)                  # some ts > size
    got = sweep_eval(wg, ts, p, threads=128, ept=8)
    assert torch.equal(got, sweep_ref(p, wg, ts))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.bfloat16, 5e-2)])
def test_matmul_kernel_every_tile_close_to_plain_version(cuda, dtype, tol):
    M, N, K = 256, 384, 512
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    a = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    b = torch.randn(K, N, generator=g, device=cuda).to(dtype)
    want = matmul_ref(a, b).float()
    for cfg in tuning_space(M, N, K, dtype_bytes=a.element_size()):
        before = matmul_kernel.launches
        got = matmul_tuned(a, b, **cfg)
        assert matmul_kernel.launches == before + 1
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * K ** 0.5, msg=str(cfg))


def test_measure_engine_on_the_card_then_cache_hit(cuda):
    t = ReductionTunable(2**22)
    first = tune(t, engine="measure", top_k=2, repeats=2)
    assert first.stats["provenance"] == "measured"
    assert first.stats["cache"] == "miss"
    assert tune(t, engine="measure", top_k=2, repeats=2).stats["cache"] == "hit"
    x = _data(torch.int32, 2**22, cuda)
    assert int(reduce_1d(x, op="min")) == int(x.min())
    assert reduce_1d.tune(x, op="min").stats["cache"] == "hit"


def test_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.ones(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        reduce_1d(x, op="min", WG=64, TS=1)
    with pytest.raises(ValueError):
        matmul_tuned(torch.ones(96, 64, device=cuda),
                     torch.ones(64, 64, device=cuda), bm=64, bn=64, bk=64)
