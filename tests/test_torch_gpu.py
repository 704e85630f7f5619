"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips without a CUDA device.  Run on
the H100 with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.

This file imports no JAX: the card's machine has none.  Parity with the
JAX package is held on the CPU by the other ``test_torch_*`` files,
through the same plain versions.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.search_space import wg_ts_space  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    HEAD_DIMS, TILES, flash_kernel)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_ref, flash_attention, k_blocks)
from repro_torch.core.wave_model import WaveParams, model_time  # noqa: E402
from repro_torch.kernels.matmul_tuned.kernel import matmul_kernel  # noqa: E402
from repro_torch.kernels.matmul_tuned.ops import (matmul_ref,  # noqa: E402
                                                  matmul_tuned, tuning_space)
from repro_torch.kernels.sweep_eval.kernel import sweep_kernel  # noqa: E402
from repro_torch.kernels.sweep_eval.ops import sweep_eval, sweep_ref  # noqa: E402
from repro_torch.kernels.tuned_reduction.kernel import reduce_kernel  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import attention  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.transformer import block_params  # noqa: E402
from repro_torch.runtime import Server  # noqa: E402
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
    _sweep_equals_plain_and_model(p, threads, ept, cuda)


@pytest.mark.parametrize("NP,warp", [(2000, 33), (1, 1), (3, 2**31 - 1)])
def test_sweep_kernel_every_gmt_path(cuda, NP, warp):
    """NP above the shared-memory table's 1024 entries divides per
    point; a table of one or a few entries, and a warp wider than NP."""

    p = WaveParams(size=2**20, NP=NP, GMT=16, L=8, kind="minimum", NU=7,
                   warp=warp)
    _sweep_equals_plain_and_model(p, 256, 4, cuda)


def _sweep_equals_plain_and_model(p, threads, ept, cuda):
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


@pytest.mark.parametrize("dtype,offset", [(torch.int32, 1),
                                          (torch.float32, 1),
                                          (torch.bfloat16, 1),
                                          (torch.bfloat16, 3)])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_reduction_kernel_on_an_unaligned_view(cuda, dtype, offset, op):
    """x[offset:] is contiguous but not 16-byte aligned: the kernel reads
    the same groups, in the same order, element by element."""

    x = _data(dtype, 2**20 + 17, cuda, seed=3)[offset:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    for WG, TS in [(256, 64), (1024, 8), (96, 4)]:
        before = reduce_kernel.launches
        got = reduce_1d(x, op=op, WG=WG, TS=TS)
        assert reduce_kernel.launches == before + 1
        assert torch.equal(got.cpu(), reduce_chunked(x, op, WG, TS).cpu()), \
            (WG, TS)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_reduction_kernel_below_one_vector(cuda, dtype, op):
    full = _data(dtype, 8, cuda, seed=4)
    for n in range(1, 8):
        for WG, TS in [(64, 8), (32, 1), (33, 3)]:
            x = full[:n]
            got = reduce_1d(x, op=op, WG=WG, TS=TS)
            assert torch.equal(got.cpu(), reduce_chunked(x, op, WG, TS).cpu())
            if op != "sum":
                want = x.min() if op == "min" else x.max()
                assert torch.equal(got.cpu(), want.cpu())


def test_reductions_on_two_streams_at_once(cuda):
    """Each stream has its own partials and ticket: reductions in flight
    on two streams together give each stream's own answer."""

    xs = [_data(torch.float32, 2**23 + 5, cuda, seed=s) for s in (5, 6)]
    wants = [reduce_chunked(x, "sum", 256, 16) for x in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got: list[list] = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(reduce_1d(xs[i], op="sum", WG=256, TS=16))
    torch.cuda.synchronize()
    assert not torch.equal(wants[0], wants[1])
    for i in range(2):
        assert all(torch.equal(g, wants[i]) for g in got[i]), i


# points the kernel must get right as the plain version does: TS <= 0 (no
# work item), WG <= 0 (its signed path), the int32 extremes, size 0
_EDGE_WG_TS = [-2**31, -7, -1, 0, 1, 2, 3, 31, 32, 33, 127, 128, 129, 1000,
               2**20, 2**30, 2**31 - 1]


@pytest.mark.parametrize("size", [2**30, 12_345, 0, 2**31 - 1])
@pytest.mark.parametrize("NP,warp", [(128, None), (128, 32), (3, 7),
                                     (2000, 33)])
def test_sweep_kernel_on_invalid_and_extreme_points(cuda, size, NP, warp):
    p = WaveParams(size=size, NP=NP, GMT=16, L=8, kind="minimum", NU=132,
                   warp=warp)
    g = torch.Generator(device=cuda)
    g.manual_seed(size % 1000 + NP)
    edge = torch.tensor(_EDGE_WG_TS, dtype=torch.int32, device=cuda)
    wg = torch.cat([edge.repeat_interleave(len(_EDGE_WG_TS)),
                    torch.randint(-2**31, 2**31 - 1, (4099,), generator=g,
                                  device=cuda, dtype=torch.int32)])
    ts = torch.cat([edge.repeat(len(_EDGE_WG_TS)),
                    torch.randint(-2**31, 2**31 - 1, (4099,), generator=g,
                                  device=cuda, dtype=torch.int32)])
    for a, b in [(wg, ts), (wg[1:], ts[1:])]:       # vector and unaligned
        got = sweep_eval(a, b, p, threads=128, ept=2)
        assert torch.equal(got, sweep_ref(p, a, b))


def _mm_operands(shape, dtype, device, seed=2):
    M, N, K = shape
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    a = torch.randn(M, K, generator=g, device=device).to(dtype)
    b = torch.randn(K, N, generator=g, device=device).to(dtype)
    return a, b


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


# f32 (FMA kernel): every tile at (256, 384, 512) and (384, 640, 1024)
# (16 or 32 k-tiles, past each ring's depth); K = 32 and K = 64 are a
# single k-tile of bk = 32 and of bk = 64, fewer than any ring's stages.
# bf16 (wgmma kernel): at (256, 384, 512) only bn = 128 divides N; K = 64
# is a single step (K = bk); K = 192 is 3 steps, fewer than either ring's
# stages (4 for bn = 256, 7 for bn = 128).  Every bf16 case is also held
# to rel L2 <= 1e-2: a dropped stage of 64 of K's terms moves it by
# about sqrt(64 / K), a transposed or mis-swizzled B by order 1.
MM_REL_L2 = 1e-2


@pytest.mark.parametrize("dtype,tol,shape", [
    (torch.float32, 2e-3, (256, 384, 512)),
    (torch.float32, 2e-3, (384, 640, 1024)),
    (torch.float32, 2e-3, (256, 384, 32)),
    (torch.float32, 2e-3, (256, 384, 64)),
    (torch.bfloat16, 5e-2, (256, 384, 512)),
    (torch.bfloat16, 5e-2, (256, 512, 64)),
    (torch.bfloat16, 5e-2, (384, 512, 192))])
def test_matmul_kernel_every_tile_close_to_plain_version(cuda, dtype, tol,
                                                         shape):
    M, N, K = shape
    a, b = _mm_operands(shape, dtype, cuda)
    want = matmul_ref(a, b).float()
    space = list(tuning_space(M, N, K, dtype_bytes=a.element_size()))
    assert space
    for cfg in space:
        before = matmul_kernel.launches
        got = matmul_tuned(a, b, **cfg)
        assert matmul_kernel.launches == before + 1
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (M, N)
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * K ** 0.5, msg=str(cfg))
        if dtype == torch.bfloat16:
            assert _rel_l2(got, want) <= MM_REL_L2, cfg


@pytest.mark.parametrize("bn", [128, 256])
def test_matmul_kernel_identity_products_are_exact(cuda, bn):
    """I . B == B and A . I == A bit for bit: every product term is a
    single bf16 value times one, so any transposed, shifted or
    mis-swizzled element of either operand's tile shows."""

    K = 512
    g = torch.Generator(device=cuda)
    g.manual_seed(bn)
    eye = torch.eye(K, device=cuda).to(torch.bfloat16)
    b = torch.randn(K, bn, generator=g, device=cuda).to(torch.bfloat16)
    a = torch.randn(128, K, generator=g, device=cuda).to(torch.bfloat16)
    tile = {"bm": 128, "bn": bn, "bk": 64}
    assert torch.equal(matmul_tuned(eye[:128].contiguous(), b, **tile),
                       b[:128])
    assert torch.equal(matmul_tuned(a, eye[:, :bn].contiguous(), **tile),
                       a[:, :bn])


def test_matmul_kernel_f32_identity_products_are_exact(cuda):
    """I . B == B and A . I == A bit for bit at every f32 tile: every sum
    is one product term of one times an f32 value plus exact zeros, so a
    transposed, shifted or mis-staged element of either operand's tile,
    or a stage of the ring read before its copy landed, shows."""

    K = 512
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    eye = torch.eye(K, device=cuda)
    a = torch.randn(256, K, generator=g, device=cuda)
    b = torch.randn(K, 384, generator=g, device=cuda)
    space = list(tuning_space(256, 384, K, dtype_bytes=4))
    assert len(space) == 8
    for cfg in space:
        assert torch.equal(matmul_tuned(eye[:256].contiguous(), b, **cfg),
                           b[:256]), cfg
        assert torch.equal(matmul_tuned(a, eye[:, :384].contiguous(), **cfg),
                           a[:, :384]), cfg


def test_matmul_kernel_large_non_square_bf16(cuda):
    """Both bf16 tiles at (2048, 1536, 4096): 64 k-steps, several rounds
    of each ring, 16 x 12 or 16 x 6 blocks, held to rel L2 <= 1e-2."""

    shape = (2048, 1536, 4096)
    a, b = _mm_operands(shape, torch.bfloat16, cuda, seed=4)
    want = matmul_ref(a, b).float()
    space = list(tuning_space(*shape, dtype_bytes=2))
    assert {c["bn"] for c in space} == {128, 256}
    for cfg in space:
        got = matmul_tuned(a, b, **cfg)
        torch.cuda.synchronize()
        assert _rel_l2(got, want) <= MM_REL_L2, cfg
        torch.testing.assert_close(got.float(), want, rtol=5e-2,
                                   atol=5e-2 * shape[2] ** 0.5,
                                   msg=str(cfg))


def test_matmul_kernel_raises_on_what_tma_cannot_take(cuda):
    a, b = _mm_operands((256, 256, 256), torch.bfloat16, cuda)
    tile = {"bm": 128, "bn": 128, "bk": 64}
    flat = torch.zeros(256 * 256 + 8, dtype=torch.bfloat16, device=cuda)
    before = matmul_kernel.launches
    with pytest.raises(ValueError, match="not contiguous"):
        matmul_tuned(a.t(), b, **tile)
    with pytest.raises(ValueError, match="not contiguous"):
        matmul_tuned(a, torch.cat([b, b], 1)[:, :256], **tile)
    with pytest.raises(ValueError, match="16-byte aligned"):
        matmul_tuned(flat[1:1 + 256 * 256].view(256, 256), b, **tile)
    with pytest.raises(ValueError, match="row stride"):
        matmul_tuned(a[:, :66].contiguous(), b[:66].contiguous(), **tile)
    with pytest.raises(ValueError, match="not compiled"):
        matmul_tuned(a, b, bm=64, bn=128, bk=64)
    assert matmul_kernel.launches == before


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


# flash attention: bf16 |got - want| <= 2e-2 + 2e-2 |want| (P is rounded to
# bf16 for P.V, the output to bf16); f32 rtol 2e-5 / atol 2e-4, as the JAX
# package's kernel tests.  bf16 is also held to rel L2 <= 1e-2: with unit
# q, k, v over hundreds of keys |o| is about as small as the elementwise
# bound, which alone would pass a kernel that drops a k-block.
FLASH_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-5, 2e-4)}
FLASH_REL_L2 = 1e-2


def _qkv(shape, dtype, device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for _ in range(3)]


def _tiles(dtype):
    t = TILES[torch.empty((), dtype=dtype).element_size()]
    return [(bq, bk) for bq in t["block_q"] for bk in t["block_k"]]


def _flash_close(q, k, v, causal, window, bq, bk):
    """One launch of the tile, held to the plain version."""

    want = attention_ref(q, k, v, causal=causal, window=window).float()
    before = flash_kernel.launches
    got = flash_attention(q, k, v, causal=causal, window=window,
                          block_q=bq, block_k=bk)
    assert flash_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    rtol, atol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol,
                               msg=f"tile ({bq}, {bk})")
    if q.dtype == torch.bfloat16 and want.norm() > 0:
        assert _rel_l2(got, want) <= FLASH_REL_L2, (bq, bk)
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mask", [(True, None), (True, 100), (False, None),
                                  (True, 0)])
def test_flash_kernel_every_tile_close_to_plain_version(cuda, dtype, D,
                                                        mask):
    causal, window = mask
    S = 256
    q, k, v = _qkv((2, 3, S, D), dtype, cuda, seed=D + S)
    for bq, bk in _tiles(dtype):
        got = _flash_close(q, k, v, causal, window, bq, bk)
    if window == 0:
        assert not got.float().abs().max().item()


# bf16 rings shorter than their stages (3 at (128, 128, D = 128), 6 at
# block_k = 64 or D = 64, 13 at (64, 64)): S = block_k is a single
# k-block, S = 256 two to four
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("S,bk,causal", [(128, 128, False), (128, 128, True),
                                         (128, 64, False), (256, 128, True),
                                         (256, 64, False), (256, 64, True)])
def test_flash_kernel_bf16_fewer_k_blocks_than_stages(cuda, S, bk, causal,
                                                      D):
    q, k, v = _qkv((1, 4, S, D), torch.bfloat16, cuda, seed=S + bk + D)
    _flash_close(q, k, v, causal, None, 128, bk)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("bk", [64, 128])
def test_flash_kernel_bf16_q_blocks_with_no_relevant_k_block(cuda, bk, D):
    """A causal window of 0 leaves every row without a key, so no q-block
    has a relevant k-block: the producer loads nothing, no consumer waits
    on a barrier, and every row comes out as exact zeros; the next launch
    on the card still runs.  Without causality the same window leaves
    only the last row empty."""

    S = 512
    assert all(k_blocks(q_lo, q_lo + 127, S, bk, True, 0)[1] == 0
               for q_lo in range(0, S, 128))
    q, k, v = _qkv((2, 3, S, D), torch.bfloat16, cuda, seed=bk + D)
    got = _flash_close(q, k, v, True, 0, 128, bk)
    assert not got.float().abs().max().item()
    got = _flash_close(q, k, v, False, 0, 128, bk)
    assert not got[:, :, -1].float().abs().max().item()
    assert got[:, :, :-1].float().abs().sum(dim=-1).min().item() > 0
    _flash_close(q, k, v, True, None, 128, bk)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("bk", [64, 128])
def test_flash_kernel_bf16_one_hot_rows_are_exact(cuda, bk, D):
    """Causal with a window of 1: each row sees only its own key, so p = 1,
    l = 1 and the output is V's row bit for bit, whatever q and k are.  A
    transposed, shifted or mis-swizzled element of V's tile, or a P that
    lands on the wrong key, shows."""

    q, k, v = _qkv((2, 3, 512, D), torch.bfloat16, cuda, seed=3 * bk + D)
    got = flash_attention(q * 4, k * 4, v, causal=True, window=1,
                          block_q=128, block_k=bk)
    torch.cuda.synchronize()
    assert torch.equal(got, v)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bk", [(64, 64, 64), (64, 64, 32),
                                     (128, 128, 64)])
def test_flash_kernel_f32_few_k_blocks(cuda, S, bq, bk, causal, D):
    """S = block_k is a single k-block (the ring's first stage only); two
    k-blocks fill both stages once."""

    q, k, v = _qkv((2, 3, S, D), torch.float32, cuda, seed=S + bq + bk + D)
    _flash_close(q, k, v, causal, None, bq, bk)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("bq,bk", _tiles(torch.float32))
def test_flash_kernel_f32_q_blocks_with_no_relevant_k_block(cuda, bq, bk,
                                                            D):
    """A causal window of 0: no q-block has a relevant k-block, so no
    block copies anything or waits on a barrier, and every row is exact
    zeros; the next launch still runs.  Without causality the same window
    leaves only the last row empty."""

    S = 256
    assert all(k_blocks(q_lo, q_lo + bq - 1, S, bk, True, 0)[1] == 0
               for q_lo in range(0, S, bq))
    q, k, v = _qkv((2, 3, S, D), torch.float32, cuda, seed=bq + bk + D)
    got = _flash_close(q, k, v, True, 0, bq, bk)
    assert not got.abs().max().item()
    got = _flash_close(q, k, v, False, 0, bq, bk)
    assert not got[:, :, -1].abs().max().item()
    assert got[:, :, :-1].abs().sum(dim=-1).min().item() > 0
    _flash_close(q, k, v, True, None, bq, bk)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("bq,bk", _tiles(torch.float32))
def test_flash_kernel_f32_one_hot_rows_are_exact(cuda, bq, bk, D):
    """Causal with a window of 1: each row sees only its own key, so
    p = 2^0 = 1, l = 1 and the output is V's row bit for bit, whatever q
    and k are.  A mis-swizzled element of V's or P's tile, a P that lands
    on the wrong key, or a stale stage of the ring, shows."""

    q, k, v = _qkv((2, 3, 256, D), torch.float32, cuda, seed=3 * bk + bq + D)
    got = flash_attention(q * 4, k * 4, v, causal=True, window=1,
                          block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert torch.equal(got, v)


def test_flash_kernel_f32_at_the_model_shape(cuda):
    """qwen1.5-4b's attention, (1, 20, 4096, 128) causal, in f32 at the
    modeled tile, held to the f32 tolerance and to rel L2 <= 1e-2."""

    q, k, v = _qkv((1, 20, 4096, 128), torch.float32, cuda, seed=8)
    before = flash_kernel.launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_kernel.launches == before + 1
    want = attention_ref(q, k, v, causal=True)
    rtol, atol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    assert _rel_l2(got, want) <= FLASH_REL_L2


def test_flash_kernel_at_the_model_shape(cuda):
    q, k, v = _qkv((1, 20, 1024, 128), torch.bfloat16, cuda, seed=7)
    for window in (None, 256):
        got = flash_attention(q, k, v, causal=True, window=window)
        want = attention_ref(q, k, v, causal=True, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_flash_kernel_raises_for_an_uncompiled_head_dim(cuda):
    q, k, v = _qkv((1, 2, 128, 96), torch.bfloat16, cuda, seed=3)
    before = flash_kernel.launches
    with pytest.raises(ValueError, match="head dim 96"):
        flash_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="not compiled"):
        flash_attention(*_qkv((1, 2, 512, 64), torch.bfloat16, cuda, 4),
                        block_q=256, block_k=64)
    assert flash_kernel.launches == before


def test_attention_with_an_uncompiled_head_dim_raises_on_the_card(cuda):
    """use_flash=True on a CUDA tensor whose head dim was not compiled
    reaches the wrapper and raises; it does not take the plain math."""

    cfg = get_config("qwen1.5-4b").reduced().replace(head_dim=96)
    params = build_model(cfg).init(0, device=cuda)
    attn = block_params(params["blocks"], 0)["0_dense"]["attn"]
    g = torch.Generator(device=cuda)
    g.manual_seed(6)
    x = torch.randn(1, 128, cfg.d_model, generator=g, device=cuda
                    ).to(torch.bfloat16)
    pos = torch.arange(128, device=cuda)[None]
    before = flash_kernel.launches
    with pytest.raises(ValueError, match="head dim 96 is not compiled"):
        attention(attn, cfg, x, pos, use_flash=True)
    assert flash_kernel.launches == before


def test_reduced_forward_on_the_card_equals_the_cpu_port(cuda):
    """qwen1.5-4b reduced, with a head dim the kernel compiles: the card's
    forward (flash kernel, cuBLAS products) against the CPU port's (plain
    versions) on the same bf16 weights, within the bf16 tolerance."""

    cfg = get_config("qwen1.5-4b").reduced().replace(head_dim=64)
    api = build_model(cfg)
    params = api.init(0, device="cpu")
    on_card = tree_map(lambda t: t.to(cuda), params)
    g = torch.Generator()
    g.manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 256), generator=g)
    before = flash_kernel.launches
    got = api.forward(on_card, {"tokens": toks.to(cuda)})
    assert flash_kernel.launches == before + cfg.n_layers
    want = api.forward(params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=2e-2, atol=2e-2)

    # the Server on the card drains and agrees with its offline forward
    server = Server(api, on_card, batch=2, context=64, prefill_chunk=8)
    req = server.submit(toks[0, :20].tolist(), max_new=3)
    server.run_until_drained()
    assert req.done and len(req.out) == 3
