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
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
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


def test_flash_kernel_at_hymba_window(cuda):
    """hymba-1.5b's attention: 25 query heads over 5 KV heads at D = 64,
    a 1,024-token window, bf16.  The kernel alone at (1, 25, 4096, 64)
    and through the model's attention (GQA repeat, RoPE) with
    use_flash, each against the plain version, rel L2 <= 1e-2."""

    q, k, v = _qkv((1, 25, 4096, 64), torch.bfloat16, cuda, seed=9)
    before = flash_kernel.launches
    got = flash_attention(q, k, v, causal=True, window=1024)
    assert flash_kernel.launches == before + 1
    want = attention_ref(q, k, v, causal=True, window=1024)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_l2(got, want) <= FLASH_REL_L2

    cfg = get_config("hymba-1.5b")
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window) == \
        (25, 5, 64, 1024)
    from repro_torch.models.attention import attn_specs
    from repro_torch.models.common import init_params
    g = torch.Generator(device=cuda)
    g.manual_seed(10)
    p = init_params(attn_specs(cfg), g, cuda)
    x = torch.randn(1, 2048, cfg.d_model, generator=g, device=cuda
                    ).to(torch.bfloat16)
    pos = torch.arange(2048, device=cuda)[None]
    before = flash_kernel.launches
    got = attention(p, cfg, x, pos, window=cfg.window, use_flash=True)
    assert flash_kernel.launches == before + 1
    want = attention(p, cfg, x, pos, window=cfg.window)
    assert _rel_l2(got, want) <= FLASH_REL_L2


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


@pytest.mark.parametrize("name", ["hymba-1.5b", "mamba2-2.7b",
                                  "mixtral-8x22b", "whisper-medium",
                                  "llama-3.2-vision-90b"])
def test_reduced_family_on_the_card_equals_the_cpu_port(cuda, name):
    """Each other family reduced with D = 64 and use_flash, f32 weights:
    the card's forward (flash where the gate takes it) against the CPU
    port's (the kernel's plain version), and a Server drain on the card
    against one on the CPU, token for token."""

    cfg = get_config(name).reduced().replace(head_dim=64, use_flash=True,
                                             logits_dtype="float32")
    api = build_model(cfg)
    params = tree_map(lambda t: t.float(), api.init(0, device="cpu"))
    on_card = tree_map(lambda t: t.to(cuda), params)
    g = torch.Generator()
    g.manual_seed(11)
    toks = torch.randint(0, cfg.vocab, (2, 128), generator=g)
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model,
                                      generator=g) * 0.3
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn(2, cfg.n_img_tokens, cfg.d_model,
                                          generator=g) * 0.3
    before = flash_kernel.launches
    # f32 stays f32 in the SSM's conv too
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = api.forward(on_card, {k: v.to(cuda)
                                    for k, v in batch.items()})
    attn_layers = {"mamba2-2.7b": 0, "llama-3.2-vision-90b": 2}
    assert flash_kernel.launches == before + attn_layers.get(
        name, cfg.n_layers)
    want = api.forward(params, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)

    def drain(p, device):
        server = Server(api, p, batch=2, context=64, prefill_chunk=8)
        frames = batch.get("frames")
        reqs = [server.submit(toks[i, :10 + 5 * i].tolist(), max_new=4,
                              frames=None if frames is None
                              else frames[i].to(device))
                for i in range(2)]
        server.run_until_drained()
        return [r.out for r in reqs]

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        assert drain(on_card, cuda) == drain(params, "cpu")


def _f32_model(cuda):
    """qwen1.5-4b reduced with a compiled head dim, f32 weights made on
    the host from seed 0 and moved to the card."""

    cfg = get_config("qwen1.5-4b").reduced().replace(head_dim=64,
                                                     logits_dtype="float32")
    api = build_model(cfg)
    return api, tree_map(lambda t: t.float().to(cuda),
                         api.init(0, device="cpu"))


def _cycled(n, length):
    return [[(r + i % 4) % 255 + 1 for i in range(length)] for r in range(n)]


@pytest.mark.parametrize("share_prefix", [False, True])
def test_paged_server_on_the_card_matches_contiguous(cuda, share_prefix):
    """A paged Server whose free list is shuffled from a seed (physical
    pages out of order), under page pressure, gives the contiguous
    drain's tokens on the card; with a shared 16-token prefix it maps
    pages and still does."""

    import numpy as np

    api, params = _f32_model(cuda)
    prefix = _cycled(1, 16)[0] if share_prefix else []
    prompts = [prefix + q for q in _cycled(4, 6)]

    def drain(**kw):
        srv = Server(api, params, batch=3, context=48, prefill_chunk=4, **kw)
        if srv.paged:
            rng = np.random.default_rng(7)
            srv.alloc._free = [int(x) for x in
                               rng.permutation(srv.alloc.spec.n_pages)]
        reqs = [srv.submit(prompts[0], max_new=6)]
        while not reqs[0].out:
            srv.tick()
        reqs += [srv.submit(q, max_new=6) for q in prompts[1:]]
        srv.run_until_drained()
        assert all(r.done for r in reqs)
        return [r.out for r in reqs], srv

    want, _ = drain()
    got, srv = drain(paged=True, page_size=4, kv_pages=24,
                     share_prefix=share_prefix,
                     scheduler="prefix" if share_prefix else None)
    assert srv.state["blocks"]["0_dense"]["kv"]["k"].device == cuda
    assert got == want
    assert (srv.stats()["share_hits"] > 0) == share_prefix
    assert srv.alloc.used_pages == 0


@pytest.mark.parametrize("paged", [False, True])
def test_self_draft_accepts_every_draft_on_the_card(cuda, paged):
    """On a model whose greedy steps all have a decisive top-2 gap
    (>= 1e-3 in f32, checked here against an offline forward), self-draft
    accepts every draft and gives the non-speculative drain's tokens."""

    api, params = _f32_model(cuda)
    prompts = _cycled(3, 8)
    pk = dict(paged=True, page_size=4) if paged else {}

    def drain(**kw):
        srv = Server(api, params, batch=2, context=32, prefill_chunk=4,
                     **pk, **kw)
        reqs = [srv.submit(q, max_new=8) for q in prompts]
        srv.run_until_drained()
        return [r.out for r in reqs], srv

    base, _ = drain()
    for q, out in zip(prompts, base):
        toks = list(q)
        for t in out:
            lg = api.forward(params, {"tokens": torch.tensor([toks],
                                                             device=cuda)})
            top = torch.topk(lg[0, -1], 2).values
            assert float(top[0] - top[1]) >= 1e-3
            assert int(lg[0, -1].argmax()) == t
            toks.append(t)
    outs, srv = drain(speculate="draft", spec_depth=4)
    assert outs == base
    st = srv.stats()
    assert st["spec_proposed"] > 0 and st["accept_rate"] == 1.0


def test_prefill_over_some_rows_on_the_card_equals_the_padded_step(cuda):
    """Reduced qwen1.5-4b in bf16 on the card, paged: ``prefill_step``
    over three prefilling rows of eight (one starting mid-page) against
    the padded step over all eight, the others at length 0: the same
    logits for those rows and the same pools, within bf16 round-off."""

    import numpy as np
    from repro_torch.runtime.kv import NO_PAGE, PagedKVSpec

    cfg = get_config("qwen1.5-4b").reduced().replace(head_dim=64)
    api = build_model(cfg)
    params = tree_map(lambda t: t.to(cuda), api.init(0, device="cpu"))
    B, context, page, T = 8, 64, 16, 32
    spec = PagedKVSpec.for_server(context=context, page_size=page, batch=B)
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    state = tree_map(
        lambda t: torch.randn(t.shape, generator=g, device=cuda).to(t.dtype),
        api.init_decode_state(B, context, spec, device=cuda))
    rng = np.random.default_rng(4)
    pos = np.array([0, 17, 5, 32, 0, 9, 30, 2], np.int32)
    rows = [1, 3, 6]
    lengths = np.zeros(B, np.int32)
    lengths[rows] = [32, 7, 20]
    table = np.full((B, spec.pages_per_slot), NO_PAGE, np.int32)
    free = iter(rng.permutation(spec.n_pages).tolist())
    for s in range(B):
        for j in range(-(-int(pos[s] + lengths[s]) // page)):
            table[s, j] = next(free)
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)

    def step(r):
        st = tree_map(torch.clone, state)
        args = [torch.from_numpy(a[r]).to(cuda)
                for a in (tokens, pos, lengths, table)]
        with torch.inference_mode():
            logits, st = api.prefill_step(params, st, *args)
        return logits, st

    full, full_state = step(list(range(B)))
    some, some_state = step(rows)
    torch.testing.assert_close(some.float(), full[rows].float(),
                               rtol=2e-2, atol=2e-2)
    for got, want in zip(tree_leaves(some_state), tree_leaves(full_state)):
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2e-2, atol=2e-2)


def test_choose_batch_measures_drains_on_the_card_then_hits(cuda, tmp_path):
    """``serve.decode_batch`` under the measure engine on a 2-layer cut of
    qwen1.5-4b at full width (bf16, on the card): the pick is one of the
    shortlisted slot counts, each timed by CUDA events around a real
    drain, and a second call hits the cache and drains nothing."""

    from repro_torch.runtime.tunables import choose_batch
    cfg = get_config("qwen1.5-4b").replace(n_layers=2)
    api = build_model(cfg)
    params = api.init(0, device=cuda)
    cache = TuningCache(tmp_path / "batch.json")
    kw = dict(context=128, requests=4, max_new=4, params=params,
              cache=cache, engine="measure", top_k=3, repeats=1)
    batch, res = choose_batch(api, **kw)
    assert res.stats["provenance"] == "measured"
    shortlist = [c["config"]["batch"] for c in res.stats["candidates"]]
    assert batch in shortlist and len(shortlist) == 3
    assert all(c["measured"] > 0 for c in res.stats["candidates"])
    again, res2 = choose_batch(api, **kw)
    assert again == batch and res2.stats["cache"] == "hit"


def test_phase_profiler_syncs_the_device_of_a_cuda_tensor(cuda,
                                                          monkeypatch):
    """The profiler waits for every CUDA device among a phase's tensors
    (nested dicts, lists and tuples) and for nothing else."""

    from repro_torch.obs import PhaseProfiler
    from repro_torch.obs.profile import sync_devices

    synced = []
    real = torch.cuda.synchronize

    def spy(device=None):
        synced.append(torch.device(device))
        real(device)

    monkeypatch.setattr(torch.cuda, "synchronize", spy)
    x = torch.ones(1 << 20, device=cuda)
    sync_devices({"a": [x, (torch.zeros(2),)], "b": {"c": x * 2}})
    assert synced == [cuda]
    prof = PhaseProfiler(warmup_ticks=0)
    prof.tick_begin()
    t0 = prof.phase_begin()
    y = x @ x
    prof.phase_end("decode", t0, sync={"out": y})
    prof.tick_end()
    assert synced == [cuda, cuda]
    assert prof.report()["decode"]["count"] == 1.0


def test_attention_ranges_lie_inside_their_synchronised_phase(cuda):
    """A profiled paged drain of a 2-layer cut of qwen1.5-4b at full width
    (bf16, on the card) times each layer's ``attn.kv`` and ``attn.core``
    by CUDA events on the stream: once a layer and step, and together
    within the phase's synchronised time."""

    from repro_torch.obs import Observability

    cfg = get_config("qwen1.5-4b").replace(n_layers=2)
    api = build_model(cfg)
    params = api.init(0, device=cuda)
    obs = Observability(trace=False, metrics=False, profile=True,
                        profile_warmup_ticks=0)
    srv = Server(api, params, batch=4, context=256, prefill_chunk=32,
                 paged=True, page_size=16, kv_pages=64, obs=obs)
    g = torch.Generator().manual_seed(0)
    for n in (40, 90, 17, 130, 64):
        srv.submit(torch.randint(1, cfg.vocab, (n,), generator=g).tolist(),
                   8)
    with torch.inference_mode():
        srv.run_until_drained()
    rep = obs.profiler.report()
    for phase in ("decode", "prefill"):
        entry = rep[phase]
        kv, core = entry["ranges"]["attn.kv"], entry["ranges"]["attn.core"]
        assert kv["count"] == core["count"] == 2 * entry["count"]
        assert 0 < kv["total_us"] + core["total_us"] <= entry["total_us"]


def test_dispatch_probe_times_the_host_clock(cuda, monkeypatch):
    """Each dispatch sample is host time from the launch to the end of
    ``torch.cuda.synchronize``: no CUDA event is recorded, and every
    sample covers at least one synchronize."""

    from repro_torch.calibrate.probes import dispatch_latency_sweep

    def no_events(*a, **k):
        raise AssertionError("the dispatch probe must not time with events")

    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "Event", no_events)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: (syncs.append(d), real(d)))
    samples = dispatch_latency_sweep(9, warmup=2)
    assert len(samples) == 9 and len(syncs) == 10
    assert all(1.0 < s < 10_000.0 for s in samples)


def test_triad_probe_launches_one_kernel(cuda):
    """The triad is one kernel a call (eager ``x + 1.5 * y`` is two)."""

    from torch.profiler import ProfilerActivity, profile
    n = 1 << 22
    x = torch.ones(n, device=cuda)
    y = torch.ones(n, device=cuda)
    z = torch.empty_like(x)
    torch.add(x, y, alpha=1.5, out=z)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.add(x, y, alpha=1.5, out=z)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert torch.equal(z, torch.full_like(z, 2.5))


def test_fleet_rollout_on_the_card(cuda, tmp_path, capsys):
    """Warm a plan on the card through ``python -m repro_torch.tune``'s
    ``main`` (measure and grid jobs), export the ``cuda`` entries, merge
    them into a fresh node cache, and resolve ``@autotune`` there: every
    lookup a hit, no miss, the output equal to the plain version."""

    import json

    from repro_torch.tune.cli import main as tune_cli

    n = 2**22
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"name": "card", "jobs": [
        {"tunable": "kernels.tuned_reduction", "params": {"n": n},
         "engine": "measure", "engine_kwargs": {"top_k": 2, "repeats": 1}},
        {"tunable": "kernels.tuned_reduction", "params": {"n": n},
         "engine": "grid"}]}))
    warm, node = str(tmp_path / "warm.json"), str(tmp_path / "node.json")
    art = str(tmp_path / "artifact.json")
    before = reduce_kernel.launches
    assert tune_cli(["--cache", warm, "warmup", str(plan), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["counts"]["tuned"] == 2
    assert reduce_kernel.launches > before          # measured on the card
    assert tune_cli(["--cache", warm, "export", art,
                     "--platform", "cuda"]) == 0
    assert "exported 2 entries (1 platform(s)) ->" in \
        capsys.readouterr().out
    assert tune_cli(["--cache", node, "merge", art]) == 0
    assert "2 added, 0 replaced, 0 kept" in capsys.readouterr().out
    assert tune_cli(["--cache", node, "ls", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    name = torch.cuda.get_device_name(0)
    assert {r["platform"] for r in rows} == {f"cuda/{name}"}
    assert all(r["origin"] for r in rows)

    node_cache = TuningCache(node)
    prev = set_default_cache(node_cache)
    try:
        x = _data(torch.int32, n, cuda)
        assert int(reduce_1d(x, op="min")) == int(x.min())
        assert reduce_1d.tune(x, op="min").stats["cache"] == "hit"
        assert node_cache.misses == 0 and node_cache.hits == 2
    finally:
        set_default_cache(prev)


def _max_err_share(got, want, bound, frac=1e-3):
    """Every leaf within ``bound``; at most ``frac`` of all elements
    beyond 1e-5 absolute + 1e-4 relative (an Adam step of a gradient
    within a few eps of 0 moves by ~lr, whatever its rounding)."""

    n_out = n = 0
    for k in sorted(want):
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _max_err_share(g, w, bound, frac)
            continue
        g, w = g.detach().cpu().float(), w.detach().cpu().float()
        err = (g - w).abs()
        assert float(err.max()) <= bound, k
        n += err.numel()
        n_out += int((err > 1e-5 + 1e-4 * w.abs()).sum())
    assert n_out <= max(1, frac * n)


def test_train_step_on_the_card_equals_the_cpu_step(cuda):
    """The reduced smollm in f32: one ``build_train_step`` step on the
    card (cuBLAS products, TF32 off) against the plain CPU step from the
    same state and batch.  The state it was given is left untouched."""

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import (TrainConfig, build_train_step,
                                     init_train_state)
    cfg = get_config("smollm-135m").reduced().replace(
        logits_dtype="float32")
    api = build_model(cfg)
    t = TrainConfig(lr=3e-3, warmup=2, total_steps=10, microbatches=2)
    host = init_train_state(api, 0, t, device="cpu")
    host = host._replace(params=tree_map(lambda p: p.float(), host.params))
    card = type(host)(tree_map(lambda p: p.to(cuda), host.params),
                      type(host.opt)(host.opt.step.to(cuda),
                                     tree_map(lambda p: p.to(cuda),
                                              host.opt.m),
                                     tree_map(lambda p: p.to(cuda),
                                              host.opt.v)), None)
    shape = ShapeSpec("t", 64, 4, "train")
    batch = SyntheticLM(cfg, shape, device="cpu").batch(0)
    step = build_train_step(api, t)
    before = tree_map(lambda p: p.clone(), card.params)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, gm = step(card, SyntheticLM(cfg, shape, device=cuda).batch(0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want, wm = step(host, batch)
    torch.testing.assert_close(gm["loss"].cpu(), wm["loss"], rtol=1e-4,
                               atol=0)
    _max_err_share(got.params, want.params, 4 * float(wm["lr"]))
    _max_err_share(card.params, before, 0.0, 0.0)
    assert int(got.opt.step) == 1 and got.opt.step.device.type == "cuda"


def test_flash_backward_raises_on_the_card(cuda):
    """The kernel has no backward: a loss through it launches the kernel
    once and raises on ``backward`` instead of training with a detached
    output."""

    q, k, v = (t.requires_grad_() for t in
               _qkv((1, 9, 2048, 64), torch.bfloat16, cuda, 3))
    before = flash_kernel.launches
    o = flash_attention(q, k, v, causal=True, block_q=128, block_k=64)
    assert flash_kernel.launches == before + 1 and o.requires_grad
    with pytest.raises(RuntimeError, match="no backward"):
        o.float().sum().backward()
    with torch.no_grad():
        o2 = flash_attention(q, k, v, causal=True, block_q=128, block_k=64)
    assert torch.equal(o.detach(), o2)
