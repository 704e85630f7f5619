"""The port's flash attention against the JAX package's.

``repro``'s ``flash_attention`` (the Pallas kernel in interpret mode, as
the JAX package's own tests run it) and ``attention_ref`` against
``repro_torch``'s ``flash_attention`` on CPU tensors (the plain version),
with the cases and tolerances of the JAX package's kernel tests.  Inputs
are made with numpy from a seed and fed to both.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    SMEM_LIMIT, SMEM_PAIR, TILES, bf16_stages, f32_blocks_per_sm,
    flash_kernel)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FlashAttentionTunable, attention_ref, flash_attention, k_blocks,
    smem_bytes, threads, tuning_space, visible_pairs, visited_blocks)
from repro_torch.tune import (TuningCache, available_tunables,  # noqa: E402
                              set_default_cache, tune)


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(shape), dtype) for _ in range(3)]


def _port(*arrays):
    return [from_numpy(np.asarray(a), "cpu") for a in arrays]


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-5),
                                       (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_matches_jax(dtype, tol, causal, D):
    q, k, v = _qkv((2, 2, 256, D), dtype, seed=11)
    want = np.asarray(jax_flash_attention(q, k, v, causal=causal,
                                          block_q=128, block_k=128),
                      np.float32)
    ref = np.asarray(jax_attention_ref(q, k, v, causal=causal), np.float32)
    tq, tk, tv = _port(q, k, v)
    got = flash_attention(tq, tk, tv, causal=causal, block_q=128,
                          block_k=128)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for other in (want, ref):
        np.testing.assert_allclose(to_numpy(got), other, rtol=tol,
                                   atol=tol * 10)


@pytest.mark.parametrize("window", [32, 100, 256])
def test_flash_sliding_window_matches_jax(window):
    q, k, v = _qkv((1, 2, 256, 64), jnp.float32, seed=13)
    want = np.asarray(jax_flash_attention(q, k, v, causal=True,
                                          window=window, block_q=64,
                                          block_k=64))
    got = flash_attention(*_port(q, k, v), causal=True, window=window,
                          block_q=64, block_k=64)
    np.testing.assert_allclose(to_numpy(got), want, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(
        to_numpy(got), np.asarray(jax_attention_ref(q, k, v, causal=True,
                                                    window=window)),
        rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128),
                                   (256, 256)])
def test_flash_block_invariance_matches_jax(bq, bk):
    q, k, v = _qkv((1, 1, 256, 64), jnp.float32, seed=5)
    want = np.asarray(jax_flash_attention(q, k, v, causal=True, block_q=bq,
                                          block_k=bk))
    got = flash_attention(*_port(q, k, v), causal=True, block_q=bq,
                          block_k=bk)
    np.testing.assert_allclose(to_numpy(got), want, rtol=2e-5, atol=2e-4)


def test_a_row_with_no_visible_key_is_zero():
    q, k, v = _qkv((1, 2, 128, 64), jnp.float32, seed=2)
    want = np.asarray(jax_attention_ref(q, k, v, causal=True, window=0))
    got = to_numpy(flash_attention(*_port(q, k, v), causal=True, window=0,
                                   block_q=64, block_k=64))
    assert not np.any(got) and not np.any(want)
    assert not np.any(np.isnan(got))


def test_wrapper_validates_before_dispatch():
    q = torch.zeros(1, 2, 96, 64)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(TypeError):
        flash_kernel(q[0].double(), q[0].double(), q[0].double(),
                     block_q=32, block_k=32)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=-1, block_q=32, block_k=32)


def test_tuning_space_fits_a_hopper_block_and_no_tpu_constant():
    for dtype_bytes in (2, 4):
        for D in (64, 128):
            space = list(tuning_space(4096, D, dtype_bytes))
            assert space
            for cfg in space:
                assert cfg["block_q"] in TILES[dtype_bytes]["block_q"]
                assert cfg["block_k"] in TILES[dtype_bytes]["block_k"]
                assert smem_bytes(cfg, D, dtype_bytes) <= 227 * 1024
                assert threads(cfg, dtype_bytes) <= 1024
    # the bf16 lattice is block_q = 128 x block_k in {64, 128}
    assert {(c["block_q"], c["block_k"]) for c in tuning_space(4096, 128)} \
        == {(128, 64), (128, 128)}
    # tiles must divide S: S = 96 admits block 32 only for block_k (f32);
    # bf16 has no tile for S = 64 * 3
    with pytest.raises(ValueError, match="block_q"):
        tuning_space(96, 64, dtype_bytes=4)
    with pytest.raises(ValueError, match="block_q"):
        tuning_space(192, 128)
    # the reference's TPU numbers (64 MiB VMEM, 197 TFLOP/s, 819 GB/s)
    # are not the port's
    src = inspect.getsource(ops)
    for tpu in ("197", "819", "2**20", "vmem", "VMEM"):
        assert tpu not in src, tpu


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bk", [64, 128])
def test_every_bf16_tile_fits_a_block_at_its_ring_depth(bk, D):
    """1024 bytes of alignment slack, the (128, D) Q tile, the stages of
    (bk, D) K and V tiles and 8-byte barriers (Q's, and a full and an
    empty one per stage) fit 232,448 bytes; one more stage would not.
    Every tile is a multiple of the 1024-byte swizzle atom."""

    cfg = {"block_q": 128, "block_k": bk}
    stages = bf16_stages(bk, D)
    stage = 2 * bk * D * 2
    assert stage % 1024 == 0 and 128 * D * 2 % 1024 == 0
    assert stages >= 3
    assert smem_bytes(cfg, D, 2) == \
        1024 + 128 * D * 2 + stages * stage + (1 + 2 * stages) * 8
    assert smem_bytes(cfg, D, 2) <= SMEM_LIMIT == 232448
    assert smem_bytes(cfg, D, 2) + stage + 16 > SMEM_LIMIT
    assert threads(cfg, 2) == 288


def test_bf16_ring_depths():
    # qwen1.5-4b's tile: 32 KB of Q + 3 x 64 KB of K/V, about 230.5 KB
    assert bf16_stages(128, 128) == 3
    assert smem_bytes({"block_q": 128, "block_k": 128}, 128, 2) == 230456
    assert {(bk, D): bf16_stages(bk, D) for bk in (64, 128)
            for D in (64, 128)} == {(64, 64): 13, (64, 128): 6,
                                    (128, 64): 6, (128, 128): 3}


@pytest.mark.parametrize("S,bq,bk", [(256, 64, 64), (512, 128, 64),
                                     (512, 128, 128), (384, 128, 64)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 1), (True, 70),
                                           (True, 0), (False, 0),
                                           (False, 100)])
def test_k_blocks_are_exactly_the_blocks_with_a_visible_pair(S, bq, bk,
                                                             causal, window):
    """The kernel's k-loop range (first block and count, from the mask)
    against a brute-force search of the blocks holding a visible pair."""

    qi = np.arange(S)[:, None]
    ki = np.arange(S)[None, :]
    vis = np.ones((S, S), bool)
    if causal:
        vis &= ki <= qi
    if window is not None:
        vis &= ki >= qi - window + 1
    for q_lo in range(0, S, bq):
        rows = vis[q_lo:q_lo + bq]
        want = [kb for kb in range(S // bk)
                if rows[:, kb * bk:(kb + 1) * bk].any()]
        first, count = k_blocks(q_lo, q_lo + bq - 1, S, bk, causal, window)
        assert list(range(first, first + count)) == want, (q_lo, first,
                                                           count)


def test_cost_model_counts_the_visited_blocks():
    # causal: the diagonal and below; window: a band; a causal window of 0
    # leaves no row a key, so no block is visited
    assert visited_blocks(256, 64, 64) == 10
    assert visited_blocks(256, 64, 64, causal=False) == 16
    assert visited_blocks(256, 64, 64, window=64) == 7
    assert visited_blocks(256, 64, 64, window=0) == 0
    assert visible_pairs(4, causal=True) == 10
    assert visible_pairs(4, causal=True, window=2) == 7
    t = FlashAttentionTunable(S=4096, D=128, BH=20)
    costs = {tuple(c.values()): t.cost(c) for c in t.space()}
    assert all(c > 0 for c in costs.values())
    # bf16: the causal model shape costs about half the non-causal one,
    # and so does a window of 1024 (9 k-blocks a q-block, against 16.5 on
    # average under the causal mask alone)
    cfg = {"block_q": 128, "block_k": 128}
    full = FlashAttentionTunable(S=4096, D=128, BH=20, causal=False)
    band = FlashAttentionTunable(S=4096, D=128, BH=20, window=1024)
    assert 0.4 < t.cost(cfg) / full.cost(cfg) < 0.6
    assert 0.4 < band.cost(cfg) / t.cost(cfg) < 0.6
    # the causal work at qwen1.5-4b's shape, 4 * BH * S^2/2 * D ~ 86 GFLOP
    assert 4 * 20 * visible_pairs(4096) * 128 == pytest.approx(85.92e9,
                                                               rel=1e-3)


@pytest.mark.parametrize("D", [64, 128])
def test_f32_tiles_fit_a_block_with_their_two_stage_ring(D):
    """The f32 kernel's block: Q (block_q x D), two stages of K and V
    (block_k x D each) and P (block_q x block_k), all f32; 16 threads per
    8 query rows.  Every tile of the lattice fits at both head dims."""

    space = list(tuning_space(4096, D, dtype_bytes=4))
    assert {(c["block_q"], c["block_k"]) for c in space} == \
        {(64, 32), (64, 64), (128, 32), (128, 64)}
    for cfg in space:
        bq, bk = cfg["block_q"], cfg["block_k"]
        assert smem_bytes(cfg, D, 4) == 4 * (bq * D + 2 * 2 * bk * D +
                                             bq * bk)
        assert smem_bytes(cfg, D, 4) <= SMEM_LIMIT
        assert threads(cfg, 4) == 16 * bq // 8
    # the widest tile nearly fills a block at D = 128
    assert smem_bytes({"block_q": 128, "block_k": 64}, 128, 4) == 229376


def test_f32_blocks_share_an_sm_only_where_both_fit():
    """256-thread blocks (block_q = 128) take 160-224 registers a thread
    and have an SM to themselves; two 128-thread blocks share one where
    both their shared memories fit."""

    assert f32_blocks_per_sm(128, 32, 64) == 1
    assert f32_blocks_per_sm(64, 32, 64) == 2
    assert f32_blocks_per_sm(64, 64, 64) == 2
    assert f32_blocks_per_sm(64, 32, 128) == 2
    assert f32_blocks_per_sm(64, 64, 128) == 1       # 180224 bytes
    for D in (64, 128):
        for bk in (32, 64):
            cfg = {"block_q": 64, "block_k": bk}
            assert (f32_blocks_per_sm(64, bk, D) == 2) == \
                (smem_bytes(cfg, D, 4) <= SMEM_PAIR)


def test_f32_cost_model_picks_the_widest_tile_at_the_model_shape():
    """At qwen1.5-4b's (1, 20, 4096, 128) the (128, 64) tile was the
    fastest on the card under both masks; the fitted model agrees, and
    prices the causal call at about half the non-causal one."""

    for causal in (True, False):
        t = FlashAttentionTunable(S=4096, D=128, BH=20, causal=causal,
                                  dtype_bytes=4)
        assert tune(t, engine="grid", cache=None).best_config == \
            {"block_q": 128, "block_k": 64}
    cfg = {"block_q": 128, "block_k": 64}
    ratio = FlashAttentionTunable(S=4096, D=128, BH=20, dtype_bytes=4).cost(
        cfg) / FlashAttentionTunable(S=4096, D=128, BH=20, causal=False,
                                     dtype_bytes=4).cost(cfg)
    assert 0.45 < ratio < 0.6


def test_registered_in_the_plan():
    assert "kernels.flash_attention" in available_tunables()


def test_autotune_resolves_on_cpu_then_hits():
    q, k, v = _port(*_qkv((1, 2, 256, 64), jnp.float32, seed=3))
    got = flash_attention(q, k, v, causal=True)          # blocks omitted
    decision = flash_attention.tune(q, k, v, causal=True)
    assert decision.stats["cache"] == "hit"
    assert set(decision.best_config) == {"block_q", "block_k"}
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_measure_engine_on_cpu_then_hit():
    t = FlashAttentionTunable(S=128, D=64, BH=2, dtype_bytes=4,
                              device="cpu")
    first = tune(t, engine="measure", top_k=2, repeats=1)
    assert first.stats["provenance"] == "measured"
    assert tune(t, engine="measure", top_k=2,
                repeats=1).stats["cache"] == "hit"
