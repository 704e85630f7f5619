"""The port's tiled matmul against the JAX package's.

``repro``'s ``matmul_tuned(..., bm=bn=bk=128)`` (the Pallas kernel in
interpret mode) against ``repro_torch``'s ``matmul_tuned`` on CPU
tensors (the plain version: f32 product cast to the inputs' dtype), at
the shapes and tolerances of the JAX package's own kernel tests; and the
parts of the port's kernel module that run without a card: the bf16
(wgmma) and f32 lattices, their shared-memory sizes, the cost model, the
operand checks the wrapper makes before any launch, and the build's
source hash.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul_tuned.ops import matmul_tuned as jax_matmul_tuned  # noqa: E402
from repro_torch.interop import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul_tuned.kernel import (  # noqa: E402
    BF16_STAGES, F32_SMEM_PAIR, TILES, f32_stages)
from repro_torch.kernels.matmul_tuned.ops import (MatmulTunable,  # noqa: E402
                                                  matmul_tuned, smem_bytes,
                                                  tuning_space)
from repro_torch.tune import TuningCache, set_default_cache, tune  # noqa: E402

SHAPES = [(128, 128, 128), (256, 384, 512), (512, 128, 256)]
# every shape a bf16 product takes in the tests on the card and in
# chip_smoke.py (its plan and phase 3c): each must have a tile
GPU_SHAPES = [(256, 384, 512), (256, 512, 64), (384, 512, 192),
              (2048, 1536, 4096), (8192, 8192, 8192), (8192, 8192, 1024)]
SMEM_LIMIT = 227 * 1024


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


# f32: the FMA kernel's 2 x 2 x 2 tiles; bf16: the wgmma kernel's bn in
# {128, 256} (bm = 128, bk = 64), both dividing N = 512
@pytest.mark.parametrize("dtype,shape,tiles", [
    (jnp.float32, (256, 384, 512), 8),
    (jnp.bfloat16, (256, 512, 512), 2)])
def test_every_tile_of_the_lattice_gives_the_same_product(dtype, shape,
                                                          tiles):
    a, b = _operands(shape, dtype)
    ta = from_numpy(np.asarray(a), "cpu")
    tb = from_numpy(np.asarray(b), "cpu")
    space = tuning_space(*shape, dtype_bytes=ta.element_size())
    outs = [matmul_tuned(ta, tb, **cfg) for cfg in space]
    assert len(outs) == tiles
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
    # bf16 compiles bm = 128 and bk = 64 only
    a16 = torch.ones(128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not compiled"):
        matmul_tuned(a16, a16, bm=64, bn=128, bk=64)
    with pytest.raises(ValueError, match="not compiled"):
        matmul_tuned(a16, a16, bm=128, bn=128, bk=32)
    with pytest.raises(ValueError, match="no compiled tile for bm"):
        tuning_space(64, 128, 64, dtype_bytes=2)
    with pytest.raises(ValueError, match="no compiled tile for bk"):
        tuning_space(128, 128, 96, dtype_bytes=2)


# bf16: the 4-stage 128 x 256 x 64 tile (it fills the SMs in 16 waves of
# twice the work of the 128 x 128 tile's 32); f32: the largest FMA tile
@pytest.mark.parametrize("dtype_bytes,pick", [
    (2, {"bm": 128, "bn": 256, "bk": 64}),
    (4, {"bm": 128, "bn": 128, "bk": 64})])
def test_cost_model_prefers_large_tiles_on_the_h100(dtype_bytes, pick):
    res = tune(MatmulTunable(8192, 8192, 8192, dtype_bytes=dtype_bytes),
               engine="grid", cache=None)
    assert res.best_config == pick
    # the f32 product is priced at the FMA rate, well above the bf16 one
    both = {"bm": 128, "bn": 128, "bk": 64}
    assert MatmulTunable(8192, 8192, 8192, dtype_bytes=4).cost(both) > \
        MatmulTunable(8192, 8192, 8192).cost(both)


@pytest.mark.parametrize("shape", SHAPES + GPU_SHAPES)
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_lattice_has_a_tile_for_every_shape_and_each_fits(shape,
                                                          dtype_bytes):
    space = list(tuning_space(*shape, dtype_bytes=dtype_bytes))
    assert space
    for cfg in space:
        assert all(v in TILES[dtype_bytes][k] for k, v in cfg.items())
        assert smem_bytes(cfg, dtype_bytes) <= SMEM_LIMIT


def test_bf16_smem_mirrors_the_ring():
    """1024 bytes of alignment slack, the stages of (128 x 64) A and
    (64 x bn) B bf16 tiles, two 8-byte barriers per stage; each stage a
    multiple of the 1024-byte swizzle atom."""

    for bn, stages in BF16_STAGES.items():
        cfg = {"bm": 128, "bn": bn, "bk": 64}
        stage = (128 * 64 + 64 * bn) * 2
        assert stage % 1024 == 0
        assert smem_bytes(cfg, 2) == 1024 + stages * stage + 16 * stages
        # the deepest ring that fits: one more stage would not
        assert smem_bytes(cfg, 2) + stage + 16 > SMEM_LIMIT
    assert smem_bytes({"bm": 128, "bn": 256, "bk": 64}, 2) == 197696


def test_f32_smem_mirrors_the_ring():
    """A stage is A (bm x bk, rows padded by 4 floats) and B (bk x bn) in
    f32; the ring is the deepest that lets two blocks share an SM, and
    never shallower than 2."""

    space = list(tuning_space(4096, 4096, 4096, dtype_bytes=4))
    assert len(space) == 8
    for cfg in space:
        bm, bn, bk = cfg["bm"], cfg["bn"], cfg["bk"]
        stage = (bm * (bk + 4) + bk * bn) * 4
        stages = f32_stages(bm, bn, bk)
        assert stage % 16 == 0
        assert smem_bytes(cfg, 4) == stages * stage <= SMEM_LIMIT
        assert stages >= 2
        if stages > 2:
            assert smem_bytes(cfg, 4) <= F32_SMEM_PAIR
        assert smem_bytes(cfg, 4) + stage > F32_SMEM_PAIR
    assert [f32_stages(128, 128, 32), f32_stages(128, 128, 64),
            f32_stages(64, 64, 32)] == [3, 2, 6]


def test_f32_cost_model_pick_at_4096_cubed():
    """The fitted per-step cost keeps the pick on the 128 x 128 tiles, the
    fastest on the card at 4096^3 (within 1.3 % of each other), and
    prices the product above the 2.05 ms of its flops at 67 TFLOP/s."""

    t = MatmulTunable(4096, 4096, 4096, dtype_bytes=4)
    best = tune(t, engine="grid", cache=None).best_config
    assert (best["bm"], best["bn"]) == (128, 128)
    assert t.cost(best) > 2 * 4096 ** 3 / 67e12 * 1e6


def _bf16(*shape):
    return torch.ones(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_operands_tma_cannot_take_raise(dtype):
    """Checked before the device is looked at, so they raise on the CPU
    as on the card."""

    ones = lambda *s: torch.ones(*s, dtype=dtype)
    tile = {"bm": 128, "bn": 128, "bk": 64}
    b = ones(128, 128)
    # non-contiguous: a transposed view, a column slice with padded rows
    with pytest.raises(ValueError, match="not contiguous"):
        matmul_tuned(ones(128, 128).t(), b, **tile)
    with pytest.raises(ValueError, match="not contiguous"):
        matmul_tuned(ones(128, 192)[:, :128], b, **tile)
    with pytest.raises(ValueError, match="not contiguous"):
        matmul_tuned(ones(128, 128), ones(128, 256)[:, ::2], **tile)
    # a row stride that is not a multiple of 16 bytes (K = 66)
    with pytest.raises(ValueError, match="row stride"):
        matmul_tuned(ones(128, 66), ones(66, 128), **tile)
    # a base that is not 16-byte aligned
    flat = torch.ones(128 * 128 + 1, dtype=dtype)
    with pytest.raises(ValueError, match="16-byte aligned"):
        matmul_tuned(flat[1:].view(128, 128), b, **tile)
    # what passes the checks runs
    got = matmul_tuned(ones(128, 128), b, **tile)
    assert got.shape == (128, 128) and bool((got == 128).all())


def test_source_hash_digests_headers(tmp_path):
    """An edit to a header under csrc/ must not reuse a stale library."""

    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "sm90.cuh").is_file()
    before = _build.source_hash(tmp_path)
    assert before == _build.source_hash()
    header = tmp_path / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    edited = _build.source_hash(tmp_path)
    assert edited != before
    cu = tmp_path / "matmul_tuned.cu"
    cu.write_bytes(cu.read_bytes() + b"\n")
    assert _build.source_hash(tmp_path) not in (before, edited)


def test_ptxas_usage_reads_registers_and_spills():
    log = [
        "ptxas info    : Compiling entry function '_ZN2wg7mm_bf16ILi256EEEv' "
        "for 'sm_90a'",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z6mm_f32ILi64EEv' for "
        "'sm_90a'",
        "8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 255 registers, 384 bytes cmem[0]"]
    usage = _build.ptxas_usage(log)
    assert usage == {
        "_ZN2wg7mm_bf16ILi256EEEv": {"registers": 168, "spill_stores": 0,
                                     "spill_loads": 0},
        "_Z6mm_f32ILi64EEv": {"registers": 255, "spill_stores": 12,
                              "spill_loads": 16}}
