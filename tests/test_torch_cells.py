"""The port's dry-run cells and roofline against the JAX package's:
``collective_bytes`` on the reference's sample HLO; each arch × shape's
skip status and reason; ``param_count``; ``auto_microbatches`` at 16 and
32 data ranks; ``model_flops`` and ``analyze`` on the reference's
synthetic record under one spec.  Then, in a subprocess with a fake
(2, 4) process group: smollm-135m ``train_4k`` (two of its 30 layers) runs
``ok`` with collectives, as the reference's multi-device cell does; a tiny dense
model's per-device matmul FLOPs equal the count reckoned by hand below;
and its module FLOPs equal its non-block FLOPs plus trips × its block's,
which the port's ``analyze`` does not compose a second time."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.calibrate.spec import PlatformSpec as JaxPlatformSpec  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import cells as JC  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro_torch.calibrate.spec import DEFAULT_SPEC  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, supports  # noqa: E402
from repro_torch.launch import cells as C  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

SAMPLE_HLO = """
  %ar = f32[16000,4096]{1,0} all-reduce(%x), replica_groups={}
  %ag.1 = bf16[256,1024]{1,0} all-gather(%y), dimensions={0}
  %rs = (f32[128]{0}, f32[128]{0}) reduce-scatter(%a, %b), dimensions={0}
  %cp = u32[64]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %a2a = s8[32,32]{1,0} all-to-all(%w), dimensions={1}
  %ar2 = f32[10]{0} all-reduce-start(%q), replica_groups={}
  %not_a_collective = f32[5]{0} add(%p, %q)
"""

RECORD = {
    "arch": "smollm-135m", "shape": "train_4k", "mesh": "16x16",
    "status": "ok", "n_devices": 256,
    "cost": {"flops": 1e12, "bytes_accessed": 1e9},
    "collectives": {"total_bytes": 4e9},
    "memory": {"peak_hbm_bytes": 2 ** 30},
    "block": {"status": "ok", "settings": {"trips": 30},
              "cost": {"flops": 5e11, "bytes_accessed": 1e8},
              "collectives": {"total_bytes": 3e9}},
}


def test_collective_bytes_matches_the_reference():
    got = C.collective_bytes(SAMPLE_HLO)
    assert got == JC.collective_bytes(SAMPLE_HLO)
    assert got["all-reduce"] == {"count": 2,
                                 "bytes": 16000 * 4096 * 4 + 10 * 4}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cell_skips_and_settings_match_the_reference(arch, shape):
    ok, why = supports(get_config(arch), SHAPES[shape])
    if not ok:
        # both decide before building a mesh
        got = C.lower_cell(arch, shape)
        want = JC.lower_cell(arch, shape)
        assert (got.status, got.reason) == (want.status, want.reason) == \
            ("skipped", why)
        assert got.n_devices == want.n_devices == 0
    else:
        from repro.configs import SHAPES as JS
        from repro.configs import supports as jax_supports
        assert jax_supports(jax_get_config(arch), JS[shape]) == (True, "")
    if SHAPES[shape].kind == "train":
        for n_dp in (16, 32):
            assert C.auto_microbatches(get_config(arch), SHAPES[shape],
                                       n_dp) == \
                JC.auto_microbatches(jax_get_config(arch), JS_SHAPES()[shape],
                                     n_dp)


def JS_SHAPES():
    from repro.configs import SHAPES as JS
    return JS


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_and_model_flops_match_the_reference(arch):
    from repro.models import build_model as jax_build_model
    assert build_model(get_config(arch)).param_count() == \
        jax_build_model(jax_get_config(arch)).param_count()
    for shape in SHAPES:
        assert R.model_flops(arch, shape) == JR.model_flops(arch, shape)
    assert R.active_params(arch) == JR.active_params(arch)


def test_analyze_matches_the_reference_under_one_spec():
    jspec = JaxPlatformSpec(**{
        f.name: getattr(DEFAULT_SPEC, f.name)
        for f in dataclasses.fields(JaxPlatformSpec)
        if hasattr(DEFAULT_SPEC, f.name)})
    got = R.analyze(RECORD, spec=DEFAULT_SPEC)
    want = JR.analyze(RECORD, spec=jspec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hlo_flops_per_dev == pytest.approx(1e12 + 29 * 5e11)
    assert got.step_time_s == max(got.compute_s, got.memory_s,
                                  got.collective_s)
    assert R.what_moves_it(got) == JR.what_moves_it(want)
    # the H100 data sheet
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW, R.LINKS) == (
        989e12, 3.35e12, 25e9, 18)
    # a skipped record carries its reason
    skip = R.analyze({"arch": "a", "shape": "s", "mesh": "m",
                      "status": "skipped", "reason": "why"})
    assert skip.note == "why" and skip.compute_s == 0


def test_analyze_file(tmp_path):
    path = tmp_path / "r.json"
    path.write_text(json.dumps([RECORD]))
    [r] = R.analyze_file(str(path))
    assert r.hlo_flops_per_dev == pytest.approx(1e12 + 29 * 5e11)


FAKE = r"""
import json, sys
from repro_torch.configs import SHAPES
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.cells import lower_block_cell, lower_cell
from repro_torch.launch.mesh import fake_world, make_smoke_mesh

SHAPES["tiny"] = ShapeSpec("tiny", 16, 8, "prefill")
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=128, vocab=256)
out = {}
with fake_world(8):
    mesh = make_smoke_mesh((2, 4))
    # two of the 30 layers
    out["train"] = lower_cell("smollm-135m", "train_4k", mesh=mesh,
                              cfg_overrides={"n_layers": 2}).to_json()
    out["tiny"] = lower_cell("smollm-135m", "tiny", mesh=mesh,
                             cfg_overrides=TINY).to_json()
    out["tiny_block"] = lower_block_cell("smollm-135m", "tiny", mesh=mesh,
                                         cfg_overrides=TINY).to_json()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def fake_cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("cells") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", FAKE, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


def test_train_cell_on_a_fake_2x4_group(fake_cells):
    rec = fake_cells["train"]
    assert rec["status"] == "ok", rec["reason"]
    assert rec["n_devices"] == 8 and rec["mesh"] == "2x4"
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["peak_hbm_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["settings"]["counts"] == "all_trips"
    # the reference's rule: 16 data ranks for a single-pod cell
    assert rec["settings"]["microbatches"] == JC.auto_microbatches(
        jax_get_config("smollm-135m").replace(n_layers=2),
        JS_SHAPES()["train_4k"], 16)


def test_per_device_matmul_flops_equal_the_hand_count(fake_cells):
    # (2, 4) mesh: data 2, model 4.  B = 8 rows -> 4 a rank, S = 16, so
    # T = 64 tokens a rank; d = 64, H = Hkv = 4 heads of 16 -> 1 a rank
    # (16 columns of each projection), F = 128 -> 32 a rank, V = 256 ->
    # 64 rows of the tied table a rank.  A mm (m, k) @ (k, n) is 2·m·k·n.
    T, d, hd_loc, S, B_loc, F_loc, V_loc, L = 64, 64, 16, 16, 4, 32, 64, 2
    qkv = 3 * 2 * T * d * hd_loc            # x @ wq, wk, wv (local heads)
    scores = 2 * B_loc * S * S * hd_loc     # q @ k^T on one head
    pv = 2 * B_loc * S * S * hd_loc         # p @ v
    out_proj = 2 * T * hd_loc * d           # o @ wo -> a partial sum
    mlp = 3 * 2 * T * d * F_loc             # wg, wu, wd
    layer = qkv + scores + pv + out_proj + mlp
    logits = 2 * T * d * V_loc              # x @ embed^T (vocab-sharded)
    rec = fake_cells["tiny"]
    assert rec["status"] == "ok", rec["reason"]
    assert rec["cost"]["flops"] == L * layer + logits
    blk = fake_cells["tiny_block"]
    assert blk["status"] == "ok", blk["reason"]
    assert blk["cost"]["flops"] == layer and blk["settings"]["trips"] == L


def test_module_counts_cover_every_trip(fake_cells):
    rec = dict(fake_cells["tiny"], block=fake_cells["tiny_block"])
    blk = rec["block"]
    non_block = 2 * 64 * 64 * 64            # the logits, as above
    module = rec["cost"]["flops"]
    assert module == pytest.approx(
        non_block + blk["settings"]["trips"] * blk["cost"]["flops"],
        rel=0.01)
    rec["shape"] = "prefill_32k"      # a shape model_flops knows
    # analyze takes the port's module counts as they are ...
    assert R.analyze(rec).hlo_flops_per_dev == module
    # ... and composes an unmarked (reference) record
    ref = json.loads(json.dumps(rec))
    ref["settings"].pop("counts")
    assert R.analyze(ref).hlo_flops_per_dev == pytest.approx(
        module + (blk["settings"]["trips"] - 1) * blk["cost"]["flops"])


def _shapes(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of meta tensors (the port)
    or ShapeDtypeStructs (the reference); NamedTuples by field."""

    if tree is None:
        return {}
    if hasattr(tree, "shape") and not isinstance(tree, tuple):
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    items = (tree._asdict().items() if hasattr(tree, "_fields")
             else tree.items())
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dry_run_helpers_match_the_reference(arch):
    """``input_specs`` (train, prefill, decode with a (B,) ``cur_len``, a
    chunked prefill, paged), ``make_batch_specs``, ``abstract_train_state``
    and ``axes``: the reference's shapes, dtypes and logical axes, as meta
    tensors that allocate nothing."""

    from repro.data.pipeline import make_batch_specs as jax_batch_specs
    from repro.models import build_model as jax_build_model
    from repro.runtime.kv import PagedKVSpec as JaxPaged
    from repro.runtime.train import TrainConfig as JaxTrainConfig
    from repro.runtime.train import abstract_train_state as jax_abstract
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.runtime import TrainConfig, abstract_train_state
    from repro_torch.runtime.kv import PagedKVSpec

    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    api, japi = build_model(cfg), jax_build_model(jcfg)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape, jshape = SHAPES[name].reduced(), JS_SHAPES()[name].reduced()
        if SHAPES[name].kind != "decode":
            assert _shapes(api.input_specs(shape)) == \
                _shapes(japi.input_specs(jshape))
            assert _shapes(make_batch_specs(cfg, shape)) == \
                _shapes(jax_batch_specs(jcfg, jshape))
            continue
        got = api.input_specs(shape)
        assert got["cur_len"].shape == (shape.global_batch,)
        assert _shapes(got) == _shapes(japi.input_specs(jshape))
        assert _shapes(api.input_specs(shape, prefill_chunk=8)) == \
            _shapes(japi.input_specs(jshape, prefill_chunk=8))
        paged = dict(n_pages=6, page_size=8, pages_per_slot=4)
        assert _shapes(api.input_specs(shape, paged=PagedKVSpec(**paged))) == \
            _shapes(japi.input_specs(jshape, paged=JaxPaged(**paged)))
    for compress in (False, True):
        assert _shapes(abstract_train_state(
            api, TrainConfig(compress_pod_grads=compress))) == \
            _shapes(jax_abstract(japi, JaxTrainConfig(
                compress_pod_grads=compress)))
    assert api.axes() == japi.axes()
    assert all(t.device.type == "meta" for t in
               torch.utils._pytree.tree_leaves(api.abstract()))


HYMBA = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.cells import lower_cell
from repro_torch.launch.mesh import fake_world, make_smoke_mesh
from repro_torch.runtime import TrainConfig

one = TrainConfig(microbatches=1)
out = {}
# hymba cut to 6 SSM heads (d_model 48, headdim 16) on a (2, 4) group:
# the heads do not divide the 4-way model axis
base = get_config("hymba-1.5b").reduced()
cut = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)
       if f.name not in ("name", "source")}
cut.update(d_model=48, ssm=dataclasses.replace(base.ssm, headdim=16))
for kind in ("train", "prefill", "decode"):
    SHAPES["tiny_" + kind] = ShapeSpec("tiny_" + kind, 16, 4, kind)
with fake_world(8):
    mesh = make_smoke_mesh((2, 4))
    for kind in ("train", "prefill", "decode"):
        out["heads6_" + kind] = lower_cell(
            "hymba-1.5b", "tiny_" + kind, mesh=mesh, cfg_overrides=cut,
            tcfg=one).to_json()
# full width on the fake 16 x 16 group: 50 SSM heads on a 16-way axis
out["decode_32k"] = lower_cell("hymba-1.5b", "decode_32k").to_json()
out["train_4k"] = lower_cell("hymba-1.5b", "train_4k", tcfg=one,
                             cfg_overrides={"n_layers": 2}).to_json()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def hymba_cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("hymba") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", HYMBA, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("cell", ["decode_32k", "train_4k"])
def test_hymba_full_width_cells_on_a_fake_16x16_group(hymba_cells, cell):
    """50 SSM heads on a 16-way model axis: the head split and merge
    leave the channels whole on it (train_4k at 2 of 32 layers)."""

    rec = hymba_cells[cell]
    assert rec["status"] == "ok", rec["reason"]
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_uneven_ssm_heads_on_a_fake_2x4_group(hymba_cells, kind):
    """hymba cut to 6 SSM heads, which a 4-way model axis does not
    divide, with the batch split 2 ways."""

    rec = hymba_cells["heads6_" + kind]
    assert rec["status"] == "ok", rec["reason"]
    assert rec["n_devices"] == 8 and rec["cost"]["flops"] > 0


# ---------------------------------------------------------------------------
# the dry run's flash stand-in counts the pairs inside the mask
# ---------------------------------------------------------------------------


def _loop_pairs(S, causal, window):
    """(q, k) pairs inside the mask, row by row."""

    total = 0
    for qi in range(S):
        hi = qi if causal else S - 1
        lo = 0 if window is None else max(0, qi - window + 1)
        total += max(0, hi - lo + 1)
    return total


def _fake_flash_counts(shape, causal, window, grad=False):
    """(forward FLOPs, forward + backward FLOPs, forward bytes, forward +
    backward bytes) of one ``_flash`` call on fake (B, H, S, D) q, k, v
    under ``CountingMode``."""

    from repro_torch.models.attention import _flash
    mode = C.CountingMode()
    with mode:
        q, k, v = (torch.empty(shape, requires_grad=grad) for _ in range(3))
        g = torch.ones(shape)
    mode.counting = True
    try:
        with mode:
            out = _flash(q, k, v, causal=causal, window=window)
            fwd, fwd_bytes = mode.flops, mode.bytes
            assert tuple(out.shape) == shape
            if grad:
                out.backward(g)
    finally:
        mode.counting = False
    return fwd, mode.flops, fwd_bytes, mode.bytes


# (causal, window, pairs counted by hand at S = 256): rows 0-63 of the
# window see qi + 1 keys (64·65/2) and rows 64-255 see 64 (192·64); the
# causal mask S·(S+1)/2; no mask S²
FAKE_FLASH_CASES = {"windowed": (True, 64, 2080 + 12288),
                    "causal": (True, None, 256 * 257 // 2),
                    "unmasked": (False, None, 256 * 256)}


@pytest.mark.parametrize("case", sorted(FAKE_FLASH_CASES))
def test_fake_flash_counts_the_pairs_inside_the_mask(case):
    from torch.utils.flop_counter import sdpa_flop_count
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    causal, window, pairs = FAKE_FLASH_CASES[case]
    B, H, S, D = shape = (2, 3, 256, 16)
    assert visible_pairs(S, causal, window) == _loop_pairs(S, causal,
                                                           window) == pairs
    flops, _, nbytes, _ = _fake_flash_counts(shape, causal, window)
    assert flops == 4 * B * H * D * pairs
    # q, k, v read and the output written, O(S·D)
    assert nbytes == 4 * B * H * S * D * 4
    if case == "unmasked":
        assert flops == sdpa_flop_count(shape, shape, shape)


def test_fake_flash_backward_counts_five_products_over_the_pairs():
    B, H, S, D = shape = (1, 2, 256, 16)
    fwd, total, fwd_bytes, total_bytes = _fake_flash_counts(
        shape, True, 64, grad=True)
    pairs = 2080 + 12288
    assert fwd == 4 * B * H * D * pairs
    # the backward's products over the same pairs, as torch's SDPA
    # backward formula counts them over S² (its elementwise ops add none)
    assert total == fwd + 10 * B * H * D * pairs
    # bytes: the forward reads q, k, v and writes the output; the
    # backward reads the gradient, q, k, v and the output and writes dq,
    # dk, dv; autograd's device queries on the way move nothing
    one = B * H * S * D * 4
    assert fwd_bytes == 4 * one and total_bytes == 12 * one


def test_counting_mode_counts_no_bytes_for_a_metadata_query():
    mode = C.CountingMode()
    with mode:
        x = torch.empty(64, 64)
    mode.counting = True
    try:
        with mode:
            assert torch.ops.prim.device(x) == x.device
            y = x * 2
    finally:
        mode.counting = False
    assert mode.bytes == x.nbytes + y.nbytes and mode.flops == 0


@pytest.mark.parametrize("causal", [True, False])
def test_visible_pairs_closed_form_equals_the_loop(causal):
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    for S in range(0, 70):
        for window in [None, *range(-3, 75)]:
            assert visible_pairs(S, causal, window) == \
                _loop_pairs(S, causal, window), (S, window)
    for S, window in ((4096, 1024), (32768, 1024), (524288, 4096)):
        assert visible_pairs(S, causal, window) == \
            _loop_pairs(S, causal, window)
