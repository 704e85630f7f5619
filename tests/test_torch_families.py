"""The port's other model families against the JAX package's, in f32 on
the CPU: the SSD block (causal conv, chunked scan, forward, the serving
recurrence with its gates), the MoE layer (with capacity drops, and the
one-hot oracle), cross attention, and the forward, loss, serving steps
and decode-state layout of the reduced mamba2, mixtral, llama4-maverick,
llama-3.2-vision, hymba and whisper configs.

Weights come from the JAX package's ``init_params`` (cast to f32) and
cross through ``params_from_jax``; inputs are made with numpy from a
seed and fed to both.  Tolerance: rtol/atol 1e-4 on logits and states,
1e-5 on a single layer's outputs (f32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.runtime.kv import PagedKVSpec as JaxPagedKVSpec  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.interop import (decode_state_from_jax,  # noqa: E402
                                 params_from_jax, params_to_numpy)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.runtime.kv import PagedKVSpec  # noqa: E402
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402

TOL = 1e-4
TOL_LAYER = 1e-5
FAMILIES = ["mamba2-2.7b", "mixtral-8x22b", "llama4-maverick-400b-a17b",
            "llama-3.2-vision-90b", "hymba-1.5b", "whisper-medium"]


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _trees_close(got, want, tol=TOL):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        _close(g, w, tol)


def _cfgs(name, **overrides):
    jcfg = jax_get_config(name).reduced().replace(logits_dtype="float32",
                                                  **overrides)
    cfg = get_config(name).reduced().replace(logits_dtype="float32",
                                             **overrides)
    return jcfg, cfg


_MODELS: dict = {}


def _model(name):
    """The JAX and port models of a reduced config, f32 weights from seed
    0, shared by the tests of this file.  The vlm's cross-attention gate
    is set to 0.5 (it starts at 0, which would hide its layer)."""

    if name not in _MODELS:
        jcfg, cfg = _cfgs(name)
        japi = jax_build_model(jcfg)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                          japi.init(jax.random.PRNGKey(0)))
        if cfg.family == "vlm":
            blk = jp["blocks"]
            cross = [k for k in blk if k.endswith("_cross")][0]
            blk[cross]["gate"] = jnp.full_like(blk[cross]["gate"], 0.5)
        _MODELS[name] = (japi, build_model(cfg), jp,
                         params_from_jax(_np(jp), "cpu"))
    return _MODELS[name]


def _batch(cfg, B, S_, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.is_encdec:
        batch["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                           * 0.3).astype(np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = (rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)) * 0.3).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the SSD block
# ---------------------------------------------------------------------------


def _ssm_setup(name="mamba2-2.7b", seed=0):
    jcfg, cfg = _cfgs(name)
    jp = JC.init_params(JS.ssm_specs(jcfg), jax.random.PRNGKey(seed))
    # non-trivial decay, dt bias, skip and conv bias
    rng = np.random.default_rng(seed)
    for k in ("a_log", "dt_bias", "D", "conv_b"):
        jp[k] = jnp.asarray(rng.standard_normal(jp[k].shape) * 0.5)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, cfg, jp, params_from_jax(_np(jp), "cpu")


@pytest.mark.parametrize("B,S_,C,W", [(2, 9, 12, 4), (1, 1, 5, 4),
                                      (3, 17, 8, 2)])
def test_causal_conv_matches_jax(B, S_, C, W):
    rng = np.random.default_rng(B * S_)
    x = rng.standard_normal((B, S_, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = JS._causal_conv(*map(jnp.asarray, (x, w, b)))
    _close(S._causal_conv(*map(_t, (x, w, b))), want, TOL_LAYER)


@pytest.mark.parametrize("chunk", [4, 7, 24, 40])
def test_ssd_chunked_matches_jax(chunk):
    rng = np.random.default_rng(0)
    B, S_, H, P, N = 2, 24, 3, 4, 5
    x = rng.standard_normal((B, S_, H, P)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (B, S_, H)).astype(np.float32)
    A_ = -rng.uniform(0.1, 1.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S_, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S_, N)).astype(np.float32)
    args = (x, dt, A_, Bm, Cm)
    want = JS.ssd_chunked(*map(jnp.asarray, args), chunk)
    got = S.ssd_chunked(*map(_t, args), chunk)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, TOL_LAYER)


def test_ssd_chunked_bf16_compute_matches_jax():
    rng = np.random.default_rng(1)
    B, S_, H, P, N = 1, 20, 2, 4, 3
    x = rng.standard_normal((B, S_, H, P)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (B, S_, H)).astype(np.float32)
    A_ = -rng.uniform(0.1, 1.0, (H,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S_, N)).astype(np.float32)
              for _ in range(2))
    args = (x, dt, A_, Bm, Cm)
    want = JS.ssd_chunked(*map(jnp.asarray, args), 8,
                          compute_dtype=jnp.bfloat16)
    got = S.ssd_chunked(*map(_t, args), 8, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    # bf16 intra-chunk tensors: a bf16 ulp of the products
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("name,S_", [("mamba2-2.7b", 13), ("hymba-1.5b", 8)])
def test_ssm_forward_matches_jax(name, S_):
    jcfg, cfg, jp, p = _ssm_setup(name)
    rng = np.random.default_rng(S_)
    x = (rng.standard_normal((2, S_, cfg.d_model)) * 0.5).astype(np.float32)
    _close(S.ssm_forward(p, cfg, _t(x)),
           JS.ssm_forward(jp, jcfg, jnp.asarray(x)), TOL_LAYER)


def _ssm_state(jcfg, B, seed):
    rng = np.random.default_rng(seed)
    spec = JS.ssm_state_specs(jcfg, B, dtype=jnp.float32)
    return {k: rng.standard_normal(s.shape).astype(np.float32)
            for k, s in spec.items()}


def test_ssm_state_specs_keep_h_in_f32():
    jcfg, cfg = _cfgs("hymba-1.5b")
    for dtype in (None, torch.float32):
        spec = S.ssm_state_specs(cfg, 3, dtype=dtype)
        jspec = JS.ssm_state_specs(jcfg, 3, dtype=None if dtype is None
                                   else jnp.float32)
        assert spec["h"].dtype == torch.float32
        assert spec["conv"].dtype == (dtype or torch.bfloat16)
        for k in spec:
            assert spec[k].shape == jspec[k].shape


def test_ssm_decode_step_matches_jax_and_gates_slots():
    jcfg, cfg, jp, p = _ssm_setup()
    st = _ssm_state(jcfg, 3, seed=2)
    x = (np.random.default_rng(3).standard_normal((3, 1, cfg.d_model))
         * 0.5).astype(np.float32)
    want, wst = JS.ssm_decode_step(jp, jcfg, jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, st))
    tst = {k: _t(v) for k, v in st.items()}
    got, gst = S.ssm_decode_step(p, cfg, _t(x), tst)
    assert gst is tst                                   # written in place
    _close(got, want, TOL_LAYER)
    _trees_close(params_to_numpy(gst), _np(wst), TOL_LAYER)
    # an inactive slot keeps its state
    tst = {k: _t(v) for k, v in st.items()}
    S.ssm_decode_step(p, cfg, _t(x), tst,
                      active=torch.tensor([True, False, True]))
    for k in st:
        assert torch.equal(tst[k][1], _t(st[k][1]))
        _close(tst[k][[0, 2]], np.asarray(wst[k])[[0, 2]], TOL_LAYER)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_prefill_step_matches_jax_with_valid_gating(name):
    jcfg, cfg, jp, p = _ssm_setup(name, seed=1)
    B, T = 3, 7
    st = _ssm_state(jcfg, B, seed=4)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((B, T, cfg.d_model)) * 0.5).astype(np.float32)
    lengths = np.array([T, 3, 0])
    valid = np.arange(T)[None, :] < lengths[:, None]
    want, wst = JS.ssm_prefill_step(jp, jcfg, jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, st),
                                    jnp.asarray(valid))
    # the verifier's form reads the state and writes nothing
    tst = {k: _t(v) for k, v in st.items()}
    got, _ = S.ssm_prefill_step(p, cfg, _t(x), tst, _t(valid), write=False)
    for k in st:
        assert torch.equal(tst[k], _t(st[k]))
    got2, gst = S.ssm_prefill_step(p, cfg, _t(x), tst, _t(valid))
    assert gst is tst
    for b in range(B):          # rows past a slot's length are padding
        n = int(lengths[b])
        _close(got[b, :n], np.asarray(want)[b, :n], TOL_LAYER)
        _close(got2[b, :n], np.asarray(want)[b, :n], TOL_LAYER)
    _trees_close(params_to_numpy(gst), _np(wst), TOL_LAYER)
    for k in st:                # a slot of length 0 is untouched
        assert torch.equal(gst[k][2], _t(st[k][2]))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_setup(name, capacity_factor, seed=2):
    jcfg, cfg = _cfgs(name)
    jcfg = jcfg.replace(moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), JC.init_params(
        JM.moe_specs(jcfg), jax.random.PRNGKey(seed)))
    return jcfg, cfg, jp, params_from_jax(_np(jp), "cpu")


def test_moe_specs_and_capacity_match_jax():
    for name in ("mixtral-8x22b", "llama4-maverick-400b-a17b"):
        cfg, jcfg = ARCHS[name], JAX_ARCHS[name]
        specs, jspecs = M.moe_specs(cfg), JM.moe_specs(jcfg)
        assert list(specs) == list(jspecs)
        for k in specs:
            assert specs[k].shape == jspecs[k].shape
        assert specs["router"].dtype == torch.float32
        for tokens in (1, 7, 64, 4096, 100_003):
            assert M.capacity(cfg, tokens) == JM.capacity(jcfg, tokens)


@pytest.mark.parametrize("name", ["mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("capacity_factor", [0.25, 16.0])
def test_moe_forward_matches_jax_and_the_oracle(name, capacity_factor):
    jcfg, cfg, jp, p = _moe_setup(name, capacity_factor)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want = JM.moe_forward(jp, jcfg, jnp.asarray(x))
    got = M.moe_forward(p, cfg, _t(x))
    _close(got, want, TOL_LAYER)
    _close(M.moe_forward_einsum(p, cfg, _t(x)), got, TOL_LAYER)
    _close(M.moe_forward_einsum(p, cfg, _t(x)),
           JM.moe_forward_einsum(jp, jcfg, jnp.asarray(x)), TOL_LAYER)
    # 80 (token, choice) pairs a row: a quarter of the capacity drops some
    C = M.capacity(cfg, 40)
    _, idx = M._route(cfg, p, _t(x).reshape(80, -1))
    per_expert = torch.bincount(idx.reshape(2, -1)[0],
                                minlength=cfg.moe.num_experts)
    assert bool((per_expert > C).any()) == (capacity_factor == 0.25)


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------


def _cross_setup(name, seed=0):
    jcfg, cfg = _cfgs(name)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), JC.init_params(
        JA.attn_specs(jcfg, cross=True), jax.random.PRNGKey(seed)))
    return jcfg, cfg, jp, params_from_jax(_np(jp), "cpu")


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "qwen3-32b"])
def test_cross_attention_matches_jax(name):
    jcfg, cfg, jp, p = _cross_setup(name)
    assert "bq" not in p                    # no QKV bias on the cross path
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 9, cfg.d_model)) * 0.5).astype(np.float32)
    kv = (rng.standard_normal((2, 13, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy() + 5
    want = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                        x_kv=jnp.asarray(kv))
    got = A.attention(p, cfg, _t(x), _t(pos), x_kv=_t(kv), use_flash=True)
    _close(got, want, TOL_LAYER)


def test_decode_cross_attention_matches_jax():
    jcfg, cfg, jp, p = _cross_setup("llama-3.2-vision-90b")
    rng = np.random.default_rng(2)
    shape = (3, cfg.n_kv_heads, 11, cfg.hd)
    enc_kv = {k: rng.standard_normal(shape).astype(np.float32)
              for k in ("k", "v")}
    for T in (1, 4):
        x = (rng.standard_normal((3, T, cfg.d_model)) * 0.5
             ).astype(np.float32)
        want = JA.decode_cross_attention(jp, jcfg, jnp.asarray(x),
                                         jax.tree.map(jnp.asarray, enc_kv))
        got = A.decode_cross_attention(p, cfg, _t(x),
                                       {k: _t(v) for k, v in enc_kv.items()})
        _close(got, want, TOL_LAYER)


# ---------------------------------------------------------------------------
# the model API over every family
# ---------------------------------------------------------------------------


def test_every_config_builds_with_the_reference_tree():
    """All ten configs at full size: the same parameter tree, shapes and
    count as the JAX package's (no weights are made)."""

    from repro_torch.models.common import PSpec, tree_leaves
    for name, cfg in ARCHS.items():
        api, japi = build_model(cfg), jax_build_model(JAX_ARCHS[name])
        specs = jax.tree.map(lambda s: s.shape, api.specs,
                             is_leaf=lambda s: isinstance(s, PSpec))
        jspecs = jax.tree.map(lambda s: s.shape, japi.specs,
                              is_leaf=lambda s: isinstance(s, JC.PSpec))
        assert specs == jspecs, name
        assert api.param_count() == japi.param_count(), name
        f32 = [s for s in tree_leaves(api.specs) if s.dtype == torch.float32]
        jf32 = [s for s in jax.tree.leaves(
            japi.specs, is_leaf=lambda s: isinstance(s, JC.PSpec))
            if s.dtype == jnp.float32]
        assert len(f32) == len(jf32), name


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_loss_match_jax(name):
    japi, api, jp, p = _model(name)
    batch = _batch(api.cfg, 2, 16, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    want = japi.forward(jp, jb)
    got = api.forward(p, tb)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    _close(api.loss(p, tb), japi.loss(jp, jb))


def _state(japi, B, ctx, seed, paged=None):
    js = japi.init_decode_state(B, ctx, paged, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    # non-zero rings, recurrent and cross state, so every leaf is read
    js = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape) * 0.5, a.dtype), js)
    return js, decode_state_from_jax(_np(js), "cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_serving_steps_match_jax(name):
    japi, api, jp, p = _model(name)
    B, ctx, T = 3, 24, 6
    js, st = _state(japi, B, ctx, seed=3)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, api.cfg.vocab, (B, T)).astype(np.int32)
    pos = np.array([0, 4, 9], np.int32)
    lengths = np.array([T, 3, 0], np.int32)

    # verify_step: logits everywhere, the port's state untouched
    wl, _ = japi.verify_step(jp, js, jnp.asarray(toks), jnp.asarray(pos),
                             jnp.asarray(lengths))
    before = params_to_numpy(st)
    gl, st_v = api.verify_step(p, st, _t(toks), _t(pos), _t(lengths))
    assert st_v is st
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves(params_to_numpy(st))):
        np.testing.assert_array_equal(a, b)
    for b in range(B):
        n = int(lengths[b])
        _close(gl[b, :n], np.asarray(wl)[b, :n])

    # prefill_step: logits at each slot's last valid token, state in place
    wl, js = japi.prefill_step(jp, js, jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(lengths))
    gl, st = api.prefill_step(p, st, _t(toks), _t(pos), _t(lengths))
    for b in range(2):                    # slot 2 had no valid token
        _close(gl[b], np.asarray(wl)[b])
    _trees_close(params_to_numpy(st), _np(js))

    # decode_step: per-slot positions
    cur = pos + lengths
    t1 = toks[:, :1]
    for _ in range(3):
        wl, js = japi.decode_step(jp, js, jnp.asarray(t1), jnp.asarray(cur))
        gl, st = api.decode_step(p, st, _t(t1), _t(cur))
        _close(gl, wl)
        t1 = np.asarray(jnp.argmax(wl, axis=-1), np.int32)[:, None]
        cur = cur + 1
    _trees_close(params_to_numpy(st), _np(js))


@pytest.mark.parametrize("name", ["hymba-1.5b", "mixtral-8x22b"])
def test_paged_serving_steps_match_jax(name):
    """The paged steps over a hybrid (pool + per-slot SSM state) and an
    MoE stack: one page table for both packages, slot 1's pages out of
    order."""

    japi, api, jp, p = _model(name)
    B, T, ps = 2, 5, 4
    js, st = _state(japi, B, 32, seed=6, paged=JaxPagedKVSpec(9, ps, 4))
    table = np.array([[0, 1, 2, -1], [7, 3, 5, -1]], np.int32)
    toks = np.random.default_rng(7).integers(
        0, api.cfg.vocab, (B, T)).astype(np.int32)
    pos = np.array([0, 3], np.int32)
    lengths = np.array([T, 2], np.int32)
    wl, js = japi.prefill_step(jp, js, jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(lengths), jnp.asarray(table))
    gl, st = api.prefill_step(p, st, _t(toks), _t(pos), _t(lengths),
                              _t(table))
    _close(gl, wl)
    _trees_close(params_to_numpy(st), _np(js))
    prior = params_to_numpy(st)
    cur = pos + lengths
    active = np.array([True, False])
    wl, js = japi.decode_step(jp, js, jnp.asarray(toks[:, :1]),
                              jnp.asarray(cur), jnp.asarray(table),
                              jnp.asarray(active))
    gl, st = api.decode_step(p, st, _t(toks[:, :1]), _t(cur), _t(table),
                             active=_t(active))
    _close(gl[0], np.asarray(wl)[0])
    # the reference's decode_step writes every slot's SSM state (its
    # Server merges by ``active``); the port gates it in the step, so
    # slot 1's recurrent leaves are compared against their prior values
    got, want = params_to_numpy(st), _np(js)
    for key, entry in got["blocks"].items():
        _trees_close(entry["kv"], want["blocks"][key]["kv"])
        for leaf, g in entry.get("ssm", {}).items():
            _close(g[:, 0], want["blocks"][key]["ssm"][leaf][:, 0])
            np.testing.assert_array_equal(
                g[:, 1], prior["blocks"][key]["ssm"][leaf][:, 1])


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_state_layout_matches_jax(name):
    japi, api, _, _ = _model(name)
    for paged, jpaged in ((None, None),
                          (PagedKVSpec(5, 4, 4), JaxPagedKVSpec(5, 4, 4))):
        for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
            js = _np(japi.init_decode_state(2, 16, jpaged, dtype=jdtype))
            st = api.init_decode_state(2, 16, paged, dtype=dtype,
                                       device="cpu")
            assert jax.tree.structure(js) == \
                jax.tree.structure(params_to_numpy(st))
            for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(st)):
                assert a.shape == tuple(b.shape)
                assert a.dtype.name == str(b.dtype).split(".")[-1]


def test_encode_cross_kv_matches_jax():
    japi, api, jp, p = _model("whisper-medium")
    frames = (np.random.default_rng(8).standard_normal(
        (2, api.cfg.enc_seq, api.cfg.d_model)) * 0.3).astype(np.float32)
    want = japi.encode_cross_kv(jp, jnp.asarray(frames))
    got = api.encode_cross_kv(p, _t(frames))
    assert got["k"].shape == (api.cfg.n_layers, 2, api.cfg.n_kv_heads,
                              api.cfg.enc_seq, api.cfg.hd)
    _trees_close({k: v.numpy() for k, v in got.items()}, _np(want))


def test_params_and_state_carry_f32_leaves_across():
    """The router, the cross gate and the SSM state are f32 in both
    packages, whatever the params' dtype; they cross as f32."""

    for name, leaf in (("mixtral-8x22b", ("blocks", "0_moe", "ffn",
                                          "router")),
                       ("llama-3.2-vision-90b", ("blocks", "1_cross",
                                                 "gate"))):
        jcfg = jax_get_config(name).reduced()
        jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
        p = params_from_jax(_np(jp), "cpu")
        a, b = jp, p
        for k in leaf:
            a, b = a[k], b[k]
        assert a.dtype == jnp.float32 and b.dtype == torch.float32
        assert p["embed"].dtype == torch.bfloat16
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    japi = jax_build_model(jax_get_config("hymba-1.5b").reduced())
    js = japi.init_decode_state(2, 16)
    st = decode_state_from_jax(_np(js), "cpu")
    ssm = st["blocks"]["0_hybrid"]["ssm"]
    assert ssm["h"].dtype == torch.float32
    assert ssm["conv"].dtype == torch.bfloat16
