"""The port's dense model path against the JAX package's, in f32 on the
CPU: numerics, attention (flash gate on and off, windows, qkv bias,
qk-norm, query chunking), the cached decode and chunked-prefill paths,
and ``forward`` / ``loss`` / ``decode_step`` / ``prefill_step`` /
``verify_step`` of reduced configs.

Weights come from the JAX package's ``init_params`` (cast to f32) and
cross through ``params_from_jax``; inputs are made with numpy from a
seed and fed to both.  Tolerance: rtol/atol 1e-4 on logits and 1e-5 on
attention outputs (f32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.interop import (decode_state_from_jax,  # noqa: E402
                                 params_from_jax, params_to_numpy)
from repro_torch.kernels.flash_attention.kernel import flash_kernel  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402

ATOL_ATTN = 1e-5
TOL_LOGITS = 1e-4
CONFIGS = ["smollm-135m", "qwen1.5-4b"]


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _model(name, **overrides):
    jcfg = jax_get_config(name).reduced().replace(logits_dtype="float32",
                                                  **overrides)
    cfg = get_config(name).reduced().replace(logits_dtype="float32",
                                             **overrides)
    japi, api = jax_build_model(jcfg), build_model(cfg)
    jp = _f32(japi.init(jax.random.PRNGKey(0)))
    return japi, api, jp, params_from_jax(_np(jp), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# configs and numerics
# ---------------------------------------------------------------------------


def test_the_registry_is_the_reference_registry():
    from repro.configs import ARCHS as JAX_ARCHS
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name, cfg in ARCHS.items():
        ref = JAX_ARCHS[name]
        for field in ("family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab", "hd", "qk_norm",
                      "qkv_bias", "window", "rope_theta", "tie_embeddings",
                      "mlp_act", "use_flash"):
            assert getattr(cfg, field) == getattr(ref, field), (name, field)
        assert cfg.reduced().hd == ref.reduced().hd


def test_rms_norm_rope_swiglu_ce_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    _close(C.rms_norm(_t(x), _t(w)), JC.rms_norm(jnp.asarray(x),
                                                 jnp.asarray(w)), 1e-6)
    pos = (rng.integers(0, 5000, (2, 5))).astype(np.int32)   # offsets
    _close(C.rope(_t(x), _t(pos), 1e6),
           JC.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    xo = rng.standard_normal((2, 5, 15)).astype(np.float32)   # odd dim
    po = rng.integers(0, 64, (2, 5)).astype(np.int32)
    _close(C.rope(_t(xo), _t(po)), JC.rope(jnp.asarray(xo),
                                           jnp.asarray(po)), 1e-5)
    h = rng.standard_normal((4, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 32)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((32, 16)).astype(np.float32)
    _close(C.swiglu(*map(_t, (h, wg, wu, wd))),
           JC.swiglu(*map(jnp.asarray, (h, wg, wu, wd))), 1e-5)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    _close(C.softmax_cross_entropy(_t(logits), _t(labels)),
           JC.softmax_cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(labels)), 1e-6)


def test_init_params_keeps_the_reference_scale_rule():
    api = build_model(get_config("qwen1.5-4b").reduced())
    g = torch.Generator()
    g.manual_seed(0)
    p = api.init(g, device="cpu")
    blk = p["blocks"]["0_dense"]
    assert blk["attn"]["wq"].dtype == torch.bfloat16
    hd = api.cfg.hd
    # stddev shape[-1] ** -0.5: hd for wq, vocab for unembed, 0.02 embed
    assert float(blk["attn"]["wq"].float().std()) == pytest.approx(
        hd ** -0.5, rel=0.1)
    assert float(p["unembed"].float().std()) == pytest.approx(
        api.cfg.vocab ** -0.5, rel=0.1)
    assert float(p["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    assert not blk["attn"]["bq"].any() and bool((blk["ln1"] == 1).all())
    again = api.init(0, device="cpu")
    assert torch.equal(again["embed"], api.init(0, device="cpu")["embed"])


def test_params_round_trip_is_exact():
    japi = jax_build_model(jax_get_config("qwen1.5-4b").reduced())
    for jp in (japi.init(jax.random.PRNGKey(1)),
               _f32(japi.init(jax.random.PRNGKey(2)))):
        tree = params_from_jax(_np(jp), "cpu")
        back = params_to_numpy(tree)
        want = jax.tree.leaves(_np(jp))
        got = jax.tree.leaves(back)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w.astype(np.float32))
        assert jax.tree.structure(back) == jax.tree.structure(_np(jp))
    assert tree["embed"].dtype == torch.float32


def test_other_families_raise():
    for name in ("mamba2-2.7b", "mixtral-8x22b", "whisper-medium"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(get_config(name).reduced())


# ---------------------------------------------------------------------------
# full-sequence attention
# ---------------------------------------------------------------------------


def _attn_setup(name, S, B=2, seed=0, **overrides):
    jcfg = jax_get_config(name).reduced().replace(**overrides)
    cfg = get_config(name).reduced().replace(**overrides)
    jp = _f32(JC.init_params(JA.attn_specs(jcfg), jax.random.PRNGKey(seed)))
    if "bq" in jp:      # non-zero biases, so the bias path is exercised
        rng = np.random.default_rng(seed + 1)
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, jnp.float32)
                  if k.startswith("b") else v) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.3).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return jcfg, cfg, jp, params_from_jax(_np(jp), "cpu"), x, pos


@pytest.mark.parametrize("name", ["smollm-135m", "qwen1.5-4b", "qwen3-32b"])
@pytest.mark.parametrize("S", [128, 96])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("use_flash", [True, False])
def test_attention_matches_jax(name, S, window, use_flash):
    jcfg, cfg, jp, p, x, pos = _attn_setup(name, S)
    want = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                        causal=True, window=window, use_flash=use_flash)
    got = A.attention(p, cfg, _t(x), _t(pos), causal=True, window=window,
                      use_flash=use_flash)
    _close(got, want, ATOL_ATTN)


def test_attention_non_causal_matches_jax():
    jcfg, cfg, jp, p, x, pos = _attn_setup("smollm-135m", 128)
    for use_flash in (True, False):
        want = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                            causal=False, window=16, use_flash=use_flash)
        got = A.attention(p, cfg, _t(x), _t(pos), causal=False, window=16,
                          use_flash=use_flash)
        _close(got, want, ATOL_ATTN)


def test_flash_gate_on_the_cpu():
    assert A._flash_supported(torch.zeros(1, 2, 128, 16))   # any head dim
    assert A._flash_supported(torch.zeros(1, 2, 256, 96))
    assert not A._flash_supported(torch.zeros(1, 2, 96, 64))
    pos = torch.arange(128)[None]
    assert A._positions_standard(pos, 128)
    assert not A._positions_standard(pos + 3, 128)


def test_offset_positions_take_the_plain_path():
    jcfg, cfg, jp, p, x, pos = _attn_setup("smollm-135m", 128)
    pos = pos + 5
    want = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                        causal=True, use_flash=True)
    got = A.attention(p, cfg, _t(x), _t(pos), causal=True, use_flash=True)
    _close(got, want, ATOL_ATTN)


@pytest.mark.parametrize("window", [None, 24])
def test_query_chunked_attention_matches_jax(monkeypatch, window):
    monkeypatch.setattr(JA, "Q_CHUNK_THRESHOLD", 32)
    monkeypatch.setattr(A, "Q_CHUNK_THRESHOLD", 32)
    jcfg, cfg, jp, p, x, pos = _attn_setup("smollm-135m", 96)
    want = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                        causal=True, window=window)
    got = A.attention(p, cfg, _t(x), _t(pos), causal=True, window=window)
    _close(got, want, ATOL_ATTN)
    # several chunks, ragged, at offset positions
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 4, 70, 16)).astype(np.float32)
               for _ in range(3))
    offs = (np.arange(70)[None] + np.array([[0], [9]])).astype(np.int32)
    want = JA._sdpa_qchunked(*map(jnp.asarray, (q, k, v, offs)), 0.25,
                             causal=True, window=window, chunk=32)
    got = A._sdpa_qchunked(*map(_t, (q, k, v, offs)), 0.25, causal=True,
                           window=window, chunk=32)
    _close(got, want, ATOL_ATTN)


# ---------------------------------------------------------------------------
# cached decode and chunked prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_per_slot_matches_jax(window):
    jcfg, cfg, jp, p, _, _ = _attn_setup("smollm-135m", 4, B=3)
    rng = np.random.default_rng(7)
    C_len = 8 if window else 32
    shape = (3, cfg.n_kv_heads, C_len, cfg.hd)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)}
    x = (rng.standard_normal((3, 1, cfg.d_model)) * 0.3).astype(np.float32)
    cur = np.array([0, 5, 19], np.int32)
    want, wcache = JA.decode_attention(jp, jcfg, jnp.asarray(x),
                                       _f32(cache), jnp.asarray(cur),
                                       window=window)
    tcache = {k: _t(v) for k, v in cache.items()}
    got, gcache = A.decode_attention(p, cfg, _t(x), tcache, _t(cur),
                                     window=window)
    assert gcache is tcache                       # written in place
    _close(got, want, ATOL_ATTN)
    for name in ("k", "v"):
        _close(gcache[name], wcache[name], ATOL_ATTN)
    # an inactive slot's ring is left as it was
    tcache = {k: _t(v) for k, v in cache.items()}
    active = torch.tensor([True, False, True])
    A.decode_attention(p, cfg, _t(x), tcache, _t(cur), window=window,
                       active=active)
    assert torch.equal(tcache["k"][1], _t(cache["k"][1]))
    _close(tcache["k"][2], wcache["k"][2], ATOL_ATTN)


@pytest.mark.parametrize("window,T", [(None, 6), (8, 6), (8, 12)])
def test_decode_attention_chunked_matches_jax(window, T):
    jcfg, cfg, jp, p, _, _ = _attn_setup("smollm-135m", 4, B=3)
    rng = np.random.default_rng(8)
    C_len = 8 if window else 32
    shape = (3, cfg.n_kv_heads, C_len, cfg.hd)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)}
    x = (rng.standard_normal((3, T, cfg.d_model)) * 0.3).astype(np.float32)
    cur = np.array([0, 3, 11], np.int32)
    lengths = np.array([T, T - 2, 0], np.int32)
    want, wcache = JA.decode_attention_chunked(
        jp, jcfg, jnp.asarray(x), _f32(cache), jnp.asarray(cur),
        jnp.asarray(lengths), window=window)
    tcache = {k: _t(v) for k, v in cache.items()}
    got, _ = A.decode_attention_chunked(p, cfg, _t(x), tcache, _t(cur),
                                        _t(lengths), window=window)
    # rows past a slot's length are padding in both: compare valid rows
    for b in range(3):
        n = int(lengths[b])
        _close(got[b, :n], np.asarray(want)[b, :n], ATOL_ATTN)
    for name in ("k", "v"):
        _close(tcache[name], wcache[name], ATOL_ATTN)
    assert torch.equal(tcache["k"][2], _t(cache["k"][2]))   # length 0


# ---------------------------------------------------------------------------
# the model API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("S", [96, 128])
def test_forward_and_loss_match_jax(name, S):
    japi, api, jp, p = _model(name)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, api.cfg.vocab, (2, S)).astype(np.int32)
    want = japi.forward(jp, {"tokens": jnp.asarray(toks)})
    before = flash_kernel.launches
    got = api.forward(p, {"tokens": _t(toks)})
    assert flash_kernel.launches == before      # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, TOL_LOGITS)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl = japi.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl = api.loss(p, {k: _t(v) for k, v in batch.items()})
    _close(tl, jl, TOL_LOGITS)


def test_chunked_loss_matches_jax():
    japi, api, jp, p = _model("smollm-135m", loss_seq_chunk=24)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, api.cfg.vocab, (2, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, 1, axis=1)}
    jl = japi.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl = api.loss(p, {k: _t(v) for k, v in batch.items()})
    _close(tl, jl, TOL_LOGITS)


def _state(japi, B, ctx):
    js = japi.init_decode_state(B, ctx, dtype=jnp.float32)
    rng = np.random.default_rng(B * ctx)
    # a non-zero ring, so stale entries must be masked to agree
    js = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32), js)
    return js, decode_state_from_jax(_np(js), "cpu")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("window", [None, 8])
def test_serving_steps_match_jax(name, window):
    japi, api, jp, p = _model(name, window=window)
    B, ctx, T = 3, 24, 6
    js, st = _state(japi, B, ctx)
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
        _close(gl[b, :n], np.asarray(wl)[b, :n], TOL_LOGITS)

    # prefill_step: logits at each slot's last valid token, state in place
    wl, js = japi.prefill_step(jp, js, jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(lengths))
    gl, st = api.prefill_step(p, st, _t(toks), _t(pos), _t(lengths))
    assert gl.shape == wl.shape
    for b in range(2):                    # slot 2 had no valid token
        _close(gl[b], np.asarray(wl)[b], TOL_LOGITS)
    for a, b in zip(jax.tree.leaves(_np(js)),
                    jax.tree.leaves(params_to_numpy(st))):
        _close(b, a, TOL_LOGITS)

    # decode_step: per-slot positions
    cur = pos + lengths
    t1 = toks[:, :1]
    for _ in range(3):
        wl, js = japi.decode_step(jp, js, jnp.asarray(t1), jnp.asarray(cur))
        gl, st = api.decode_step(p, st, _t(t1), _t(cur))
        _close(gl, wl, TOL_LOGITS)
        t1 = np.asarray(jnp.argmax(wl, axis=-1), np.int32)[:, None]
        cur = cur + 1
    for a, b in zip(jax.tree.leaves(_np(js)),
                    jax.tree.leaves(params_to_numpy(st))):
        _close(b, a, TOL_LOGITS)


def test_decode_state_layout_matches_jax():
    japi, api, _, _ = _model("qwen1.5-4b")
    js = _np(japi.init_decode_state(2, 16))
    st = api.init_decode_state(2, 16, device="cpu")
    assert jax.tree.structure(js) == jax.tree.structure(params_to_numpy(st))
    for a, b in zip(jax.tree.leaves(js),
                    jax.tree.leaves(params_to_numpy(st))):
        assert a.shape == b.shape
    assert st["blocks"]["0_dense"]["kv"]["k"].dtype == torch.bfloat16
    assert api.param_count() == japi.param_count()
    with pytest.raises(NotImplementedError, match="paged"):
        api.init_decode_state(2, 16, paged=object(), device="cpu")
