"""The port's training path against the JAX package's, in f32 on the CPU:
AdamW, the cosine schedule, the global norm and int8 error-feedback
compression on the same trees; ``build_train_step`` for one and three
steps (microbatches 1 and 4, compression on and off) from the same
state; remat none/dots/full; each family's loss and gradients; the
synthetic pipeline's batches; ``run_training`` with an injected failure;
the driver ``python -m repro_torch.launch.train``; and flash attention
under a gradient, which raises in both packages.

Weights come from the JAX package's ``init`` (cast to f32) and cross
through ``params_from_jax`` / ``train_state_from_jax``; other inputs are
made with numpy from a seed.  Tolerances: 1e-5 relative on the optimizer
maths (f32, a few ulps: XLA fuses the chain); 1e-4 on losses and gradients of a model
(f32 sums in another order); params after a step 1e-5 absolute (an
Adam step is ~lr wherever a gradient is not zero); quantised int8
values equal.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.kernels.flash_attention.ops import _flash_call  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import loop as JL  # noqa: E402
from repro.runtime import train as JT  # noqa: E402
from repro_torch import optim as O  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.tpu_machine import TPUWorkload, tune_distributed  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.interop import (params_from_jax, params_to_numpy,  # noqa: E402
                                 train_state_from_jax, train_state_to_numpy)
from repro_torch.kernels.flash_attention.kernel import flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (attention_ref,  # noqa: E402
                                                     flash_attention)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import (LoopConfig, SimulatedFailure,  # noqa: E402
                                 TrainConfig, build_train_step,
                                 init_train_state, run_training)
from repro_torch.runtime.train import value_and_grad  # noqa: E402
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
OPT_TOL = 1e-5
TOL = 1e-4
PARAM_ATOL = 1e-5
FAMILIES = ["smollm-135m", "mamba2-2.7b", "hymba-1.5b", "mixtral-8x22b",
            "whisper-medium", "llama-3.2-vision-90b"]


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _trees_close(got, want, rtol=TOL, atol=TOL):
    """``got`` a port tree (tensors or numpy), ``want`` a JAX tree; both
    nested dicts keyed alike."""

    want = _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _trees_close(got[k], want[k], rtol, atol)
        return
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, rtol, atol)


def _scaled_close(got, want, tol=OPT_TOL):
    """Elementwise within ``tol`` of the leaf's largest magnitude: the
    moments' ``b * m + (1 - b) * g`` cancels to values far below the
    leaf's scale, where a relative bound would read an ulp as an
    error."""

    want = np.asarray(want, np.float32)
    _close(got, want, 0, tol * float(np.abs(want).max()))


def _tree_pairs(got, want):
    """(port leaf as numpy f32, JAX leaf as numpy) pairs of two nested
    dicts keyed alike."""

    want = _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        return [pair for k in sorted(want)
                for pair in _tree_pairs(got[k], want[k])]
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert tuple(got.shape) == tuple(want.shape)
    return [(got, want)]


def _mostly_close(got, want, rtol, atol, bound, frac=1e-3):
    """Within (rtol, atol) but for at most ``frac`` of the elements (one
    at least), each of those within ``bound``.  An Adam step moves a
    parameter by ~lr wherever its gradient is within a few eps of 0,
    whatever that gradient's rounding; an int8 quantum flips where a
    value lands on a rounding boundary."""

    n_out, n = 0, 0
    for g, w in _tree_pairs(got, want):
        w = w.astype(np.float32)
        err = np.abs(g - w)
        n += err.size
        n_out += int(np.sum(err > atol + rtol * np.abs(w)))
        assert float(err.max()) <= bound, (float(err.max()), bound)
    assert n_out <= max(1, frac * n), (n_out, n)


def _tree(seed, dtype=np.float32, scale=1.0):
    """A small parameter-like tree: nested dicts, a stacked leaf."""

    rng = np.random.default_rng(seed)
    leaf = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"embed": leaf(37, 8), "blocks": {"w": leaf(3, 8, 300),
                                             "b": leaf(3, 300)},
            "ln": leaf(8)}


def _both(tree, dtype):
    """The same tree as JAX arrays and as port tensors, in ``dtype``."""

    j = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    return j, params_from_jax(_np(j), "cpu")


# ---------------------------------------------------------------------------
# the optimizer's maths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, None])
@pytest.mark.parametrize("schedule", [True, False])
def test_adamw_three_updates_match_jax(dtype, clip_norm, schedule):
    jdt = getattr(jnp, dtype)
    jp, p = _both(_tree(0, scale=0.1), jdt)
    jstate, state = JO.adamw_init(jp), O.adamw_init(p)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    assert all(m.dtype == torch.float32 for m in state.m.values()
               if isinstance(m, torch.Tensor))
    jlr = JO.cosine_schedule(1e-2, 2, 10) if schedule else 1e-2
    lr = O.cosine_schedule(1e-2, 2, 10) if schedule else 1e-2
    for i in range(3):
        # gradients large enough that the clip acts on the first step
        jg, g = _both(_tree(10 + i, scale=3.0 if i == 0 else 0.01), jdt)
        jp, jstate, jm = JO.adamw_update(jp, jg, jstate, lr=jlr,
                                         clip_norm=clip_norm)
        p, state, m = O.adamw_update(p, g, state, lr=lr, clip_norm=clip_norm)
        assert all(t.dtype == getattr(torch, dtype)
                   for t in [p["embed"], p["ln"], p["blocks"]["w"]])
        assert int(state.step) == int(jstate.step) == i + 1
        _close(m["grad_norm"], jm["grad_norm"], OPT_TOL, 0)
        _close(m["lr"], jm["lr"], OPT_TOL, 0)
        for tree, jtree in ((state.m, jstate.m), (state.v, jstate.v)):
            for g, w in _tree_pairs(tree, jtree):
                _scaled_close(g, w)
        # bf16 params: a rounding tie may land one bf16 ulp apart
        for g, w in _tree_pairs(p, jp):
            _scaled_close(g, w, OPT_TOL if dtype == "float32" else 8e-3)


def test_global_norm_and_cosine_schedule_match_jax():
    jt, t = _both(_tree(3), jnp.bfloat16)
    _close(O.global_norm(t), JO.global_norm(jt), OPT_TOL, 0)
    jlr, lr = JO.cosine_schedule(3e-4, 10, 100), O.cosine_schedule(3e-4, 10,
                                                                    100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        _close(lr(torch.tensor(s, dtype=torch.int32)),
               jlr(jnp.asarray(s, jnp.int32)), OPT_TOL, 0)


@pytest.mark.parametrize("shape", [(5,), (256,), (3, 300), (2, 7, 129)])
def test_compress_int8_matches_jax(shape):
    x = (np.random.default_rng(len(shape)).standard_normal(shape)
         * 0.01).astype(np.float32)
    jq, js = JO.compress_int8(jnp.asarray(x))
    q, s = O.compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(s, js, OPT_TOL, 0)
    _close(O.decompress_int8(q, s, shape),
           JO.decompress_int8(jq, js, shape), OPT_TOL, 0)


def test_compress_int8_rounds_half_to_even_and_clips():
    # a block whose max is 127 has scale 1: k + 0.5 rounds to even
    x = np.zeros(256, np.float32)
    x[:6] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0]
    q, _ = O.compress_int8(torch.from_numpy(x))
    jq, _ = JO.compress_int8(jnp.asarray(x))
    assert q[0, :6].tolist() == [0, 2, 2, 0, -2, 127]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_grads_two_steps_match_jax(dtype):
    jdt = getattr(jnp, dtype)
    jg, g = _both(_tree(5, scale=0.02), jdt)
    jout, jres = JO.ef_compress_grads(jg, None)
    out, res = O.ef_compress_grads(g, None)
    jout, jres = JO.ef_compress_grads(jg, jres)
    out, res = O.ef_compress_grads(g, res)
    assert out["embed"].dtype == getattr(torch, dtype)
    assert res["embed"].dtype == torch.float32
    for tree, jtree in ((out, jout), (res, jres)):
        for g, w in _tree_pairs(tree, jtree):
            _scaled_close(g, w)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _small(name="smollm-135m", **kw):
    jcfg = jax_get_config(name).reduced().replace(logits_dtype="float32",
                                                  **kw)
    cfg = get_config(name).reduced().replace(logits_dtype="float32", **kw)
    return jcfg, cfg


def _jax_state(japi, tcfg, seed=0):
    """The JAX train state with f32 params (the port gets it through
    ``train_state_from_jax``)."""

    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          japi.init(jax.random.PRNGKey(seed)))
    residual = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             params) if tcfg.compress_pod_grads else None)
    return JT.TrainState(params, JO.adamw_init(params), residual)


def _data(jcfg, cfg, B=8, S=32, seed=0):
    return (JaxSyntheticLM(jcfg, JaxShapeSpec("t", S, B, "train"),
                           JaxDataConfig(seed=seed)),
            SyntheticLM(cfg, ShapeSpec("t", S, B, "train"),
                        DataConfig(seed=seed), device="cpu"))


def _states_close(state, jstate, lr_sum):
    """Params within 1e-5 but where an Adam step of a near-zero gradient
    moved them (each by at most 4 lr a step); moments within 1e-3 of
    their leaf's largest magnitude.  With compression a value on a
    rounding boundary flips a quantum, which feeds the residual and,
    through a block's changed maximum, the next steps' quanta of the
    whole block: params may then differ at 1 % of the elements, moments
    by 1e-2 of their scale, and a residual by one quantum (twice its
    largest magnitude)."""

    exact = jstate.ef_residual is None
    _mostly_close(state.params, jstate.params, TOL, PARAM_ATOL, 4 * lr_sum,
                  1e-3 if exact else 1e-2)
    for tree, jtree in ((state.opt.m, jstate.opt.m),
                        (state.opt.v, jstate.opt.v)):
        for g, w in _tree_pairs(tree, jtree):
            _scaled_close(g, w, 1e-3 if exact else 1e-2)
    assert int(state.opt.step) == int(jstate.opt.step)
    if exact:
        assert state.ef_residual is None
        return
    for g, w in _tree_pairs(state.ef_residual, jstate.ef_residual):
        _scaled_close(g, w, 2.01)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("compress", [False, True])
def test_train_steps_match_jax(steps, microbatches, compress):
    jcfg, cfg = _small()
    kw = dict(lr=3e-3, warmup=2, total_steps=10, microbatches=microbatches,
              compress_pod_grads=compress)
    jt, t = JT.TrainConfig(**kw), TrainConfig(**kw)
    japi, api = jax_build_model(jcfg), build_model(cfg)
    jstate = _jax_state(japi, jt)
    state = train_state_from_jax(_np(jstate), "cpu")
    jstep, step = jax.jit(JT.build_train_step(japi, jt)), \
        build_train_step(api, t)
    jdata, data = _data(jcfg, cfg)
    lr_sum = 0.0
    for i in range(steps):
        before = train_state_to_numpy(state)
        new, m = step(state, data.batch(i))
        jstate, jm = jstep(jstate, jdata.batch(i))
        # the step is pure: the state it was given is untouched
        _trees_close(state.params, before.params, 0, 0)
        _trees_close(state.opt.m, before.opt.m, 0, 0)
        state = new
        _close(m["loss"], jm["loss"])
        _close(m["grad_norm"], jm["grad_norm"])
        _close(m["lr"], jm["lr"], OPT_TOL, 0)
        lr_sum += float(m["lr"])
    _states_close(state, jstate, lr_sum)


def test_microbatches_match_one_batch():
    """The reference's own tolerance for accumulation: rel 2e-2 on the
    loss, 5e-2 on the params."""

    _, cfg = _small()
    api = build_model(cfg)
    data = SyntheticLM(cfg, ShapeSpec("t", 32, 8, "train"), device="cpu")
    out = []
    for m in (1, 4):
        t = TrainConfig(lr=3e-3, warmup=2, total_steps=10, microbatches=m)
        state = init_train_state(api, 0, t, device="cpu")
        out.append(build_train_step(api, t)(state, data.batch(0)))
    (s1, m1), (s4, m4) = out
    _close(m4["loss"], m1["loss"], 2e-2, 0)
    assert max(float((a - b).abs().max()) for a, b in zip(
        _leaves(s4.params), _leaves(s1.params))) < 5e-2


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree.detach().float()]


def test_init_train_state_from_a_generator():
    _, cfg = _small()
    api = build_model(cfg)
    g = torch.Generator().manual_seed(7)
    t = TrainConfig(compress_pod_grads=True)
    state = init_train_state(api, g, t, device="cpu")
    again = init_train_state(api, 7, t, device="cpu")
    _trees_close(state.params, _np(params_to_numpy(again.params)), 0, 0)
    assert state.opt.step.device.type == "cpu"
    assert all(r.dtype == torch.float32 for r in _leaves(state.ef_residual))
    assert init_train_state(api, 0, TrainConfig(), "cpu").ef_residual is None


# ---------------------------------------------------------------------------
# remat and each family's gradients
# ---------------------------------------------------------------------------


def _loss_grads_both(name, remat=None, seed=0, B=2, S=32):
    kw = {} if remat is None else {"remat": remat}
    jcfg, cfg = _small(name, **kw)
    japi, api = jax_build_model(jcfg), build_model(cfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      japi.init(jax.random.PRNGKey(seed)))
    if cfg.family == "vlm":    # the cross gate starts at 0: open it
        blk = jp["blocks"]
        cross = [k for k in blk if k.endswith("_cross")][0]
        blk[cross]["gate"] = jnp.full_like(blk[cross]["gate"], 0.5)
    jdata, data = _data(jcfg, cfg, B=B, S=S, seed=seed)
    jb = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if a.dtype == jnp.bfloat16 else a, jdata.batch(0))
    b = {k: v.float() if v.dtype == torch.bfloat16 else v
         for k, v in data.batch(0).items()}
    jloss, jg = jax.value_and_grad(japi.loss)(jp, jb)
    loss, g = value_and_grad(api, params_from_jax(_np(jp), "cpu"), b)
    return (loss, g), (jloss, jg)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_remat_modes_match_jax_and_each_other(remat):
    (loss, g), (jloss, jg) = _loss_grads_both("smollm-135m", remat)
    _close(loss, jloss)
    _trees_close(g, jg)
    (loss0, g0), _ = _loss_grads_both("smollm-135m", "none")
    assert float(loss) == float(loss0)
    for a, b in zip(_leaves(g), _leaves(g0)):
        _close(a, b, 1e-6, 1e-7)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recomputes_only_under_grad(remat, monkeypatch):
    """Serving (no grad) never checkpoints; a gradient does, once a
    block."""

    import repro_torch.models.transformer as T
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: (
        calls.append(k.get("context_fn")), real(*a, **k))[1])
    _, cfg = _small(remat=remat)
    api = build_model(cfg)
    params = api.init(0, "cpu")
    batch = SyntheticLM(cfg, ShapeSpec("t", 16, 2, "train"),
                        device="cpu").batch(0)
    with torch.no_grad():
        api.loss(params, batch)
    api.loss(params, batch)                  # nothing requires grad
    assert calls == []
    value_and_grad(api, params, batch)
    assert len(calls) == cfg.n_layers
    assert all((c is None) == (remat == "full") for c in calls)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_loss_and_grads_match_jax(name):
    (loss, g), (jloss, jg) = _loss_grads_both(name)
    assert np.isfinite(float(loss))
    _close(loss, jloss)
    _trees_close(g, jg)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["smollm-135m", "llama-3.2-vision-90b",
                                  "whisper-medium"])
@pytest.mark.parametrize("host", [0, 1])
def test_synthetic_batches_equal_jax(name, host):
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jd = JaxSyntheticLM(jcfg, JaxShapeSpec("t", 24, 4, "train"),
                        JaxDataConfig(seed=3), host_index=host, host_count=2)
    d = SyntheticLM(cfg, ShapeSpec("t", 24, 4, "train"), DataConfig(seed=3),
                    host_index=host, host_count=2, device="cpu")
    for i in (0, 1, 17):
        jb, b = jd.batch(i), d.batch(i)
        assert set(b) == set(jb)
        for k in jb:
            if k in ("tokens", "labels"):
                assert b[k].dtype == torch.int32
                np.testing.assert_array_equal(b[k].numpy(),
                                              np.asarray(jb[k]))
            else:
                assert b[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    b[k].view(torch.int16).numpy(),
                    np.asarray(jb[k]).view(np.int16))


def test_iterate_prefetches_from_the_cursor():
    _, cfg = _small()
    d = SyntheticLM(cfg, ShapeSpec("t", 16, 2, "train"), device="cpu")
    it = d.iterate(start=5, prefetch=2)
    got = [next(it) for _ in range(3)]
    it.close()
    for j, b in enumerate(got):
        assert torch.equal(b["tokens"], d.batch(5 + j)["tokens"])


# ---------------------------------------------------------------------------
# the supervised loop
# ---------------------------------------------------------------------------


def _inject(at):
    fail = {at}

    def inject(s):
        if s in fail:
            fail.clear()
            raise SimulatedFailure(f"injected at {s}")

    return inject


def _jax_inject(at):
    fail = {at}

    def inject(s):
        if s in fail:
            fail.clear()
            raise JL.SimulatedFailure(f"injected at {s}")

    return inject


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_run_training_with_a_failure_matches_jax(with_ckpt, tmp_path):
    jcfg, cfg = _small()
    kw = dict(lr=3e-3, warmup=2, total_steps=8)
    jt, t = JT.TrainConfig(**kw), TrainConfig(**kw)
    japi, api = jax_build_model(jcfg), build_model(cfg)
    jstate = _jax_state(japi, jt)
    state = train_state_from_jax(_np(jstate), "cpu")
    jdata, data = _data(jcfg, cfg)
    lk = dict(total_steps=8, ckpt_every=3, straggler_factor=1e9)
    jout, jh = JL.run_training(
        step_fn=jax.jit(JT.build_train_step(japi, jt)), init_state=jstate,
        batch_fn=jdata.batch, cfg=JL.LoopConfig(**lk),
        ckpt_dir=str(tmp_path / "jax") if with_ckpt else None,
        inject=_jax_inject(5))
    out, h = run_training(
        step_fn=build_train_step(api, t), init_state=state,
        batch_fn=data.batch, cfg=LoopConfig(**lk),
        ckpt_dir=str(tmp_path / "port") if with_ckpt else None,
        inject=_inject(5))
    assert h.restarts == jh.restarts == 1
    assert h.resumed_from == jh.resumed_from == ([3] if with_ckpt else [])
    assert len(h.losses) == len(jh.losses) == (10 if with_ckpt else 13)
    _close(h.losses, jh.losses)
    _states_close(out, jout, 8 * 3e-3)
    if with_ckpt:
        assert sorted(os.listdir(tmp_path / "port")) == \
            sorted(os.listdir(tmp_path / "jax"))


def test_run_training_resumes_and_redispatches_stragglers(tmp_path):
    _, cfg = _small()
    api = build_model(cfg)
    t = TrainConfig(lr=3e-3, warmup=2, total_steps=6)
    state = init_train_state(api, 0, t, device="cpu")
    data = SyntheticLM(cfg, ShapeSpec("t", 16, 4, "train"), device="cpu")
    step = build_train_step(api, t)
    lk = LoopConfig(total_steps=4, ckpt_every=2)
    _, h = run_training(step_fn=step, init_state=state, batch_fn=data.batch,
                        cfg=lk, ckpt_dir=str(tmp_path))
    # a second run resumes at the final checkpoint and runs the rest
    _, h2 = run_training(step_fn=step, init_state=state,
                         batch_fn=data.batch,
                         cfg=LoopConfig(total_steps=6, ckpt_every=2),
                         ckpt_dir=str(tmp_path))
    assert h2.resumed_from == [4] and len(h2.losses) == 2
    # a stalled step (after two timed ones) is re-dispatched: it stalls
    # ten times the longest step before it
    import time
    starts = []

    def stall(s):
        starts.append(time.perf_counter())
        if s == 3:
            time.sleep(10 * max(np.diff(starts)))

    _, h3 = run_training(step_fn=step, init_state=state, batch_fn=data.batch,
                         cfg=LoopConfig(total_steps=4, straggler_factor=3.0),
                         inject=stall)
    assert h3.straggler_events == [3] and h3.redispatched == 1
    assert h.losses[:4] == h3.losses[:4]


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _driver(module, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "port_cache.json"),
               REPRO_TUNE_CACHE=str(tmp_path / "jax_cache.json"))
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_launch_train_prints_the_reference_lines(tmp_path):
    args = ["--arch", "smollm-135m", "--preset", "smoke", "--steps", "6",
            "--batch", "4", "--seq", "32", "--tune", "--inject-failure", "3",
            "--ckpt-every", "2"]
    out = _driver("repro_torch.launch.train",
                  args + ["--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "port")], tmp_path)
    ref = _driver("repro.launch.train",
                  args + ["--ckpt-dir", str(tmp_path / "jax")], tmp_path)
    pats = [r"^\[tune\] config: microbatches=(\d+) remat=(\w+) "
            r"fsdp=(\w+) modeled step=[\d.]+ ms \(engine=grid, cache "
            r"tuned\)$",
            r"^\[inject\] simulated pod failure at step 3$",
            r"^steps=(\d+) wall=[\d.]+s mean_step=[\d.]+ms restarts=1 "
            r"stragglers=\d+$",
            r"^loss: first=[\d.]+ last=[\d.]+ min=[\d.]+$"]
    for text in (out, ref):
        lines = text.splitlines()
        for pat in pats:
            assert any(re.match(pat, ln) for ln in lines), (pat, text)
    steps = [re.search(r"^steps=(\d+)", t, re.M).group(1) for t in (out,
                                                                    ref)]
    assert steps == ["7", "7"]          # 3 + 4 after resuming at step 2
    # the pick is the machine model's for one device of the data sheet's
    # memory (the reference prices one v5e chip: other constants)
    cfg = get_config("smollm-135m").reduced()
    api = build_model(cfg)
    w = TPUWorkload(params=api.param_count(), active_params=api.param_count(),
                    layers=cfg.n_layers, d_model=cfg.d_model, seq=32,
                    global_batch=4, vocab=cfg.vocab)
    best, _, _ = tune_distributed(w, chips_per_pod=1)
    got = re.search(pats[0], out, re.M).groups()
    assert got == (str(best.microbatches), best.remat, str(best.fsdp))
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# flash attention has no backward, in either package
# ---------------------------------------------------------------------------


def _qkv(seed=0, shape=(1, 2, 128, 64)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_flash_under_grad_raises_in_both_packages():
    q, k, v = _qkv()
    with pytest.raises(AssertionError):
        jax.grad(lambda q: jnp.sum(_flash_call(
            q, jnp.asarray(k), jnp.asarray(v), causal=True, window=None,
            block_q=128, block_k=128, interpret=True)))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    before = flash_kernel.launches
    o = flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                        block_q=128, block_k=128)
    assert o.requires_grad and flash_kernel.launches == before  # CPU: plain
    with pytest.raises(RuntimeError, match="no backward"):
        o.sum().backward()


def test_flash_forward_without_grad_is_unchanged():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    with torch.no_grad():
        o = flash_attention(q, k, v, block_q=128, block_k=64)
    assert not o.requires_grad
    torch.testing.assert_close(o, attention_ref(q, k, v), rtol=0, atol=0)
    with torch.inference_mode():
        o2 = flash_attention(q, k, v, block_q=128, block_k=64)
    assert torch.equal(o, o2)


def test_loss_through_use_flash_raises_on_backward():
    _, cfg = _small(use_flash=True)
    api = build_model(cfg)
    params = api.init(0, "cpu")
    batch = SyntheticLM(cfg, ShapeSpec("t", 128, 1, "train"),
                        device="cpu").batch(0)
    with pytest.raises(RuntimeError, match="no backward"):
        value_and_grad(api, params, batch)
    # a sequence the gate refuses takes the plain math and trains
    batch = SyntheticLM(cfg, ShapeSpec("t", 96, 1, "train"),
                        device="cpu").batch(0)
    loss, g = value_and_grad(api, params, batch)
    assert torch.isfinite(loss) and float(O.global_norm(g)) > 0
