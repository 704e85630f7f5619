"""The port's checkpoints against the JAX package's, on the CPU: the same
on-disk format both ways (a checkpoint written by ``repro`` restored by
the port and the reverse, every leaf bit for bit, bf16 included, and the
next train step from it equal), the same manifest, and the manager's
async save, retention, restore of an earlier step and errors.

States come from the JAX package's ``init`` of the reduced smollm-135m;
batches from both packages' ``SyntheticLM`` (equal tokens).  Tolerance
of the next step: 1e-4 on the loss, params within 1e-5 but where an Adam
step of a near-zero gradient moved them (f32; see test_torch_train.py).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as JS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShapeSpec  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.runtime import train as JT  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    available_steps, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.interop import train_state_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.runtime import (TrainConfig, TrainState,  # noqa: E402
                                 build_train_step, init_train_state)
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402

TOL = 1e-4
PARAM_ATOL = 1e-5
LR = dict(lr=3e-3, warmup=2, total_steps=10)


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(dtype, compress=False):
    jcfg = jax_get_config("smollm-135m").reduced().replace(
        logits_dtype="float32")
    cfg = get_config("smollm-135m").reduced().replace(logits_dtype="float32")
    japi, api = jax_build_model(jcfg), build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(dtype),
                          japi.init(jax.random.PRNGKey(1)))
    opt = jax_adamw_init(params)
    # non-zero moments and step, so a mixed-up leaf shows
    rng = np.random.default_rng(0)
    noise = lambda p: jnp.asarray(rng.random(p.shape) * 1e-3, jnp.float32)
    opt = opt._replace(step=jnp.asarray(4, jnp.int32),
                       m=jax.tree.map(noise, opt.m),
                       v=jax.tree.map(noise, opt.v))
    residual = jax.tree.map(noise, params) if compress else None
    jstate = JT.TrainState(params, opt, residual)
    tcfg = TrainConfig(compress_pod_grads=compress, **LR)
    template = init_train_state(api, 5, tcfg, device="cpu")
    return japi, api, jcfg, cfg, jstate, template, tcfg


def _bits(x) -> np.ndarray:
    """A leaf's raw values: bf16 as its 16 bits, else as it is."""

    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _pairs(state, jstate):
    """(key, port leaf, JAX leaf) for every leaf, by the checkpoint key."""

    from repro_torch.checkpoint.store import _flatten_with_paths
    got = dict(_flatten_with_paths(state))
    want = dict(JS._flatten_with_paths(jstate))
    assert set(got) == set(want)
    return [(k, got[k], want[k]) for k in sorted(want)]


def _assert_bit_equal(state, jstate):
    for key, g, w in _pairs(state, jstate):
        assert tuple(g.shape) == tuple(np.shape(w)), key
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)


def _next_step_equal(japi, api, jcfg, cfg, jstate, state, tcfg):
    jt = JT.TrainConfig(compress_pod_grads=tcfg.compress_pod_grads, **LR)
    jb = JaxSyntheticLM(jcfg, JaxShapeSpec("t", 32, 4, "train")).batch(0)
    b = SyntheticLM(cfg, ShapeSpec("t", 32, 4, "train"),
                    device="cpu").batch(0)
    jnew, jm = jax.jit(JT.build_train_step(japi, jt))(jstate, jb)
    new, m = build_train_step(api, tcfg)(state, b)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=TOL)
    n_out = n = 0
    for key, g, w in _pairs(new.params, jnew.params):
        err = np.abs(g.detach().float().numpy() - np.asarray(w, np.float32))
        n += err.size
        n_out += int(np.sum(err > PARAM_ATOL + TOL * np.abs(np.asarray(w))))
        assert err.max() <= 4 * LR["lr"], key
    assert n_out <= max(1, n // 1000)
    assert int(new.opt.step) == int(jnew.opt.step) == 5


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype,
                                                   compress):
    japi, api, jcfg, cfg, jstate, template, tcfg = _setup(
        getattr(jnp, dtype), compress)
    JS.save_checkpoint(str(tmp_path), 4, jstate)
    state, manifest = load_checkpoint(str(tmp_path), template)
    assert manifest["step"] == 4 and isinstance(state, TrainState)
    assert isinstance(state.opt, OptState)
    assert state.params["embed"].dtype == getattr(torch, dtype)
    assert state.opt.step.shape == () and state.opt.step.dtype == torch.int32
    _assert_bit_equal(state, jstate)
    if dtype == "float32":
        _next_step_equal(japi, api, jcfg, cfg, jstate, state, tcfg)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype,
                                                   compress):
    japi, api, jcfg, cfg, jstate, template, tcfg = _setup(
        getattr(jnp, dtype), compress)
    state = train_state_from_jax(_np(jstate), "cpu")
    save_checkpoint(str(tmp_path), 4, state)
    restored, manifest = JS.load_checkpoint(str(tmp_path), jstate)
    assert manifest["step"] == 4
    assert restored.params["embed"].dtype.name == dtype
    _assert_bit_equal(state, restored)
    if dtype == "float32":
        jrestored = jax.tree.map(jnp.asarray, restored)
        _next_step_equal(japi, api, jcfg, cfg, jrestored, state, tcfg)


def test_manifests_match_the_reference(tmp_path):
    *_, jstate, _, _ = _setup(jnp.bfloat16, compress=True)
    JS.save_checkpoint(str(tmp_path / "jax"), 7, jstate, extra={"a": 1})
    save_checkpoint(str(tmp_path / "port"), 7,
                    train_state_from_jax(_np(jstate), "cpu"),
                    extra={"a": 1})
    docs = [json.loads((tmp_path / p / "step_00000007" /
                        "manifest.json").read_text()) for p in ("port",
                                                                "jax")]
    for d in docs:
        d.pop("time")
    assert docs[0] == docs[1]
    keys = [e["key"] for e in docs[0]["keys"]]
    assert "params/blocks/0_dense/attn/wq" in keys
    assert {"opt/step", "opt/m/embed", "ef_residual/embed"} <= set(keys)
    assert sorted(os.listdir(tmp_path / "port" / "step_00000007")) == \
        sorted(os.listdir(tmp_path / "jax" / "step_00000007"))


def test_manager_saves_async_keeps_the_newest_and_restores(tmp_path):
    *_, template, _ = _setup(jnp.float32)
    mgr = CheckpointManager(str(tmp_path), keep=2, save_interval=3)
    assert [s for s in range(10) if mgr.should_save(s)] == [3, 6, 9]
    assert mgr.latest_step() is None
    states = {}
    for step in (3, 6, 9):
        states[step] = template._replace(
            opt=template.opt._replace(step=torch.tensor(step,
                                                        dtype=torch.int32)))
        mgr.save(step, states[step])          # async, one in flight
    mgr.wait()
    assert available_steps(str(tmp_path)) == [6, 9]
    assert mgr.latest_step() == 9
    # a leftover temporary directory is not a checkpoint
    os.makedirs(tmp_path / "step_00000012.tmp")
    assert mgr.latest_step() == 9
    got, manifest = mgr.restore(template, step=6)
    assert manifest["step"] == 6 and int(got.opt.step) == 6
    seen = []
    got, _ = mgr.restore(template, sharding_fn=lambda k: (seen.append(k),
                                                          "cpu")[1])
    assert int(got.opt.step) == 9 and "opt/step" in seen
    _assert_bit_equal(got.params, template.params)


def test_manager_snapshot_is_taken_at_save(tmp_path):
    """The async save writes the values the tree held when ``save`` was
    called, whatever the caller does to it afterwards."""

    *_, template, _ = _setup(jnp.float32)
    mgr = CheckpointManager(str(tmp_path))
    want = template.params["embed"].clone()
    mgr.save(1, template)
    template.params["embed"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(template)
    assert torch.equal(got.params["embed"], want)


def test_errors(tmp_path):
    *_, template, _ = _setup(jnp.float32)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), template)
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path), {"w": torch.zeros(4, 3)})
    # a failed async save surfaces on the next wait
    (tmp_path / "file").write_text("")
    mgr = CheckpointManager(str(tmp_path / "file"))
    mgr.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()


def test_dtensor_checkpoints_cross_both_ways_on_a_2x2_mesh(tmp_path):
    """A reference checkpoint restores onto a (2, 2) gloo mesh through
    ``sharding_fn`` (placements of ``shard_like``), bit for bit; a tree
    of DTensors saved by the port loads in ``repro.checkpoint`` as full
    arrays, bit for bit."""

    from _torch_dist_workers import run as run_helper

    rng = np.random.default_rng(5)
    ref = {"w": rng.standard_normal((8, 12)).astype(np.float32),
           "b": rng.standard_normal(12).astype(np.float32),
           "s": np.asarray(3, np.int32)}
    JS.save_checkpoint(str(tmp_path / "ref"), 2,
                       {k: jnp.asarray(v) for k, v in ref.items()})
    res = run_helper("ckpt", tmp_path / "run", tmp_path / "ref")
    # w: embed over "data", mlp over "model"; b: mlp; s replicated
    assert res["placements"] == {"w": "(Shard(dim=0), Shard(dim=1))",
                                 "b": "(Replicate(), Shard(dim=0))",
                                 "s": "(Replicate(), Replicate())"}
    assert res["local_w"] == [4, 6]
    got = np.load(tmp_path / "run" / "ckpt.npz")
    for k, v in ref.items():
        np.testing.assert_array_equal(got[f"restored_{k}"], v)

    template = {"w": jnp.zeros((8, 12), jnp.bfloat16),
                "b": jnp.zeros(12, jnp.float32)}
    tree, manifest = JS.load_checkpoint(str(tmp_path / "run" / "port_ckpt"),
                                        template)
    assert manifest["step"] == 7
    np.testing.assert_array_equal(
        np.asarray(tree["w"], np.float32), got["saved_w"])
    np.testing.assert_array_equal(np.asarray(tree["b"]), got["saved_b"])
