"""The port's sharded paths on four CPU gloo ranks (spawned by
``tests/_torch_dist_workers.py``, ``file://`` init under ``tmp_path``):

* smollm-135m ``.reduced()`` in f32, ``build_train_step`` on a (2, 2)
  mesh with state and batch placed by ``shard_like``, against the port's
  unsharded step (params after a step within 1e-5 absolute, losses
  within 1e-5 relative: f32 sums in another order) and against the
  reference's sharded step on a (2, 2) host mesh in a subprocess (loss
  1e-4 relative, params 1e-5 absolute, as tests/test_torch_train.py);
* qwen1.5-4b ``.reduced()`` ``forward`` and ``decode_step`` (per-slot
  positions) on the same mesh against the unsharded ones (1e-5 absolute
  on logits of scale ~2, and on the written K/V);
* the elastic rescale of tests/test_elastic.py: 4 steps on (2, 2), a
  checkpoint, a restore onto (1, 4), 4 more steps; the losses continue
  and equal the unsharded run's (1e-5 relative).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist_workers import run as run_helper  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

REF_STEP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.data import SyntheticLM
from repro.distribute.sharding import default_rules, shard_like, use_mesh
from repro.models import build_model
from repro.optim.adamw import OptState
from repro.runtime.train import TrainConfig, TrainState, build_train_step

cfg = get_config("smollm-135m").reduced()
api = build_model(cfg)
tcfg = TrainConfig(lr=3e-3, warmup=2, total_steps=20)
flat = dict(np.load(sys.argv[1]))

def tree(prefix):
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node, parts = out, k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v, jnp.float32)
    return out

state = TrainState(params=tree("params"),
                   opt=OptState(step=jnp.asarray(flat["opt/step"], jnp.int32),
                                m=tree("opt/m"), v=tree("opt/v")),
                   ef_residual=None)
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
rules = default_rules()
ax = api.axes()
st_ax = TrainState(params=ax, opt=OptState(step=(), m=ax, v=ax),
                   ef_residual=None)
batch = SyntheticLM(cfg, ShapeSpec("t", 32, 8, "train")).batch(0)
with use_mesh(mesh, rules):
    sh = shard_like(state, st_ax, mesh, rules)
    state = jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)
    new, m = jax.jit(build_train_step(api, tcfg))(state, batch)
out = {"loss": np.asarray(m["loss"])}
for path, leaf in jax.tree_util.tree_flatten_with_path(new.params)[0]:
    out["params/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    return run_helper("sharded", out), out


def test_train_step_on_a_2x2_mesh_equals_the_unsharded_step(sharded):
    res, _ = sharded
    assert res["step1_err"] < 1e-5, res["step1_err"]
    np.testing.assert_allclose(res["losses"][:1], res["losses_plain"][:1],
                               rtol=1e-5)
    # the 2-D weights are sharded on both mesh axes
    assert res["placements"]["wq"] == "(Shard(dim=1), Shard(dim=2))"


def test_train_step_on_a_2x2_mesh_equals_the_references(sharded, tmp_path):
    res, out = sharded
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_STEP,
                           str(out / "state0.npz"), str(tmp_path / "ref.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(tmp_path / "ref.npz"))
    port = dict(np.load(out / "step1.npz"))
    np.testing.assert_allclose(res["losses"][0], float(ref["loss"]),
                               rtol=1e-4)
    keys = [k for k in ref if k.startswith("params/")]
    assert keys and all(k in port for k in keys)
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], atol=1e-5, err_msg=k)


def test_forward_and_decode_on_a_2x2_mesh_equal_the_unsharded(sharded):
    res, _ = sharded
    assert res["forward_scale"] > 0.1
    assert res["forward_err"] < 1e-5, res["forward_err"]
    assert res["decode_err"] < 1e-5, res["decode_err"]
    assert res["decode_kv_err"] < 1e-5, res["decode_kv_err"]
    assert "Shard" in res["qwen_wq_placements"]


def test_elastic_rescale_continues_the_unsharded_losses(sharded):
    res, _ = sharded
    assert res["restored_step"] == 4
    # restored onto (1, 4): no data axis, a 4-way model axis
    assert res["restored_placements"] == "(Replicate(), Shard(dim=2))"
    losses, plain = res["losses"], res["losses_plain"]
    assert len(losses) == len(plain) == 8
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, plain, rtol=1e-5)
    assert losses[4] < losses[0] * 1.25
