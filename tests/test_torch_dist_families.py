"""The port's six non-dense families on four CPU gloo ranks (the
``families`` scenario of ``tests/_torch_dist_workers.py``, one spawn for
all), each ``.reduced()`` with f32 params from seed 0, placed by
``shard_like`` under ``use_mesh(mesh, rules_for_arch(cfg))`` on a (2, 2)
``data × model`` mesh, against the port's unsharded run from the same
params:

* ``forward`` on the family's inputs (tokens; frames for whisper, image
  embeddings for the vlm), and a ``use_flash`` forward at S = 128 through
  the flash kernel's ``local_map`` region (its plain version on CPU
  shards; windowed for hymba and mixtral): 1e-5 absolute on logits of
  scale ~2;
* ``decode_step`` at per-slot positions over a non-zero state (KV rings,
  SSM state and conv ring, the vlm's cross K/V, whisper's cross K/V from
  ``encode_cross_kv``, itself held to the unsharded): 1e-5 absolute on
  the logits and on every leaf of the written state;
* one ``build_train_step`` step: the loss within 1e-5 relative, the
  gradients within 1e-5 absolute, the params after the step within 1e-4
  absolute.  The step is AdamW's first, which moves an element by
  lr·g/(|g| + eps): where a gradient is within a few eps (1e-8) of 0 it
  scales the f32 rounding of a reordered sum by up to lr/eps, so the
  params carry differences of a few 1e-5 (4.4e-5 on the vlm) while the
  gradients agree to 5.4e-6;
* the MoE families again with capacity factor 16 (no pair dropped).
  Capacity is per batch row, so sharding the batch cannot change which
  pairs are dropped; only a router logit within rounding of a top-k tie
  could, and none is at these inputs;
* hymba with SSM head counts the model axis does not divide: 6 heads on a
  (1, 4) mesh, 5 on the (2, 2) mesh (forward, decode, step).

Then the reference: its sharded ``forward`` on a (2, 2) host mesh of
four XLA CPU devices, in a subprocess, from the same params and inputs:
the port's sharded logits within rtol/atol 1e-4 (the cross-package
tolerance of tests/test_torch_families.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist_workers import FAMILY_ARCHS  # noqa: E402
from _torch_dist_workers import run as run_helper  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = 1e-5
STEP_TOL = 1e-4
REF_TOL = 1e-4
MOE = ("mixtral-8x22b", "llama4-maverick-400b-a17b")
DUMPS = FAMILY_ARCHS + tuple(f"{a}/nodrop" for a in MOE)

REF_FORWARD = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distribute.sharding import shard_like, use_mesh
from repro.launch.cells import batch_axes, rules_for_arch
from repro.models import build_model

folder, names = sys.argv[1], sys.argv[2:]
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for name in names:
    arch, _, variant = name.partition("/")
    cfg = get_config(arch).reduced().replace(logits_dtype="float32")
    if variant == "nodrop":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=16.0))
    flat = dict(np.load(os.path.join(folder, name.replace("/", "-")
                                     + ".npz")))
    params = {}
    for k, v in flat.items():
        if k.startswith("params/"):
            node, parts = params, k[len("params/"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v, jnp.float32)
    batch = {k[3:]: jnp.asarray(v) for k, v in flat.items()
             if k.startswith("in/")}
    api = build_model(cfg)
    rules = rules_for_arch(cfg)
    axes = batch_axes(cfg, None)
    with use_mesh(mesh, rules):
        params = jax.tree.map(jax.device_put, params,
                              shard_like(params, api.axes(), mesh, rules))
        batch = jax.tree.map(jax.device_put, batch, shard_like(
            batch, {k: axes[k] for k in batch}, mesh, rules))
        out[name] = np.asarray(jax.jit(api.forward)(params, batch))
np.savez(os.path.join(folder, "ref.npz"), **out)
"""


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    out = tmp_path_factory.mktemp("families")
    return run_helper("families", out, timeout=900), out


@pytest.fixture(scope="module")
def reference(families):
    _, out = families
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_FORWARD, str(out),
                           *DUMPS], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out / "ref.npz"))


def _held(r: dict, *, train: bool) -> None:
    assert r["forward_scale"] > 0.1 and r["decode_scale"] > 0.1
    assert r["forward_err"] < TOL, r
    assert r["decode_err"] < TOL, r
    assert r["decode_state_err"] < TOL, r
    if "flash_err" in r:
        assert r["flash_err"] < TOL, r
    if "cross_kv_err" in r:
        assert r["cross_kv_err"] < TOL, r
    if train:
        np.testing.assert_allclose(r["loss"], r["loss_plain"], rtol=TOL)
        assert r["grad_err"] < TOL, r
        assert r["step_err"] < STEP_TOL, r


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_and_decode_on_a_2x2_mesh_equal_the_unsharded(families,
                                                              arch):
    res, _ = families
    r = res[arch]
    _held(r, train=False)
    # every family with attention went through the flash region
    assert ("flash_err" in r) == (arch != "mamba2-2.7b")
    assert ("cross_kv_err" in r) == (arch == "whisper-medium")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_on_a_2x2_mesh_equals_the_unsharded(families, arch):
    res, _ = families
    _held(res[arch], train=True)


@pytest.mark.parametrize("arch", MOE)
def test_moe_without_drops_on_a_2x2_mesh(families, arch):
    res, _ = families
    _held(res[f"{arch}/nodrop"], train=False)


@pytest.mark.parametrize("case", ["heads6", "heads5"])
def test_hymba_ssm_heads_the_model_axis_does_not_divide(families, case):
    """6 SSM heads on a 4-way model axis, 5 on a 2-way one: the head
    split and merge leave the channels whole on it."""

    res, _ = families
    _held(res[f"hymba-1.5b/{case}"], train=True)


@pytest.mark.parametrize("name", DUMPS)
def test_sharded_logits_equal_the_references_sharded_forward(
        families, reference, name):
    _, out = families
    got = np.load(out / (name.replace("/", "-") + ".npz"))["logits"]
    want = reference[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REF_TOL, atol=REF_TOL)
