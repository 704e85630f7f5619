"""GPipe over a "pp" axis of four CPU gloo ranks: the reference's
tests/test_pipeline.py case (P = 4, M = 8, B = 16, D = 32, ``tanh(a @
W)`` stages).  The port's output must be within 1e-5 of the sequential
math and its gradients (``loss.backward()`` on every rank, each stage's
rows summed over the ranks) within 1e-4; the reference's ``gpipe`` in
its 4-device subprocess must give the same numbers, to the same
tolerances."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist_workers import SRC  # noqa: E402
from _torch_dist_workers import run as run_helper  # noqa: E402

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distribute.pipeline import gpipe

d = np.load(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()).reshape(4), ("pp",))
Ws, x = jnp.asarray(d["w"]), jnp.asarray(d["x"])
stage = lambda w, a: jnp.tanh(a @ w[0])
loss = lambda Ws: jnp.sum(gpipe(stage, Ws, x, mesh=mesh, microbatches=8) ** 2)
out = gpipe(stage, Ws, x, mesh=mesh, microbatches=8)
np.savez(sys.argv[2], out=np.asarray(out), grad=np.asarray(jax.grad(loss)(Ws)))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe")
    run_helper("pipeline", out)
    return dict(np.load(out / "pipeline.npz")), out


def test_gpipe_matches_the_sequential_stack(port):
    d, _ = port
    W = torch.from_numpy(d["w"]).requires_grad_()
    a = torch.from_numpy(d["x"])
    for i in range(W.shape[0]):
        a = torch.tanh(a @ W[i])
    (a * a).sum().backward()
    assert np.max(np.abs(d["out"] - a.detach().numpy())) < 1e-5
    assert np.max(np.abs(d["grad"] - W.grad.numpy())) < 1e-4


def test_gpipe_matches_the_references(port, tmp_path):
    d, out = port
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF,
                           str(out / "pipeline.npz"), str(tmp_path / "r.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "r.npz")
    assert np.max(np.abs(d["out"] - ref["out"])) < 1e-5
    assert np.max(np.abs(d["grad"] - ref["grad"])) < 1e-4
