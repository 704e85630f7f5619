"""The port's logical-axis sharding against the JAX package's: rules
tables, ``rules_for_arch``, and ``arg_sharding`` / ``shard_like`` over
every architecture's full-size parameter tree on the production meshes
(16 × 16 and 2 × 16 × 16), the reference's specs dumped as JSON by a
subprocess with 512 host devices (as its own ``tests/test_dryrun.py``
runs); the spec-to-placements helper and ``logical_constraint`` without
a mesh.  The port resolves specs on an ``AbstractMesh`` (no process
group)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.distribute.sharding import Rules as JaxRules  # noqa: E402
from repro.distribute.sharding import default_rules as jax_default_rules  # noqa: E402
from repro.launch.cells import rules_for_arch as jax_rules_for_arch  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distribute import sharding as S  # noqa: E402
from repro_torch.launch.cells import rules_for_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

REF_SCRIPT = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import ARCHS, get_config
from repro.distribute.sharding import shard_like
from repro.launch.cells import rules_for_arch
from repro.models import build_model

def norm(e):
    return list(e) if isinstance(e, tuple) else e

out = {}
devs = np.asarray(jax.devices())
for name, shape, axes in [("16x16", (16, 16), ("data", "model")),
                          ("2x16x16", (2, 16, 16), ("pod", "data", "model"))]:
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        api = build_model(cfg)
        rules = rules_for_arch(cfg, multi_pod=len(shape) == 3)
        sh = shard_like(api.abstract(), api.axes(), mesh, rules)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            sh, is_leaf=lambda x: hasattr(x, "spec"))
        out[f"{name}/{arch}"] = {
            "/".join(str(k.key) for k in path): [norm(e) for e in s.spec]
            for path, s in flat}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(path.read_text())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _norm(spec):
    """A spec (PartitionSpec entries) as JSON-like lists."""

    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_rules_spec_and_defaults_match_the_reference():
    for mp in (False, True):
        assert S.default_rules(mp).table == jax_default_rules(mp).table
    r = S.Rules.make(batch=("data",), embed=("data",), mlp="model")
    jr = JaxRules.make(batch=("data",), embed=("data",), mlp="model")
    for axes in [("batch", "seq", "embed"), ("embed", "mlp"),
                 ("mlp", "batch", None), ()]:
        assert r.spec(axes) == tuple(jr.spec(axes))
    assert r.replace(seq="model").table == jr.replace(seq="model").table
    assert r.get(None) is None and r.get("mlp") == "model"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_for_arch_match_the_reference(arch):
    from repro.configs import get_config as jax_get_config
    for mp in (False, True):
        got = rules_for_arch(get_config(arch), multi_pod=mp,
                             overrides={"seq": "model"} if mp else None)
        want = jax_rules_for_arch(jax_get_config(arch), multi_pod=mp,
                                  overrides={"seq": "model"} if mp
                                  else None)
        assert got.table == want.table
    if arch == "mixtral-8x22b":
        assert got.get("experts") is None and got.get("expert_mlp") == "model"
    if arch == "llama4-maverick-400b-a17b":
        assert got.get("experts") == "model"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shard_like_full_size_params_match_the_reference(arch, mesh_name,
                                                         ref_specs):
    shape, names = MESHES[mesh_name]
    mesh = S.AbstractMesh(shape, names)
    cfg = get_config(arch)
    api = build_model(cfg)
    rules = rules_for_arch(cfg, multi_pod=len(shape) == 3)
    sh = S.shard_like(api.abstract(), api.axes(), mesh, rules)
    got = {k: _norm(v.spec) for k, v in _flat(sh).items()}
    assert got == ref_specs[f"{mesh_name}/{arch}"]
    # the meta stand-ins allocate nothing
    assert all(t.device.type == "meta" for t in _flat(api.abstract()).values())


def test_arg_sharding_divisibility_and_model_fallback():
    mesh = S.AbstractMesh((16, 16), ("data", "model"))
    r = S.default_rules()
    # 20 heads on a 16-way model axis: the embed dim keeps "data", no
    # other fallback divides, so the weight stays unsharded on "model"
    assert S.arg_sharding((2560, 20, 128), ("embed", "heads", None), mesh,
                          r).spec == ("data", None, None)
    assert S.arg_sharding((4096, 32, 128), ("embed", "heads", None), mesh,
                          r).spec == ("data", "model", None)
    # a non-divisible vocab falls back to "model" on the first divisible
    # FALLBACK dim left unsharded
    assert S.arg_sharding((32001, 1600), ("vocab", None), mesh,
                          r).spec == (None, None)
    assert S.arg_sharding((32001, 1600), ("vocab", "heads"), mesh,
                          r).spec == (None, "model")


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = S.AbstractMesh((2, 4, 4), ("pod", "data", "model"))
    assert S.spec_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert S.spec_placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    # a mesh dim of size 1 shards nothing
    one = S.AbstractMesh((1, 4), ("data", "model"))
    assert S.spec_placements(("data", "model"), one) == (Replicate(),
                                                          Shard(1))
    with pytest.raises(ValueError):
        S.spec_placements((("data", "pod"),), mesh)
    assert S.NamedSharding(mesh, ("data",)).placements == (
        Replicate(), Shard(0), Replicate())


def test_logical_constraint_without_a_mesh_is_the_identity():
    x = torch.ones(2, 3)
    assert S.current_ctx() is None
    assert S.logical_constraint(x, "batch", "embed") is x
    assert S.gather_fsdp(x) is x
    assert S.named_sharding(("batch",)) is None
    # a mesh context with a plain tensor: still the tensor itself
    with S.use_mesh(S.AbstractMesh((2, 2), ("data", "model")),
                    S.default_rules()):
        assert S.logical_constraint(x, "batch", "embed") is x
        assert S.current_ctx().rules == S.default_rules()
    assert S.current_ctx() is None


def test_tree_shardings_and_the_package_exports():
    import repro.distribute as JD
    import repro_torch.distribute as TD
    assert sorted(TD.__all__) == sorted(JD.__all__)
    mesh = S.AbstractMesh((16, 16), ("data", "model"))
    sh = S.tree_shardings({"a": ("batch", "seq"), "b": {"c": ("mlp",)}},
                          mesh, S.default_rules())
    assert sh["a"].spec == ("data", None) and sh["b"]["c"].spec == ("model",)
