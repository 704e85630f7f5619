"""Multi-rank scenarios of the port on CPU gloo ranks, for
``tests/test_torch_distributed.py``, ``test_torch_pipeline.py`` and
``test_torch_checkpoint.py``.  Imports torch and ``repro_torch`` only.

  python tests/_torch_dist_workers.py SCENARIO OUT_DIR [ARGS...]

spawns 4 ranks (``file://`` init under OUT_DIR), runs the scenario and
has rank 0 write ``OUT_DIR/result.json`` (and ``.npz`` files where the
scenario says)."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _tree_np(tree, prefix=""):
    """Flat {path: array} of a nested dict / NamedTuple of tensors (full
    values of DTensors)."""

    from torch.distributed.tensor import DTensor
    out = {}
    if tree is None:
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.full_tensor() if isinstance(tree, DTensor) else tree
        out[prefix] = t.detach().float().numpy()
        return out
    items = (tree._asdict().items() if hasattr(tree, "_fields")
             else tree.items())
    for k, v in items:
        out.update(_tree_np(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _f32(tree):
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: t.float(), tree)


def _state_axes(api, tcfg):
    from repro_torch.optim.adamw import OptState
    from repro_torch.runtime.train import TrainState
    ax = api.axes()
    return TrainState(params=ax, opt=OptState(step=(), m=ax, v=ax),
                      ef_residual=None)


def _place_state(state, api, tcfg, mesh, rules):
    from repro_torch.distribute.sharding import place, shard_like
    return place(state, shard_like(state, _state_axes(api, tcfg), mesh,
                                   rules))


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def sharded(rank: int, out: str) -> dict:
    """smollm-135m .reduced() train steps and qwen1.5-4b .reduced()
    forward / decode_step on a (2, 2) mesh against the unsharded ones,
    then the elastic rescale onto (1, 4)."""

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.distribute.sharding import (default_rules, place,
                                                 shard_like, use_mesh)
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import (TrainConfig, build_train_step,
                                     init_train_state)

    res: dict = {}
    rules = default_rules()
    mesh = make_smoke_mesh((2, 2))

    # -- train: one step, then the elastic run ---------------------------
    cfg = get_config("smollm-135m").reduced()
    api = build_model(cfg)
    tcfg = TrainConfig(lr=3e-3, warmup=2, total_steps=20)
    data = SyntheticLM(cfg, ShapeSpec("t", 32, 8, "train"), device="cpu")
    state0 = init_train_state(api, 0, tcfg, device="cpu")
    state0 = state0._replace(params=_f32(state0.params))
    step = build_train_step(api, tcfg)

    plain, losses_plain = state0, []
    for i in range(8):
        plain, m = step(plain, data.batch(i))
        losses_plain.append(float(m["loss"]))
        if i == 0:
            first_plain = _tree_np(plain)

    batch_axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    losses = []
    with use_mesh(mesh, rules):
        st = _place_state(state0, api, tcfg, mesh, rules)
        for i in range(4):
            b = data.batch(i)
            b = place(b, shard_like(b, batch_axes, mesh, rules))
            st, m = step(st, b)
            losses.append(float(m["loss"]))
            if i == 0:
                first_sharded = _tree_np(st)
        placements = {k: str(v.placements) for k, v in
                      st.params["blocks"]["0_dense"]["attn"].items()}
        ckpt = os.path.join(out, "elastic")
        save_checkpoint(ckpt, 4, st)

    mesh2 = make_smoke_mesh((1, 4))
    with use_mesh(mesh2, rules):
        template = _place_state(state0, api, tcfg, mesh2, rules)
        st2, manifest = load_checkpoint(ckpt, template)
        res["restored_step"] = manifest["step"]
        res["restored_placements"] = str(
            st2.params["blocks"]["0_dense"]["ffn"]["wg"].placements)
        for i in range(4, 8):
            b = data.batch(i)
            b = place(b, shard_like(b, batch_axes, mesh2, rules))
            st2, m = step(st2, b)
            losses.append(float(m["loss"]))
    res["losses"], res["losses_plain"] = losses, losses_plain
    res["placements"] = placements
    res["step1_err"] = max(float(np.max(np.abs(first_sharded[k] -
                                                first_plain[k])))
                           for k in first_plain)
    if rank == 0:
        np.savez(os.path.join(out, "state0.npz"), **_tree_np(state0))
        np.savez(os.path.join(out, "step1.npz"), **first_sharded)

    # -- serving: forward and decode_step --------------------------------
    qcfg = get_config("qwen1.5-4b").reduced()
    qapi = build_model(qcfg)
    qp = _f32(qapi.init(1, device="cpu"))
    g = torch.Generator().manual_seed(2)
    B, S, C = 4, 16, 32
    tokens = torch.randint(0, qcfg.vocab, (B, S), generator=g,
                           dtype=torch.int32)
    want = qapi.forward(qp, {"tokens": tokens})
    st_plain = qapi.init_decode_state(B, C, dtype=torch.float32,
                                      device="cpu")
    tok1 = tokens[:, :1]
    cur = torch.tensor([3, 0, 7, 5])
    # fill some cache rows so the decode reads non-zero history
    for t in range(3):
        qapi.decode_step(qp, st_plain, tokens[:, t:t + 1], t)
    dspecs = qapi.decode_state_specs(B, C, dtype=torch.float32)
    from repro_torch.models.common import axes_tree, tree_map
    st_copy = tree_map(lambda t: t.clone(), st_plain)
    want_dec, _ = qapi.decode_step(qp, st_plain, tok1, cur)
    with use_mesh(mesh, rules):
        pq = place(qp, shard_like(qp, qapi.axes(), mesh, rules))
        tk = place(tokens, shard_like(tokens, ("batch", "seq"), mesh,
                                      rules))
        got = qapi.forward(pq, {"tokens": tk}).full_tensor()
        sd = place(st_copy, shard_like(st_copy, axes_tree(dspecs), mesh,
                                       rules))
        t1 = place(tok1, shard_like(tok1, ("batch", None), mesh, rules))
        c1 = place(cur, shard_like(cur, ("batch",), mesh, rules))
        got_dec, sd = qapi.decode_step(pq, sd, t1, c1)
        got_dec = got_dec.full_tensor()
        kv_err = max(float((sd["blocks"]["0_dense"]["kv"][n].full_tensor()
                            - st_plain["blocks"]["0_dense"]["kv"][n]
                            ).abs().max()) for n in ("k", "v"))
    res["forward_err"] = float((got - want).abs().max())
    res["forward_scale"] = float(want.abs().max())
    res["decode_err"] = float((got_dec - want_dec).abs().max())
    res["decode_kv_err"] = kv_err
    res["qwen_wq_placements"] = str(
        pq["blocks"]["0_dense"]["attn"]["wq"].placements)
    return res


def pipeline(rank: int, out: str) -> dict:
    """The reference's GPipe case over 4 ranks: P = 4, M = 8, B = 16,
    D = 32, ``tanh(a @ W)`` stages."""

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distribute.pipeline import gpipe

    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("pp",))
    P_, M, B, D = 4, 8, 16, 32
    rng = np.random.default_rng(0)
    w_np = (rng.standard_normal((P_, D, D)) * 0.2).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    Ws = torch.from_numpy(w_np).requires_grad_()
    stage = lambda w, a: torch.tanh(a @ w[0])
    o = gpipe(stage, Ws, x, mesh=mesh, microbatches=M)
    (o * o).sum().backward()
    g = Ws.grad.clone()          # this stage's rows
    dist.all_reduce(g)
    if rank == 0:
        np.savez(os.path.join(out, "pipeline.npz"), out=o.detach().numpy(),
                 grad=g.numpy(), w=w_np, x=x.numpy())
    return {"ok": True}


def ckpt(rank: int, out: str, ref_dir: str) -> dict:
    """A reference checkpoint restored onto a (2, 2) mesh with
    ``sharding_fn``, and a DTensor tree saved for the reference to
    read."""

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.distribute.sharding import (default_rules, place,
                                                 shard_like)
    from repro_torch.launch.mesh import make_smoke_mesh

    mesh = make_smoke_mesh((2, 2))
    rules = default_rules()
    axes = {"w": ("embed", "mlp"), "b": ("mlp",), "s": ()}
    template = {"w": torch.zeros(8, 12), "b": torch.zeros(12),
                "s": torch.zeros((), dtype=torch.int32)}
    sh = shard_like(template, axes, mesh, rules)
    tree, _ = load_checkpoint(ref_dir, template,
                              sharding_fn=lambda key: sh[key])
    res = {"placements": {k: str(v.placements) for k, v in tree.items()},
           "local_w": list(tree["w"].to_local().shape)}
    full = {k: v.full_tensor().numpy() for k, v in tree.items()}
    rng = np.random.default_rng(3)
    mine = {"w": torch.from_numpy(rng.standard_normal((8, 12)).astype(
                np.float32)).to(torch.bfloat16),
            "b": torch.from_numpy(rng.standard_normal(12).astype(
                np.float32))}
    placed = place(mine, shard_like(mine, {"w": ("embed", "mlp"),
                                           "b": ("mlp",)}, mesh, rules))
    save_checkpoint(os.path.join(out, "port_ckpt"), 7, placed)
    if rank == 0:
        np.savez(os.path.join(out, "ckpt.npz"),
                 **{f"restored_{k}": v for k, v in full.items()},
                 saved_w=mine["w"].float().numpy(), saved_b=mine["b"].numpy())
    return res


SCENARIOS = {"sharded": sharded, "pipeline": pipeline, "ckpt": ckpt}
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "src")


def run(name: str, out, *args, timeout: int = 400) -> dict:
    """Run a scenario in a subprocess (4 spawned ranks) and return rank
    0's result; raises with the ranks' stderr if it failed."""

    import subprocess
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), name,
                           str(out), *map(str, args)], env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"scenario {name} failed:\n"
                           f"{proc.stderr[-4000:]}")
    with open(os.path.join(str(out), "result.json")) as f:
        return json.load(f)


def _worker(rank: int, name: str, out: str, args: list) -> None:
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out, "init"), rank=rank, world_size=WORLD)
    try:
        res = SCENARIOS[name](rank, out, *args)
        if rank == 0:
            with open(os.path.join(out, "result.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> None:
    name, out, *args = sys.argv[1:]
    os.makedirs(out, exist_ok=True)
    torch.set_num_threads(1)
    mp.spawn(_worker, args=(name, out, args), nprocs=WORLD)


if __name__ == "__main__":
    main()
