"""Multi-rank scenarios of the port on CPU gloo ranks, for
``tests/test_torch_distributed.py``, ``test_torch_dist_families.py``,
``test_torch_pipeline.py`` and ``test_torch_checkpoint.py``.  Imports
torch and ``repro_torch`` only.

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


FAMILY_ARCHS = ("mamba2-2.7b", "mixtral-8x22b", "llama4-maverick-400b-a17b",
                "llama-3.2-vision-90b", "hymba-1.5b", "whisper-medium")
# the families' sizes: (B, S) of the forward and the train step, the
# decode context and per-slot positions, S of the forward through flash
FAM_B, FAM_S, FAM_CTX, FAM_FLASH_S = 4, 16, 32, 128
FAM_CUR = (3, 0, 7, 5)


def family_cfg(arch: str, variant: str = ""):
    """The reduced f32-logits config of a family; ``variant`` "nodrop"
    sets the MoE capacity factor to 16 (no pair is dropped), "heads6" /
    "heads5" cut hymba's SSM to 6 or 5 heads (d_model 48 / 40, headdim
    16), which a 4- or 2-way model axis does not divide."""

    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced().replace(logits_dtype="float32")
    if variant == "nodrop":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=16.0))
    elif variant in ("heads6", "heads5"):
        cfg = cfg.replace(d_model=48 if variant == "heads6" else 40,
                          ssm=dataclasses.replace(cfg.ssm, headdim=16))
    return cfg


def family_params(api):
    """f32 params from seed 0; the vlm's cross gates at 0.5 (they start
    at 0, which would hide the cross layers)."""

    p = _f32(api.init(0, device="cpu"))
    for k, blk in p["blocks"].items():
        if k.endswith("_cross"):
            blk["gate"].fill_(0.5)
    return p


def family_batch(cfg, B: int, S: int, seed: int) -> dict:
    """tokens and labels, plus frames (enc-dec) or image embeddings
    (vlm), from a numpy seed."""

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.is_encdec:
        out["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                         * 0.3).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = (rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)) * 0.3).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _max_err(got, want) -> float:
    """Max abs difference over the leaves of two trees (DTensors taken
    whole)."""

    g, w = _tree_np(got), _tree_np(want)
    assert g.keys() == w.keys(), (sorted(g), sorted(w))
    return max(float(np.max(np.abs(g[k] - w[k]))) if g[k].size else 0.0
               for k in w)


def _family_case(cfg, mesh, *, train: bool, flash: bool, dump: str | None):
    """One config on ``mesh`` against its unsharded self: forward, flash
    forward, ``decode_step`` with per-slot positions over a non-zero
    state (whisper's cross K/V from ``encode_cross_kv``), one train
    step.  Returns the errors; ``dump`` names an .npz for the params,
    the inputs and the sharded logits."""

    from repro_torch.distribute.sharding import place, shard_like, use_mesh
    from repro_torch.launch.cells import batch_axes, rules_for_arch
    from repro_torch.models import build_model
    from repro_torch.models.common import axes_tree, tree_map
    from repro_torch.runtime import (TrainConfig, build_train_step,
                                     init_train_state)
    from repro_torch.runtime.train import value_and_grad

    api = build_model(cfg)
    rules = rules_for_arch(cfg)
    params = family_params(api)
    batch = family_batch(cfg, FAM_B, FAM_S, seed=1)
    fwd_in = {k: v for k, v in batch.items() if k != "labels"}
    axes = batch_axes(cfg, None)
    res: dict = {}

    def placed(tree, ax):
        return place(tree, shard_like(tree, ax, mesh, rules))

    with torch.no_grad():
        want = api.forward(params, fwd_in)
        with use_mesh(mesh, rules):
            pm = placed(params, api.axes())
            got = api.forward(pm, placed(fwd_in, {k: axes[k] for k in
                                                  fwd_in})).full_tensor()
        res["forward_err"] = float((got - want).abs().max())
        res["forward_scale"] = float(want.abs().max())
        if dump:
            np.savez(dump, **{f"params/{k}": v for k, v in
                              _tree_np(params).items()},
                     **{f"in/{k}": v.numpy() for k, v in fwd_in.items()},
                     logits=got.numpy())

        if flash:
            # S tiles by 128: attention through the flash kernel's
            # region (its plain version on these CPU shards), windowed
            # where the config has a window
            fapi = build_model(cfg.replace(use_flash=True))
            fin = {k: v for k, v in family_batch(
                cfg, FAM_B, FAM_FLASH_S, seed=4).items() if k != "labels"}
            fwant = fapi.forward(params, fin)
            with use_mesh(mesh, rules):
                fgot = fapi.forward(pm, placed(fin, {k: axes[k] for k in
                                                     fin})).full_tensor()
            res["flash_err"] = float((fgot - fwant).abs().max())

        # decode over a non-zero state at per-slot positions
        B = FAM_B
        rng = np.random.default_rng(3)
        st = tree_map(lambda t: torch.from_numpy(
            rng.standard_normal(tuple(t.shape)) * 0.5).to(t.dtype),
            api.init_decode_state(B, FAM_CTX, dtype=torch.float32,
                                  device="cpu"))
        if cfg.is_encdec:
            frames = batch["frames"]
            xkv = api.encode_cross_kv(params, frames)
            with use_mesh(mesh, rules):
                xkv_m = api.encode_cross_kv(pm, placed(
                    frames, ("batch", None, None)))
            res["cross_kv_err"] = _max_err(xkv_m, xkv)
            for n in ("k", "v"):
                st["xattn"][n].copy_(xkv[n])
        st_m = tree_map(lambda t: t.clone(), st)
        tok1 = batch["tokens"][:, :1]
        cur = torch.tensor(FAM_CUR)
        want, _ = api.decode_step(params, st, tok1, cur)
        dspecs = api.decode_state_specs(B, FAM_CTX, dtype=torch.float32)
        with use_mesh(mesh, rules):
            sd = placed(st_m, axes_tree(dspecs))
            got, sd = api.decode_step(pm, sd, placed(tok1, ("batch", None)),
                                      placed(cur, ("batch",)))
            got = got.full_tensor()
        res["decode_err"] = float((got - want).abs().max())
        res["decode_scale"] = float(want.abs().max())
        res["decode_state_err"] = _max_err(sd, st)

    if train:
        tcfg = TrainConfig(lr=3e-3, warmup=2, total_steps=20)
        state0 = init_train_state(api, 0, tcfg, device="cpu")
        state0 = state0._replace(params=tree_map(lambda t: t.clone(),
                                                 params))
        step = build_train_step(api, tcfg)
        _, grads = value_and_grad(api, params, batch)
        plain, m = step(state0, batch)
        with use_mesh(mesh, rules):
            bm = placed(batch, {k: axes[k] for k in batch})
            _, grads_m = value_and_grad(api, pm, bm)
            st = _place_state(state0, api, None, mesh, rules)
            new, mm = step(st, bm)
        res["grad_err"] = _max_err(grads_m, grads)
        res["loss"], res["loss_plain"] = float(mm["loss"]), float(m["loss"])
        res["step_err"] = _max_err(new.params, plain.params)
    return res


def families(rank: int, out: str) -> dict:
    """The six non-dense families' sharded forward, flash forward,
    decode_step and train step on a (2, 2) mesh against the unsharded
    ones (the MoE families also with no drops), and hymba cut to SSM head
    counts the model axis does not divide: 6 heads on (1, 4), 5 on
    (2, 2)."""

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.tune import TuningCache, set_default_cache

    set_default_cache(TuningCache(os.path.join(out, f"cache{rank}.json")))
    mesh = make_smoke_mesh((2, 2))
    res: dict = {}
    for arch in FAMILY_ARCHS:
        cfg = family_cfg(arch)
        dump = os.path.join(out, f"{arch}.npz") if rank == 0 else None
        res[arch] = _family_case(cfg, mesh, train=True,
                                 flash=cfg.family != "ssm", dump=dump)
        if cfg.moe is not None:
            dump = os.path.join(out, f"{arch}-nodrop.npz") if rank == 0 \
                else None
            res[f"{arch}/nodrop"] = _family_case(
                family_cfg(arch, "nodrop"), mesh, train=False, flash=False,
                dump=dump)
    res["hymba-1.5b/heads5"] = _family_case(
        family_cfg("hymba-1.5b", "heads5"), mesh, train=True, flash=False,
        dump=None)
    res["hymba-1.5b/heads6"] = _family_case(
        family_cfg("hymba-1.5b", "heads6"), make_smoke_mesh((1, 4)),
        train=True, flash=False, dump=None)
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


SCENARIOS = {"sharded": sharded, "families": families,
             "pipeline": pipeline, "ckpt": ckpt}
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
