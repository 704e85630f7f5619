"""Cell lowering: one (architecture × shape × mesh) dry-run unit (the
port's copy of ``repro.launch.cells``).

PyTorch has no compiled artifact to read, so a cell RUNS its step once,
eagerly, on a fake process group of the mesh's size, with the state and
batch placed by :func:`~repro_torch.distribute.sharding.shard_like` as
DTensors over fake tensors: nothing is allocated and no collective moves
data.  :class:`CountingMode` (a ``FakeTensorMode``) watches the ops each
rank runs on its local shards and records, per cell:

* success (status ``ok``, ``skipped`` via ``supports``, ``failed`` with
  ``Type: message``),
* ``cost``: per-device FLOPs (``torch.utils.flop_counter``'s formulas at
  the local shapes) and bytes accessed (every non-view op reads its
  inputs and writes its outputs: eager execution fuses nothing; a
  metadata query, a ``prim`` op, moves nothing),
* ``collectives``: count and result bytes per type, mapped from the
  ``_c10d_functional`` ops DTensor's redistributions issue
  (``all_reduce`` -> ``all-reduce``, ``all_gather_into_tensor`` ->
  ``all-gather``, ``reduce_scatter_tensor`` -> ``reduce-scatter``,
  ``all_to_all_single`` -> ``all-to-all``), plus ``total_bytes``,
* ``memory``: the local shards of the inputs and outputs, and the peak of
  the live local tensors over the step.

Counting per device: a dispatch mode over DTensor sees each op once at
its GLOBAL shapes, and DTensor's sharding propagation runs global-shape
copies of ops on fake tensors of the active fake mode.  The mode counts
an op only when none of its tensors is a DTensor (the local op DTensor
runs on this rank's shards) and the mode is entered once: propagation
re-enters the active fake mode around its own runs, which are skipped.

Unlike XLA's cost analysis, which counts a scan body once (the
reference composes ``module + (trips - 1) × block``), the eager step runs
every block, so the module counts cover all trips; the records say so in
``settings["counts"] = "all_trips"`` and
:func:`~repro_torch.launch.roofline.analyze` does not compose them.
:func:`collective_bytes` is the reference's HLO parser, kept so that the
port's ``analyze`` reads the reference's records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import time
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from ..configs import SHAPES, get_config, supports
from ..configs.base import ArchConfig, ShapeSpec
from ..data.pipeline import make_batch_specs
from ..distribute.sharding import (NamedSharding, Rules, arg_sharding,
                                   default_rules, shard_like, use_mesh)
from ..models.api import build_model
from ..models.common import abstract_params, axes_tree
from ..runtime.train import (TrainConfig, abstract_train_state,
                             build_train_step)


def rules_for_arch(cfg: ArchConfig, *, multi_pod: bool = False,
                   overrides: dict | None = None) -> Rules:
    """Arch-aware default rules: MoE archs whose expert count does not
    divide the model axis shard each expert's d_ff instead (mixtral: 8
    experts, 16-way model -> expert_mlp)."""

    rules = default_rules(multi_pod)
    if cfg.moe is not None and cfg.moe.num_experts % 16 != 0:
        rules = rules.replace(experts=None, expert_mlp="model")
    if overrides:
        rules = rules.replace(**overrides)
    return rules


def batch_axes(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.family == "vlm":
        out["img_embeds"] = ("batch", None, None)
    if cfg.is_encdec:
        out["frames"] = ("batch", None, None)
    return out


@dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str                   # ok | skipped | failed
    reason: str = ""
    n_devices: int = 0
    lower_s: float = 0.0
    compile_s: float = 0.0
    memory: dict = field(default_factory=dict)
    cost: dict = field(default_factory=dict)
    collectives: dict = field(default_factory=dict)
    param_count: int = 0
    settings: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# The reference's HLO collective parser (reads its records)
# ---------------------------------------------------------------------------

_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[^\]]*\]))\S*\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

_DT_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
             "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
             "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}


def _type_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DT_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DT_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-type (count, result bytes) of collective ops in an HLO module
    (the reference's records; the port's cells count DTensor's
    collectives instead)."""

    out: dict[str, Any] = {}
    for m in _COLL_RE.finditer(hlo_text):
        type_str, op = m.group(1), m.group(2)
        rec = out.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += _type_bytes(type_str)
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    return out


# ---------------------------------------------------------------------------
# Counting each rank's local ops
# ---------------------------------------------------------------------------

# the reference's names for the collectives DTensor issues; any other
# collective is recorded under its own op name
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute",
}


def _tensors(tree) -> list:
    """The tensors in nested lists, tuples and dicts (a loop, not a
    recursive closure: the closure's cycle would keep the list, and the
    tensors in it, alive until the next garbage collection)."""

    import torch
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return out


def _storage_key(t) -> tuple[int, int]:
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


class CountingMode:
    """A ``FakeTensorMode`` (built on first use, so importing this module
    imports no fake-tensor machinery) that counts each rank's local ops:
    FLOPs, bytes accessed, collectives and live bytes."""

    def __new__(cls):
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        class _Mode(FakeTensorMode):
            def __init__(self):
                super().__init__(allow_non_fake_inputs=True)
                self.depth = 0
                self.counting = False
                self.flops = 0
                self.bytes = 0
                self.coll: dict[str, dict[str, int]] = {}
                self.live: dict[int, list] = {}   # storage -> [refs, bytes]
                self.live_bytes = 0
                self.peak = 0

            def __enter__(self):
                self.depth += 1
                return super().__enter__()

            def __exit__(self, *exc):
                self.depth -= 1
                return super().__exit__(*exc)

            # -- live local tensors ------------------------------------
            def track(self, t) -> None:
                key, nbytes = _storage_key(t)
                rec = self.live.get(key)
                if rec is None:
                    rec = self.live[key] = [0, nbytes]
                    self.live_bytes += nbytes
                    self.peak = max(self.peak, self.live_bytes)
                rec[0] += 1
                weakref.finalize(t, self._release, key)

            def _release(self, key) -> None:
                rec = self.live.get(key)
                if rec is None:
                    return
                rec[0] -= 1
                if rec[0] == 0:
                    self.live_bytes -= rec[1]
                    del self.live[key]

            # -- dispatch ----------------------------------------------
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = super().__torch_dispatch__(func, types, args, kwargs)
                if not self.counting or self.depth != 1:
                    return out
                ins = _tensors((args, kwargs))
                if any(isinstance(t, DTensor) for t in ins):
                    return out
                outs = _tensors(out)
                ns = func.namespace
                name = func._schema.name.split("::")[-1]
                if ns == "prim":
                    # a metadata query (``prim.device``, asked by autograd
                    # of every tensor it routes): no data moves
                    return out
                if ns in ("_c10d_functional", "c10d"):
                    if name != "wait_tensor":
                        rec = self.coll.setdefault(
                            _COLLECTIVES.get(name, name),
                            {"count": 0, "bytes": 0})
                        rec["count"] += 1
                        rec["bytes"] += sum(t.nbytes for t in outs)
                else:
                    packet = func._overloadpacket
                    if packet in flop_registry:
                        self.flops += flop_registry[packet](
                            *args, **(kwargs or {}), out_val=out)
                    if not func.is_view:
                        self.bytes += sum(t.nbytes for t in ins) + \
                            sum(t.nbytes for t in outs)
                for t in outs:
                    if type(t).__name__ == "FakeTensor":
                        self.track(t)
                return out

        return _Mode()


def _fake_place(mode, tree, shardings):
    """Meta ``tree`` as DTensors over fake local shards, placed by
    ``shardings`` (no collective: each rank slices its own copy)."""

    import torch
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh: NamedSharding):
        with mode:
            g = torch.empty(t.shape, dtype=t.dtype)
            return distribute_tensor(g, sh.mesh, sh.placements,
                                     src_data_rank=None)

    from ..distribute.sharding import _has_shape, _map
    return _map(one, tree, shardings, is_leaf=_has_shape)


def _local_storages(tree) -> dict[int, int]:
    """Storage -> bytes of the local shards in ``tree``."""

    from torch.distributed.tensor import DTensor
    seen: dict[int, int] = {}
    for t in _tensors(tree):
        loc = t._local_tensor if isinstance(t, DTensor) else t
        key, nbytes = _storage_key(loc)
        seen[key] = nbytes
    return seen


def _run_counted(mode, res: CellResult, inputs, fn) -> None:
    """Run ``fn(*inputs)`` under ``mode``, counting, and fill ``res``'s
    cost, collectives and memory."""

    from torch.distributed.tensor import DTensor
    for t in _tensors(inputs):
        mode.track(t._local_tensor if isinstance(t, DTensor) else t)
    ins = _local_storages(inputs)
    arg = mode.live_bytes
    mode.peak = arg
    mode.counting = True
    t0 = time.perf_counter()
    try:
        with mode:
            out = fn(*inputs)
    finally:
        mode.counting = False
    res.lower_s = time.perf_counter() - t0
    outs = _local_storages(out)
    out_b = sum(outs.values())
    # outputs written in place into the inputs (the decode state)
    alias = sum(b for k, b in outs.items() if k in ins)
    peak = max(mode.peak, arg + out_b - alias)
    res.memory = {"argument_size_in_bytes": int(arg),
                  "output_size_in_bytes": int(out_b),
                  "temp_size_in_bytes": int(peak - arg - out_b + alias),
                  "alias_size_in_bytes": int(alias),
                  "peak_hbm_bytes": int(peak)}
    res.cost = {"flops": float(mode.flops),
                "bytes_accessed": float(mode.bytes)}
    coll = {k: dict(v) for k, v in sorted(mode.coll.items())}
    coll["total_bytes"] = sum(v["bytes"] for v in mode.coll.values())
    res.collectives = coll


def auto_microbatches(cfg: ArchConfig, shape: ShapeSpec, n_dp: int,
                      budget_bytes: float = 4e9) -> int:
    """Machine-model-driven default gradient-accumulation factor: the
    remat'd stack saves one carry per block; pick the smallest power of
    two keeping the per-device saved-activation stack under budget."""

    from ..models.transformer import _block_plan
    _, n_blocks = _block_plan(cfg)
    b_loc = max(1, shape.global_batch // n_dp)
    carry = n_blocks * b_loc * shape.seq_len * cfg.d_model * 2
    if cfg.ssm is not None:   # SSD intra-chunk tensors are heavier
        carry *= 2
    if cfg.is_encdec:         # decoder+cross stacks and encoder residency
        carry *= 6
    mb = 1
    while carry / mb > budget_bytes and mb < b_loc:
        mb *= 2
    return mb


@contextlib.contextmanager
def _world_for(mesh, multi_pod: bool):
    """The given mesh, or the production mesh over a fake world of its
    size (torn down after the cell)."""

    from .mesh import fake_world, make_production_mesh
    if mesh is not None:
        yield mesh
        return
    with fake_world(512 if multi_pod else 256):
        yield make_production_mesh(multi_pod=multi_pod)


def _mesh_label(mesh, multi_pod: bool, given: bool) -> str:
    from .mesh import mesh_name
    if given:
        return mesh_name(mesh)
    return "2x16x16" if multi_pod else "16x16"


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               rules_overrides: dict | None = None,
               tcfg: TrainConfig | None = None,
               remat: str | None = None,
               logits_dtype: str | None = None,
               cfg_overrides: dict | None = None,
               capture_hlo: bool = False,
               mesh=None) -> CellResult:
    """Run one cell's step on fake shards and count it.  ``mesh`` (a
    ``DeviceMesh`` of an existing world, fake or not) replaces the
    production mesh; ``capture_hlo`` has no artifact to capture and is
    accepted for the reference's signature."""

    import torch

    cfg = get_config(arch)
    if remat:
        cfg = cfg.replace(remat=remat)
    if logits_dtype:
        cfg = cfg.replace(logits_dtype=logits_dtype)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    res = CellResult(arch=arch, shape=shape_name,
                     mesh="2x16x16" if multi_pod else "16x16", status="ok",
                     settings={"remat": cfg.remat,
                               "logits_dtype": cfg.logits_dtype,
                               "rules_overrides": rules_overrides or {},
                               "microbatches": tcfg.microbatches if tcfg
                               else 1,
                               "counts": "all_trips"})

    ok, why = supports(cfg, shape)
    if not ok:
        res.status, res.reason = "skipped", why
        return res

    given = mesh is not None
    try:
        with _world_for(mesh, multi_pod) as mesh:
            res.mesh = _mesh_label(mesh, multi_pod, given)
            res.n_devices = mesh.size()
            rules = rules_for_arch(cfg, multi_pod=multi_pod,
                                   overrides=rules_overrides)
            api = build_model(cfg)
            res.param_count = api.param_count()
            mode = CountingMode()
            with use_mesh(mesh, rules), torch.no_grad():
                if shape.kind == "train":
                    tc = tcfg or TrainConfig(microbatches=0)
                    if tc.microbatches == 0:
                        # the production meshes' data ranks, as the
                        # reference's (whatever mesh was given)
                        n_dp = 32 if multi_pod else 16
                        tc = dataclasses.replace(
                            tc, microbatches=auto_microbatches(cfg, shape,
                                                               n_dp))
                    res.settings["microbatches"] = tc.microbatches
                    state = abstract_train_state(api, tc)
                    ax = api.axes()
                    from ..optim.adamw import OptState
                    from ..runtime.train import TrainState
                    st_ax = TrainState(
                        params=ax, opt=OptState(step=(), m=ax, v=ax),
                        ef_residual=ax if tc.compress_pod_grads else None)
                    st = _fake_place(mode, state,
                                     shard_like(state, st_ax, mesh, rules))
                    batch = make_batch_specs(cfg, shape)
                    b = _fake_place(mode, batch, shard_like(
                        batch, batch_axes(cfg, shape), mesh, rules))
                    step = build_train_step(api, tc)
                    _run_counted(mode, res, (st, b), step)
                elif shape.kind == "prefill":
                    params = api.abstract()
                    p = _fake_place(mode, params, shard_like(
                        params, api.axes(), mesh, rules))
                    batch = make_batch_specs(cfg, shape)
                    batch.pop("labels")
                    b = _fake_place(mode, batch, shard_like(
                        batch, {k: v for k, v in batch_axes(
                            cfg, shape).items() if k in batch},
                        mesh, rules))

                    def prefill(params, batch):
                        # serving prefill emits the last token's logits
                        return api.forward(params, batch)[:, -1]

                    _run_counted(mode, res, (p, b), prefill)
                else:  # decode
                    params = api.abstract()
                    p = _fake_place(mode, params, shard_like(
                        params, api.axes(), mesh, rules))
                    B = shape.global_batch
                    dspecs = api.decode_state_specs(B, shape.seq_len)
                    dstate = abstract_params(dspecs)
                    d = _fake_place(mode, dstate, shard_like(
                        dstate, axes_tree(dspecs), mesh, rules))
                    meta = lambda s: torch.empty(s, dtype=torch.int32,
                                                 device="meta")
                    tok = _fake_place(mode, meta((B, 1)), arg_sharding(
                        (B, 1), ("batch", None), mesh, rules))
                    # (B,) per-slot positions: the serving feed
                    cur = _fake_place(mode, meta((B,)), arg_sharding(
                        (B,), ("batch",), mesh, rules))

                    def serve_step(params, state, tokens, cur_len):
                        return api.decode_step(params, state, tokens,
                                               cur_len)

                    _run_counted(mode, res, (p, d, tok, cur), serve_step)
    except Exception as e:
        res.status, res.reason = "failed", _reason(e)
    return res


def _reason(e: Exception) -> str:
    """``Type: message`` (the reference's reason), then where it was
    raised: the innermost frame in the port and the innermost at all."""

    import traceback
    frames = traceback.extract_tb(e.__traceback__)
    ours = [f for f in frames if "repro_torch" in f.filename]
    where = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
             for f in (ours[-1:] + frames[-1:])]
    return f"{type(e).__name__}: {e} [at {' <- '.join(reversed(where))}]"


def lower_block_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                     part: str = "decoder",
                     rules_overrides: dict | None = None,
                     remat: str | None = None,
                     cfg_overrides: dict | None = None,
                     mesh=None) -> CellResult:
    """Run ONE block (forward, or forward and backward for train shapes)
    under the same mesh and shardings as the full step, and count it.

    The reference needs these counts to compose its totals (XLA counts a
    scan body once); the port's module counts already cover every trip,
    so here they serve to attribute a cell's counts to its blocks.
    ``settings["trips"]`` holds the trip count."""

    import torch
    from ..models import attention as attn_mod
    from ..models import ssm as ssm_mod
    from ..models import transformer as tfm
    from ..models.common import rms_norm, stack_specs, tree_leaves
    from ..models.transformer import (_block_plan, _remat, gather_params,
                                      layer_forward)

    cfg = get_config(arch)
    if remat:
        cfg = cfg.replace(remat=remat)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    res = CellResult(arch=arch, shape=shape_name,
                     mesh="2x16x16" if multi_pod else "16x16", status="ok",
                     settings={"part": part, "remat": cfg.remat,
                               "counts": "all_trips"})
    ok, why = supports(cfg, shape)
    if not ok:
        res.status, res.reason = "skipped", why
        return res

    if part == "encoder":
        kinds, trips = ["encoder"], cfg.encoder_layers
        seq = cfg.enc_seq
    else:
        kinds, trips = _block_plan(cfg)
        seq = shape.seq_len
    res.settings["trips"] = trips
    B, d = shape.global_batch, cfg.d_model
    block_specs: Any = {f"{i}_{kind}": tfm.layer_specs(cfg, kind)
                        for i, kind in enumerate(kinds)}
    encdec_dec = cfg.is_encdec and part == "decoder"
    if encdec_dec:
        block_specs = {"d": block_specs,
                       "x": {"x": attn_mod.attn_specs(cfg, cross=True),
                             "ln_x": tfm._norm_spec(cfg)}}
    x_axes = ("batch", None, None)

    def block_fwd(bp, x, extras):
        bp = gather_params(bp)
        positions = tfm._positions(B, x.shape[1], x.device)
        enc_out = extras.get("enc_out")
        if encdec_dec:
            h = layer_forward(bp["d"]["0_dense"], cfg, "dense", x, positions)
            xp = bp["x"]
            return h + attn_mod.attention(xp["x"], cfg,
                                          rms_norm(h, xp["ln_x"]),
                                          positions, x_kv=enc_out)
        h = x
        for i, kind in enumerate(kinds):
            h = layer_forward(bp[f"{i}_{kind}"], cfg, kind, h, positions,
                              enc_out=enc_out, causal=(part != "encoder"))
        return h

    given = mesh is not None
    try:
        with _world_for(mesh, multi_pod) as mesh:
            res.mesh = _mesh_label(mesh, multi_pod, given)
            res.n_devices = mesh.size()
            rules = rules_for_arch(cfg, multi_pod=multi_pod,
                                   overrides=rules_overrides)
            mode = CountingMode()
            bf16 = lambda shp: torch.empty(shp, dtype=torch.bfloat16,
                                           device="meta")
            with use_mesh(mesh, rules), torch.no_grad():
                if shape.kind in ("train", "prefill"):
                    bp = abstract_params(block_specs)
                    bp = _fake_place(mode, bp, shard_like(
                        bp, axes_tree(block_specs), mesh, rules))
                    sh = arg_sharding((B, seq, d), x_axes, mesh, rules)
                    x = _fake_place(mode, bf16((B, seq, d)), sh)
                    extras = {}
                    n = (cfg.n_img_tokens if cfg.family == "vlm"
                         and part == "decoder" else
                         cfg.enc_seq if encdec_dec else None)
                    if n is not None:
                        extras["enc_out"] = _fake_place(
                            mode, bf16((B, n, d)),
                            arg_sharding((B, n, d), x_axes, mesh, rules))

                    if shape.kind == "train":
                        ct = _fake_place(mode, bf16((B, seq, d)), sh)

                        def train_block(bp, x, ct, extras):
                            leaves = [t.detach().requires_grad_()
                                      for t in [x] + tree_leaves(bp)]
                            it = iter(leaves[1:])
                            live = tfm.tree_map(lambda _: next(it), bp)
                            with torch.enable_grad():
                                out = _remat(cfg, lambda y: block_fwd(
                                    live, y, extras), leaves[0], live)
                                grads = torch.autograd.grad(
                                    out, leaves, ct, allow_unused=True)
                            return out.detach(), grads

                        _run_counted(mode, res, (bp, x, ct, extras),
                                     train_block)
                    else:
                        _run_counted(mode, res, (bp, x, extras), block_fwd)
                else:  # decode block
                    one = cfg.replace(n_layers=1 if cfg.is_encdec
                                      else len(kinds))
                    api = build_model(one)
                    pspecs = {"blocks": stack_specs(
                        block_specs["d"] if encdec_dec else block_specs, 1)}
                    if encdec_dec:
                        pspecs["xattn_blocks"] = stack_specs(
                            block_specs["x"], 1)
                    cspecs = api.decode_state_specs(B, shape.seq_len)
                    bp = abstract_params(pspecs)
                    bp = _fake_place(mode, bp, shard_like(
                        bp, axes_tree(pspecs), mesh, rules))
                    cache = abstract_params(cspecs)
                    cache = _fake_place(mode, cache, shard_like(
                        cache, axes_tree(cspecs), mesh, rules))
                    x = _fake_place(mode, bf16((B, 1, d)), arg_sharding(
                        (B, 1, d), x_axes, mesh, rules))

                    def decode_block(bp, cache, x):
                        cur = torch.full((B,), 7, dtype=torch.int64)

                        def attend(p, h, kv):
                            return attn_mod.decode_attention(
                                p, one, h, kv, cur, window=one.window)[0]

                        def recur(p, h, st):
                            return ssm_mod.ssm_decode_step(p, one, h,
                                                           st)[0]

                        return api._walk(bp, cache, x, attend, recur)

                    _run_counted(mode, res, (bp, cache, x), decode_block)
    except Exception as e:
        res.status, res.reason = "failed", _reason(e)
    return res


__all__ = ["lower_cell", "lower_block_cell", "CellResult", "collective_bytes",
           "rules_for_arch", "batch_axes", "auto_microbatches",
           "CountingMode"]
