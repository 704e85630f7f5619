"""Logical-axis sharding: rules tables and the mesh context (the port's
copy of ``repro.distribute.sharding``), resolved to DTensor placements.

Model code names tensor dims with *logical* axes ("batch", "embed",
"heads", "mlp", "vocab", "experts", ...).  A :class:`Rules` table maps
logical axes to mesh axes; :func:`logical_constraint` redistributes a
DTensor to the table's placements when a mesh context is active and
returns its argument untouched otherwise (the unsharded paths).

A spec is a tuple with a ``PartitionSpec``'s entries: per tensor dim a
mesh axis name, a tuple of names (one tensor dim split over several mesh
dims, outer first), or None.  :func:`spec_placements` turns it into the
placements of a ``DeviceMesh``: ``Shard(i)`` on each mesh dim that
tensor dim i names, ``Replicate()`` elsewhere.

The rules table is the tuner's action space for distributed configs:
``embed -> "data"`` turns on FSDP-style parameter sharding, ``experts ->
"model"`` expert parallelism, ``seq -> "model"`` sequence parallelism;
:mod:`repro_torch.launch.dryrun` re-runs a cell under mutated rules and
the roofline terms price the effect.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class Rules:
    """logical axis -> mesh axis (str), tuple of mesh axes, or None."""

    table: tuple[tuple[str, Any], ...]

    @staticmethod
    def make(**kw) -> "Rules":
        return Rules(tuple(sorted(kw.items())))

    def get(self, name: str | None):
        if name is None:
            return None
        return dict(self.table).get(name)

    def replace(self, **kw) -> "Rules":
        d = dict(self.table)
        d.update(kw)
        return Rules(tuple(sorted(d.items())))

    def spec(self, axes: tuple[str | None, ...]) -> tuple:
        """Resolve logical axes to a spec, dropping duplicate mesh-axis
        uses (first dim wins, like flax partitioning)."""

        used: set[str] = set()
        out = []
        for a in axes:
            m = self.get(a)
            if m is None:
                out.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(x for x in ms if x not in used)
            used.update(ms)
            out.append(ms[0] if len(ms) == 1 else (ms if ms else None))
        return tuple(out)


def default_rules(multi_pod: bool = False) -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    return Rules.make(
        batch=batch,        # data parallel over pod+data axes
        seq=None,           # sequence parallelism off by default
        embed=batch,        # FSDP: weights' embed dim sharded over dp axes
                            # (all-gathered per layer, ZeRO-3 semantics;
                            # activations never pick this up: their batch
                            # dim claims the data axes first)
        heads="model",      # tensor parallel attention
        kv_heads="model",
        mlp="model",        # tensor parallel MLP
        vocab="model",      # sharded embedding/logits
        experts="model",    # expert parallelism (MoE archs w/ many experts)
        expert_mlp=None,    # per-expert d_ff sharding (mixtral-style TP)
        state=None,         # SSM state dim
        cache_batch=batch,  # decode KV cache: shard over batch
        cache_seq="model",  # ... and over cache length when kv_heads can't
        head_dim=None,      # alternative cache TP dim
        layers=None,
    )


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or a process group:
    enough for :func:`arg_sharding` / :func:`shard_like` to resolve specs
    (a ``DeviceMesh`` has the same two attributes)."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or :class:`AbstractMesh`."""

    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def spec_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on every
    mesh dim that tensor dim i names, ``Replicate()`` on the others (and
    on mesh dims of size 1, where a shard is the whole tensor).  A
    tuple entry splits one tensor dim over several mesh dims, outer
    first, which DTensor expresses only in mesh order."""

    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} splits dim {i} against "
                             f"the mesh order {names}")
        for m in dims:
            # a shard over one device is the whole tensor: Replicate
            # keeps DTensor's products of two such dims expressible
            if sizes[m] > 1:
                out[m] = Shard(i)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.
    NamedSharding``)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)


@dataclass
class MeshCtx:
    mesh: Any
    rules: Rules
    # (logical axes, shape) -> placements, filled on first use
    cache: dict = field(default_factory=dict)

    @property
    def batch_dims(self) -> tuple[int, ...]:
        """Indices of the mesh dims the "batch" rule names."""

        m = self.rules.get("batch")
        names = () if m is None else ((m,) if isinstance(m, str)
                                      else tuple(m))
        return tuple(i for i, a in enumerate(self.mesh.mesh_dim_names)
                     if a in names)

    def placements(self, axes: tuple, shape: tuple) -> tuple:
        """Placements of a tensor of ``shape`` with logical ``axes``: the
        rules' spec, with every entry whose mesh size does not divide its
        dim dropped (DTensor shards unevenly, but cannot then flatten or
        split that dim, which the model's products do)."""

        key = (axes, shape)
        p = self.cache.get(key)
        if p is None:
            sizes = mesh_sizes(self.mesh)
            spec = []
            for n, entry in zip(shape, self.rules.spec(axes)):
                names = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                k = 1
                for a in names:
                    k *= sizes[a]
                spec.append(entry if n % k == 0 else None)
            p = self.cache[key] = spec_placements(tuple(spec), self.mesh)
        return p


_CTX: contextvars.ContextVar[MeshCtx | None] = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Rules):
    """Activate ``mesh`` and ``rules`` for :func:`logical_constraint`.  A
    ``DeviceMesh`` also turns on DTensor's implicit replication: the
    plain tensors model code makes (positions, masks, constants) are the
    same on every rank and join DTensor ops as replicated."""

    token = _CTX.set(MeshCtx(mesh, rules))
    try:
        if hasattr(mesh, "device_type"):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.reset(token)


def current_ctx() -> MeshCtx | None:
    return _CTX.get()


def logical_constraint(x, *axes: str | None):
    """Redistribute an intermediate to its logical placements (a mesh
    axis that does not divide its dim leaves that dim whole, where the
    reference's constraint pads): ``x`` itself without a mesh context or
    when it is not a DTensor."""

    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = ctx.placements(tuple(axes), tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def pinned(x, axes: tuple, shape: tuple | None = None):
    """:func:`logical_constraint` of ``x`` to the placements of ``axes``
    resolved over ``shape`` (``x``'s by default), always through
    DTensor's ``Redistribute``, even to the placements ``x`` has: its
    backward then brings the gradient to them too, before the backward
    of the view or split that made ``x`` meets a layout it cannot take.
    ``x`` itself without a mesh context or when it is not a DTensor."""

    ctx = _CTX.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = ctx.placements(tuple(axes), tuple(x.shape if shape is None
                                             else shape))
    return x.redistribute(x.device_mesh, want)


def gather_fsdp(w):
    """A weight in its compute placements: the mesh dims of the "batch"
    rule (where ``embed -> batch`` put the FSDP shards) gathered, every
    other shard kept; ``w`` itself without a mesh context or when it is
    not a DTensor.  The reference leaves this all-gather to GSPMD; DTensor
    left to itself reshards a product of an FSDP-sharded weight onto the
    model axis, where a head count that does not divide it cannot be
    unflattened."""

    ctx = _CTX.get()
    if ctx is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    dims = ctx.batch_dims
    pl = tuple(Replicate() if m in dims else p
               for m, p in enumerate(w.placements))
    if pl == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def grad_partials(in_placements, out_placements) -> tuple:
    """``local_map``'s ``in_grad_placements`` for a region that is exact
    on each rank's slice: each input's placements, with ``Partial()`` on
    every mesh dim that it is read whole on (``Replicate``) while the
    output is split there.  Each rank's gradient of such an input is the
    part from its own slice of the output; without this local_map takes
    it for the whole gradient (the SSD scan's A, B and C, the depthwise
    conv's kernel).  ``None`` entries (not tensors) stay ``None``."""

    from torch.distributed.tensor import Partial, Shard
    split = {m for m, p in enumerate(out_placements) if isinstance(p, Shard)}
    return tuple(None if pl is None else tuple(
        Partial() if m in split and p.is_replicate() else p
        for m, p in enumerate(pl)) for pl in in_placements)


def shard_offset(x, dim: int) -> int:
    """This rank's first index along ``dim`` of a DTensor split evenly
    over the mesh dims that shard it, outer first."""

    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord, lo, span = mesh.get_coordinate(), 0, x.shape[dim]
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            span //= mesh.size(m)
            lo += coord[m] * span
    return lo


def named_sharding(axes: tuple[str | None, ...]) -> NamedSharding | None:
    ctx = _CTX.get()
    if ctx is None:
        return None
    return NamedSharding(ctx.mesh, ctx.rules.spec(tuple(axes)))


def _is_axes_leaf(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in t)


def _map(fn, tree, *rest, is_leaf):
    """``fn`` over the leaves of nested dicts, lists and tuples
    (NamedTuples keep their type); ``None`` stays ``None``."""

    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, *(r[i] for r in rest),
                                 is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest),
                               is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def tree_shardings(axes_tree, mesh, rules: Rules):
    """NamedSharding tree for a logical-axes tree."""

    return _map(lambda axes: NamedSharding(mesh, rules.spec(tuple(axes))),
                axes_tree, is_leaf=_is_axes_leaf)


# Logical names a weight may fall back to for "model"-axis sharding when
# its canonical dim is not divisible by the mesh axis (e.g. 20 heads on a
# 16-way model axis -> shard the embed dim instead: row-parallel).
FALLBACK_NAMES = ("embed", "heads", "kv_heads", "mlp", "expert_mlp",
                  "vocab", "experts")


def arg_sharding(shape: tuple[int, ...], axes: tuple[str | None, ...],
                 mesh, rules: Rules) -> NamedSharding:
    """Shape-aware sharding for a step's *arguments* (which, unlike
    internal constraints, must divide evenly).

    Pass 1 applies the rules table where divisible; pass 2 guarantees
    weights still get a "model"-axis shard by falling back to the first
    divisible FALLBACK dim when the canonical one is not divisible."""

    sizes = mesh_sizes(mesh)

    def ax_size(ms) -> int:
        n = 1
        for a in ms:
            n *= sizes[a]
        return n

    used: set[str] = set()
    out: list = [None] * len(axes)
    for i, name in enumerate(axes):
        m = rules.get(name)
        if m is None:
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(a for a in ms if a not in used)
        if not ms:
            continue
        if shape[i] % ax_size(ms) != 0:
            continue
        used.update(ms)
        out[i] = ms[0] if len(ms) == 1 else ms

    model_used = any(
        (o == "model") or (isinstance(o, tuple) and "model" in o)
        for o in out)
    if not model_used and "model" in sizes:
        for i, name in enumerate(axes):
            if out[i] is None and name in FALLBACK_NAMES and \
                    shape[i] % sizes["model"] == 0 and shape[i] > 1:
                out[i] = "model"
                break
    return NamedSharding(mesh, tuple(out))


def _has_shape(t) -> bool:
    return hasattr(t, "shape") and not isinstance(t, tuple)


def shard_like(abstract_tree, axes_tree, mesh, rules: Rules):
    """Shape-aware sharding tree for a tree of tensors (real, fake or
    meta: only shapes are read) and its matching logical-axes tree."""

    return _map(lambda leaf, axes: arg_sharding(tuple(leaf.shape),
                                                tuple(axes), mesh, rules),
                abstract_tree, axes_tree, is_leaf=_has_shape)


def place(tree, shardings):
    """Each tensor of ``tree`` as a DTensor with its sharding's
    placements (``distribute_tensor``: every rank passes the same whole
    tensor and keeps its shard)."""

    from torch.distributed.tensor import distribute_tensor

    def one(t, sh: NamedSharding):
        return distribute_tensor(t, sh.mesh, sh.placements)

    return _map(one, tree, shardings, is_leaf=_has_shape)


__all__ = ["Rules", "default_rules", "use_mesh", "current_ctx",
           "logical_constraint", "named_sharding", "tree_shardings",
           "MeshCtx", "FALLBACK_NAMES", "arg_sharding", "shard_like",
           "NamedSharding", "AbstractMesh", "spec_placements", "mesh_sizes",
           "place", "gather_fsdp", "shard_offset", "grad_partials",
           "pinned"]
