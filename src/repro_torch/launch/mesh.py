"""Mesh constructors (the port's copy of ``repro.launch.mesh``).

Functions, not module constants, so importing never starts a process
group.  The production meshes keep the reference's shapes and names:
(16, 16) ``("data", "model")`` for one pod and (2, 16, 16) ``("pod",
"data", "model")`` for two, over a world of 256 or 512 ranks.  With one
card that world exists only as a fake process group (:func:`fake_world`),
in which the dry run places fake tensors and counts what each rank would
run.
"""

from __future__ import annotations

import contextlib


def _device_type() -> str:
    import torch
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    if torch.cuda.is_available() and dist.is_initialized() \
            and dist.get_backend() not in ("gloo", "fake"):
        return "cuda"
    return "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) mesh over the world that exists (which
    must have 256 or 512 ranks)."""

    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_smoke_mesh(shape: tuple[int, int] | None = None):
    """A ("data", "model") mesh over the ranks that exist: 1×1 on one
    card, (2, 2) over four ranks; by default half the ranks (at least
    one) on "data", as the reference's."""

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if shape is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        dp = max(1, n // 2)
        shape = (dp, n // dp)
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0:
    collectives return at once and move nothing.  Destroyed on exit, so
    worlds of other sizes can follow in the same process."""

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in tuple(mesh.shape))


__all__ = ["make_production_mesh", "make_smoke_mesh", "fake_world",
           "mesh_name"]
