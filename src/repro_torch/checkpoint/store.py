"""Checkpointing: device-agnostic tree snapshots, async save, retention,
atomic commit (the port's copy of ``repro.checkpoint.store``).

The on-disk format is the reference's, so each package reads the
other's checkpoints:

* A checkpoint is a directory ``step_<n>/`` holding one ``.npy`` per
  leaf and a ``manifest.json`` (step, and per leaf its key, file, dtype
  and shape).  A leaf's key is its path in the tree as the reference
  flattens it: NamedTuple field names, then dict keys in sorted order,
  joined by ``/`` (``params/blocks/0_dense/attn/wq``, ``opt/m/...``,
  ``opt/step``); ``None`` holds no leaf.  The file name is the key with
  ``/`` as ``__``.
* bf16 is written as its raw 2-byte values (numpy dtype ``V2``, as
  ``np.save`` writes an ``ml_dtypes`` bfloat16 array) under the manifest
  dtype ``"bfloat16"``, and read back through a ``uint16`` view, so
  ``ml_dtypes`` is never imported.
* Arrays are saved whole, so a restore may place them on another device
  or mesh: a DTensor leaf is written as its full value
  (``full_tensor()``, a collective every rank joins; rank 0 writes), and
  a restore puts each leaf where ``sharding_fn`` says (a device, or a
  :class:`~repro_torch.distribute.sharding.NamedSharding` through
  ``distribute_tensor``) or else like the template's leaf (a DTensor
  template leaf keeps its mesh and placements).
* Atomicity: writes go to ``step_<n>.tmp/``, renamed when complete: a
  crash mid-save never corrupts the latest checkpoint.
* Async: ``save(..., blocking=False)`` snapshots the tree to host memory
  and writes on a daemon thread, overlapping I/O with the next steps.
* Retention: the ``keep`` most recent checkpoints are kept.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

# the dtypes of a train state's leaves
_DTYPES = ("float32", "int32", "bfloat16")


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, tensor) for every leaf of a tree of NamedTuples, dicts
    (sorted keys), ``None`` and tensors, in the reference's order."""

    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = list(zip(tree._fields, tree))
    elif isinstance(tree, dict):
        children = [(str(k), tree[k]) for k in sorted(tree)]
    else:
        raise TypeError(f"not a tree node: {type(tree).__name__}")
    out = []
    for part, sub in children:
        out += _flatten_with_paths(sub, f"{prefix}/{part}" if prefix
                                   else part)
    return out


def _unflatten(template, leaves: dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf replaced by ``leaves[key]``."""

    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return leaves[prefix]
    path = lambda part: f"{prefix}/{part}" if prefix else part
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, path(str(k)))
                for k, v in template.items()}
    return type(template)(*(_unflatten(v, leaves, path(f))
                            for f, v in zip(template._fields, template)))


def _whole(leaf: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a collective); any other tensor itself."""

    from torch.distributed.tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _is_writer() -> bool:
    """Rank 0 writes (every rank holds the same whole values)."""

    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _place(t: torch.Tensor, where, tmpl: torch.Tensor) -> torch.Tensor:
    """A restored leaf on ``where`` (a device or a NamedSharding), else
    like the template's leaf."""

    from torch.distributed.tensor import DTensor, distribute_tensor
    if where is None and isinstance(tmpl, DTensor):
        return distribute_tensor(t.to(tmpl.device), tmpl.device_mesh,
                                 tmpl.placements)
    if where is None:
        return t.to(tmpl.device)
    if hasattr(where, "placements"):
        mesh = where.mesh
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 where.placements)
    return t.to(where)


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as the array ``np.save`` writes and its manifest dtype."""

    t = _whole(leaf).detach().to("cpu")
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).numpy()
        return bits.view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported checkpoint dtype {dtype!r}")
    arr = np.asarray(arr, order="C")        # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.view(np.dtype(dtype)))


def save_checkpoint(directory: str, step: int, tree, *, extra: dict | None
                    = None) -> str:
    """Blocking atomic save of a tree of tensors; returns the committed
    path.  Under a process group every rank calls it (DTensor leaves are
    gathered), rank 0 writes, and all return once the files are there."""

    final = os.path.join(directory, f"step_{step:08d}")
    if not _is_writer():
        _host_copy(tree)              # join the gathers
        _barrier()
        return final
    _write(directory, step, _host_copy(tree), extra)
    _barrier()
    return final


def _write(directory: str, step: int, tree, extra: dict | None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "keys": [], "extra": extra or {},
                "time": time.time()}
    for key, leaf in _flatten_with_paths(tree):
        arr, dtype = _to_host(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["keys"].append({"key": key, "file": fname, "dtype": dtype,
                                 "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_checkpoint(directory: str, template, *, step: int | None = None,
                    sharding_fn: Callable[[str], Any] | None = None):
    """Restore onto ``template``'s structure -> (tree, manifest).  Each
    leaf goes to ``sharding_fn(key)`` (a device, or a NamedSharding: a
    DTensor on its mesh) when given, else where the template's leaf is
    (its device, or its mesh and placements)."""

    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    by_key = {e["key"]: e for e in manifest["keys"]}
    out = {}
    for key, tmpl in _flatten_with_paths(template):
        e = by_key[key]
        t = _from_file(np.load(os.path.join(path, e["file"])), e["dtype"])
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(t.shape)} vs template "
                             f"{tuple(tmpl.shape)}")
        out[key] = _place(t, sharding_fn(key) if sharding_fn is not None
                          else None, tmpl)
    return _unflatten(template, out), manifest


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            out.append(int(name[len("step_"):]))
    return sorted(out)


def _host_copy(tree):
    """A snapshot of the tree in host memory, shared with nothing."""

    leaves = {k: _whole(v).detach().to("cpu", copy=True)
              for k, v in _flatten_with_paths(tree)}
    return _unflatten(tree, leaves)


@dataclass
class CheckpointManager:
    """Async save + retention policy."""

    directory: str
    keep: int = 3
    save_interval: int = 50

    def __post_init__(self):
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def save(self, step: int, tree, *, extra: dict | None = None,
             blocking: bool = False) -> None:
        self.wait()  # one in-flight save at a time
        host_tree = _host_copy(tree)

        def work():
            try:
                if _is_writer():
                    _write(self.directory, step, host_tree, extra)
                    self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            _barrier()
            self.raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Wait for the in-flight save (under a process group, every
        rank waits for rank 0's)."""

        if self._thread is not None:
            self._thread.join()
            self._thread = None
            _barrier()
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def latest_step(self) -> int | None:
        steps = available_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, template, *, sharding_fn=None, step=None):
        return load_checkpoint(self.directory, template, step=step,
                               sharding_fn=sharding_fn)

    def _gc(self) -> None:
        steps = available_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)


__all__ = ["save_checkpoint", "load_checkpoint", "available_steps",
           "CheckpointManager"]
