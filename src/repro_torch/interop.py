"""What crosses between ``repro`` and the port: data, weights, decode
state and platform state.

Arrays cross as numpy:

* :func:`from_numpy` takes int32, f32 and bf16 arrays.  A bf16 array
  from JAX (``np.asarray`` of a bfloat16 ``jax.Array``) has a numpy
  dtype named ``"bfloat16"`` from ``ml_dtypes``; it is passed through a
  ``uint16`` bit view into ``torch.bfloat16``, so ``ml_dtypes`` is never
  imported.
* :func:`to_numpy` returns int32 and f32 as they are, and bf16 widened
  to f32 (exact).
* :func:`params_from_jax` and :func:`decode_state_from_jax` take the JAX
  package's parameter or decode-state tree as numpy arrays (nested dicts,
  stacked leading blocks dim) and return the port's tree in the same
  layout, dtype for dtype, so both packages compute the same thing;
  :func:`params_to_numpy` goes back (bf16 widened to f32).

:func:`platform_spec_from_dict` and :func:`wave_params_from_dict` build
the port's ``PlatformSpec`` and ``WaveParams`` from the same dict a test
gives the JAX package's.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.platform import PlatformSpec
from .core.wave_model import WaveParams
from .kernels.common import resolve_device

_NUMPY_TO_TORCH = {np.dtype(np.int32): torch.int32,
                   np.dtype(np.float32): torch.float32}


def from_numpy(arr, device=None) -> torch.Tensor:
    """A copy of ``arr`` (int32, f32 or bf16) on ``device`` (``cuda:0``
    by default; ``"cpu"`` for the plain versions)."""

    arr = np.asarray(arr)
    dev = resolve_device(device)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    if arr.dtype not in _NUMPY_TO_TORCH:
        raise TypeError(f"unsupported dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The tensor on the host: int32/f32 as they are, bf16 as f32."""

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"unsupported dtype {t.dtype}")
    return t.numpy().copy()


def _tree_from_numpy(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return from_numpy(tree, device)


def params_from_jax(tree, device=None) -> dict:
    """The port's parameter tree from the JAX package's, given as numpy
    arrays (``jax.tree.map(np.asarray, params)``): same nested-dict
    layout, stacked shapes and dtypes, on ``device`` (``cuda:0`` by
    default)."""

    return _tree_from_numpy(tree, resolve_device(device))


def decode_state_from_jax(tree, device=None) -> dict:
    """The port's decode state (KV rings) from the JAX package's, given
    as numpy arrays; same layout as :func:`params_from_jax`."""

    return _tree_from_numpy(tree, resolve_device(device))


def params_to_numpy(tree) -> dict:
    """A parameter or state tree on the host: nested dicts of numpy
    arrays (bf16 widened to f32, exact)."""

    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return to_numpy(tree)


def platform_spec_from_dict(d: Mapping[str, Any]) -> PlatformSpec:
    return PlatformSpec(**dict(d))


def wave_params_from_dict(d: Mapping[str, Any]) -> WaveParams:
    return WaveParams(**dict(d))


__all__ = ["from_numpy", "to_numpy", "params_from_jax",
           "decode_state_from_jax", "params_to_numpy",
           "platform_spec_from_dict", "wave_params_from_dict"]
