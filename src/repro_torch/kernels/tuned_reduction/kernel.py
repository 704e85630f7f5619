"""Wrapper of the hand-written CUDA reduction (``csrc/tuned_reduction.cu``).

A CUDA tensor launches the kernel (one launch: the last block to finish
folds the block partials) and raises if the launch fails; a CPU tensor
takes the plain version, :func:`~.ref.reduce_chunked`, which folds in
the same order.  The partials and the last-block ticket are scratch
owned here, one set per device and stream, grown as needed and never
allocated per call; the kernel leaves the ticket at zero for the next
launch.  ``reduce_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import threading

import torch

from .. import _build
from .ref import DTYPES, OPS, reduce_chunked

_DTYPE_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_OP_CODE = {"min": 0, "max": 1, "sum": 2}
_MAX_BLOCKS = 2**31 - 1

# (device index, stream handle) -> [partials (int32 slots), ticket]
_SCRATCH: dict[tuple[int, int], list[torch.Tensor]] = {}
_SCRATCH_LOCK = threading.Lock()


def _scratch(device: torch.device, stream: int,
             blocks: int) -> list[torch.Tensor]:
    """This stream's partials (at least ``blocks`` slots) and ticket.  A
    stream owns its ticket: two reductions in flight on two streams never
    share one.  Launches on one stream run in order, so they share."""

    key = (device.index, stream)
    with _SCRATCH_LOCK:
        entry = _SCRATCH.get(key)
        if entry is None:
            entry = _SCRATCH[key] = [
                torch.empty(0, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device)]
        if entry[0].numel() < blocks:
            entry[0] = torch.empty(max(blocks, 2 * entry[0].numel()),
                                   dtype=torch.int32, device=device)
        return entry


def reduce_kernel(x: torch.Tensor, op: str, WG: int, TS: int) -> torch.Tensor:
    """Reduce the 1-D tensor ``x`` with work-groups of ``WG`` threads that
    fold ``TS`` elements each; returns a 0-d tensor of ``x``'s dtype."""

    if x.dim() != 1 or x.numel() < 1:
        raise ValueError(f"need a non-empty 1-D tensor, got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    n = x.numel()
    blocks = -(-n // (WG * TS)) if WG >= 1 and TS >= 1 else 0
    if not (1 <= WG <= 1024 and TS >= 1 and blocks <= _MAX_BLOCKS):
        raise ValueError(f"bad launch parameters WG={WG} TS={TS}")
    x = x.contiguous()
    if x.device.type == "cpu":
        return reduce_chunked(x, op, WG, TS)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _build.library()
    out = torch.empty((), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        partials, ticket = _scratch(x.device, stream, blocks)
        err = lib.tr_reduce(x.data_ptr(), n, _DTYPE_CODE[x.dtype],
                            _OP_CODE[op], WG, TS, partials.data_ptr(),
                            ticket.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "tr_reduce")
    reduce_kernel.launches += 1
    return out


reduce_kernel.launches = 0

__all__ = ["reduce_kernel"]
