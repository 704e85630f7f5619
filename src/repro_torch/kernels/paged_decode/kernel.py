"""Wrapper of the hand-written CUDA paged decode attention
(``csrc/paged_decode.cu``).

A CUDA tensor launches the kernel (and, when the step is split over
pages, the merge launch after it) and raises on a head dim, group size,
dtype or layout that was not compiled, or if a launch fails; a CPU
tensor takes the plain version, :func:`~.ref.paged_decode_ref`.  A
DTensor raises on any device: no path serves a paged pool on a mesh.
``paged_decode_kernel.calls`` counts the calls that launched, and
``.launches`` their launches.  A call checks its arguments once a
signature (shapes, dtypes, devices, pool layout, window, splits): the
layers of a decode step repeat one.
"""

from __future__ import annotations

import math
import sys

import torch

from .. import _build
from .ref import paged_decode_ref

HEAD_DIMS = (16, 64, 128)
# query heads a kv head (g = H / Hkv), compiled as G = g rounded up to
# one of these; rows past g are computed and not stored
GROUPS = (1, 2, 4, 8)
# page-table entries one split stages in shared memory (the kernel's
# MAX_PAGES)
MAX_PAGES = 4096
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
_INT_MAX = 2**31 - 1


def _is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; none exists before its module is
    imported, and importing it costs a second a process."""

    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           page_table: torch.Tensor, cur_len: torch.Tensor) -> dict:
    """The call's sizes, after the checks every device makes: q (B, H, 1,
    hd), k and v one (P, Hkv, ps, hd) shape, page_table (B, M), cur_len
    (B,), H a multiple of Hkv; a DTensor raises."""

    for t in (q, k, v, page_table, cur_len):
        if _is_dtensor(t):
            raise TypeError("paged decode takes no DTensor: no path serves "
                            "a paged pool on a mesh")
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"need q of (B, H, 1, hd), got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need k and v of one (P, Hkv, ps, hd) shape, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    P, Hkv, ps, kd = k.shape
    if kd != hd or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit the pool "
                         f"{tuple(k.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"need a ({B}, M) page table, got "
                         f"{tuple(page_table.shape)}")
    if tuple(cur_len.shape) != (B,):
        raise ValueError(f"need ({B},) lengths, got {tuple(cur_len.shape)}")
    return {"B": B, "H": H, "hd": hd, "P": P, "Hkv": Hkv, "ps": ps,
            "M": page_table.shape[1], "g": H // Hkv}


def group_rows(g: int) -> int:
    """The compiled row count that serves g query heads a kv head."""

    for G in GROUPS:
        if g <= G:
            return G
    raise ValueError(f"{g} query heads a kv head; at most {GROUPS[-1]} are "
                     f"compiled")


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dims: dict, splits: int,
                      window: int | None) -> None:
    """What the kernel was compiled for, beyond :func:`shapes`: one
    dtype of f32, bf16 or fp16 for q, k and v; a compiled head dim and
    group; whole pools (never copied); at most ``MAX_PAGES`` page-table
    entries a split; positions that fit an int."""

    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"need q, k, v of one dtype in f32, bf16, fp16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dims["hd"] not in HEAD_DIMS:
        raise ValueError(f"head dim {dims['hd']} is not compiled; hd in "
                         f"{HEAD_DIMS}")
    group_rows(dims["g"])
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the pools must be contiguous: a copy would move "
                         "every page")
    if not 1 <= splits <= _INT_MAX // max(1, dims["B"] * dims["Hkv"]):
        raise ValueError(f"bad split count {splits}")
    if math.ceil(dims["M"] / splits) > MAX_PAGES:
        raise ValueError(f"{math.ceil(dims['M'] / splits)} page-table "
                         f"entries a split; at most {MAX_PAGES}")
    if dims["M"] * dims["ps"] > _INT_MAX - MAX_PAGES:
        raise ValueError(f"M * ps = {dims['M'] * dims['ps']} positions do "
                         f"not fit an int")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _signature(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               page_table: torch.Tensor, cur_len: torch.Tensor,
               window: int | None, splits: int) -> tuple:
    """All that :func:`_check_call` reads: the tensors' types, shapes,
    dtypes and devices, the pools' layout, the window and the splits."""

    return (type(q), type(k), type(v), type(page_table), type(cur_len),
            q.shape, k.shape, v.shape, page_table.shape, cur_len.shape,
            q.dtype, k.dtype, v.dtype, q.device, k.device, v.device,
            page_table.device, cur_len.device, k.is_contiguous(),
            v.is_contiguous(), window, splits)


def _check_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                page_table: torch.Tensor, cur_len: torch.Tensor,
                window: int | None, splits: int) -> None:
    """Every check of a CUDA call: :func:`shapes`, one device for all
    five tensors, :func:`check_kernel_args`."""

    dims = shapes(q, k, v, page_table, cur_len)
    if any(t.device != q.device for t in (k, v, page_table, cur_len)):
        raise ValueError("q, the pools, the page table and the lengths "
                         "must be on one device")
    check_kernel_args(q, k, v, dims, splits, window)


# the signatures whose calls passed every check: a decode step calls the
# kernel once a layer with one signature, so its first call pays for the
# checks and the others for the signature alone
_CHECKED: set = set()


def paged_decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        page_table: torch.Tensor, cur_len: torch.Tensor, *,
                        window: int | None, scale: float,
                        splits: int) -> torch.Tensor:
    """q: (B, H, 1, hd); k, v: (P, Hkv, ps, hd) pools; page_table: (B, M),
    -1 = unallocated; cur_len: (B,) -> (B, H, 1, hd) in q's dtype, each
    row split over ``splits`` parts of its live pages."""

    if not q.is_cuda:
        shapes(q, k, v, page_table, cur_len)
        if q.device.type != "cpu":
            raise ValueError(f"unsupported device {q.device}")
        return paged_decode_ref(q, k, v, page_table, cur_len, window=window,
                                scale=scale)
    sig = _signature(q, k, v, page_table, cur_len, window, splits)
    if sig not in _CHECKED:
        _check_call(q, k, v, page_table, cur_len, window, splits)
        _CHECKED.add(sig)
    dev = q.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return paged_decode_kernel(q, k, v, page_table, cur_len,
                                       window=window, scale=scale,
                                       splits=splits)
    q = q.contiguous()
    if page_table.dtype != torch.int32 or page_table.stride(1) != 1:
        page_table = page_table.to(torch.int32).contiguous()
    if cur_len.dtype != torch.int64:
        cur_len = cur_len.to(torch.int64)
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q and the pools must be 16-byte aligned")
    B, H, _, hd = q.shape
    P, Hkv, ps, _ = k.shape
    o = torch.empty_like(q)
    part_o = part_lse = None
    if splits > 1:
        part_o = torch.empty((B, H, splits, hd), dtype=torch.float32,
                             device=q.device)
        part_lse = torch.empty((B, H, splits), dtype=torch.float32,
                               device=q.device)
    # the handle read directly: torch.cuda.current_stream() builds a
    # Stream object, 4 of a call's 22 us of host time (H100 host)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = _build.library().pd_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        page_table.data_ptr(), page_table.stride(0), cur_len.data_ptr(),
        cur_len.stride(0), B, H, Hkv, hd, ps, page_table.shape[1], P,
        _DTYPE_CODE[q.dtype], int(window is not None),
        min(window, _INT_MAX) if window is not None else 0, scale, splits,
        part_o.data_ptr() if part_o is not None else None,
        part_lse.data_ptr() if part_lse is not None else None,
        stream)
    _build.check(err, "pd_decode")
    paged_decode_kernel.calls += 1
    paged_decode_kernel.launches += 2 if splits > 1 else 1
    return o


paged_decode_kernel.calls = 0
paged_decode_kernel.launches = 0

__all__ = ["paged_decode_kernel", "paged_decode_ref", "shapes",
           "check_kernel_args", "group_rows", "HEAD_DIMS", "GROUPS",
           "MAX_PAGES"]
