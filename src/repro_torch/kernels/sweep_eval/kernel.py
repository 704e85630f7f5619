"""Wrapper of the hand-written CUDA sweep-eval kernel
(``csrc/sweep_eval.cu``).

A CUDA tensor launches the kernel and raises if the launch fails; a CPU
tensor takes the plain version, :func:`~.ref.sweep_ref`.  The wave
parameters are kernel arguments, so one build serves every platform;
the kernel divides by the three that are the same for every point (NP,
U = ND·NU and warp) through magic numbers, which :func:`magic_u31`
computes here, on the host, once per :class:`WaveParams`.
``sweep_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from ...core.wave_model import WaveParams
from .. import _build
from .ref import sweep_ref

_INT32_MAX = 2**31 - 1


def magic_u31(d: int) -> tuple[int, int]:
    """Magic numbers ``(m, s)`` for dividing by ``d`` in [1, 2^31): for
    every ``a`` in [0, 2^31), ``a // d == (umulhi(a, m) if m else a) >> s``
    with ``umulhi(a, m) = (a * m) >> 32`` (Granlund and Montgomery).

    A power of two ``2^k`` is the shift ``(0, k)``.  Otherwise, with
    ``l = ceil(log2 d)``, ``m = ceil(2^(31+l) / d)`` fits 32 bits and
    ``s = l - 1``: m·d exceeds 2^(31+l) by e < d, so a·m / 2^(31+l)
    overshoots a/d by a·e / (d·2^(31+l)) < 1/d, too little to reach the
    next integer."""

    if not 1 <= d <= _INT32_MAX:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    if d & (d - 1) == 0:
        return 0, d.bit_length() - 1
    l = d.bit_length()
    return -(-(1 << (31 + l)) // d), l - 1


@functools.lru_cache(maxsize=64)
def _launch_params(p: WaveParams) -> tuple[int, ...]:
    """The kernel's wave arguments: size, NP, GMT, L, U, warp (0: none)
    and the magic numbers of NP, U and warp."""

    U, warp = p.ND * p.NU, p.warp or 0
    params = (p.size, p.NP, p.GMT, p.L, U, warp)
    if not all(0 <= v <= _INT32_MAX for v in params) or p.NP < 1 or U < 1:
        raise ValueError(f"wave parameters out of the kernel's int32 range: {p}")
    return (*params, *magic_u31(p.NP), *magic_u31(U), *magic_u31(max(1, warp)))


def sweep_kernel(wg: torch.Tensor, ts: torch.Tensor, p: WaveParams,
                 threads: int, ept: int) -> torch.Tensor:
    """§7 Minimum model time (int32) for each (wg[i], ts[i]); blocks of
    ``threads`` threads evaluate ``ept`` vectors of 4 configurations a
    thread."""

    if p.kind != "minimum":
        raise ValueError("the kernel implements the §7 Minimum model")
    if wg.shape != ts.shape or wg.dim() != 1 or wg.numel() < 1:
        raise ValueError(f"need equal non-empty 1-D wg/ts, got "
                         f"{tuple(wg.shape)} and {tuple(ts.shape)}")
    if wg.device != ts.device:
        raise ValueError("wg and ts must be on one device")
    params = _launch_params(p)
    if not (1 <= threads <= 1024 and ept >= 1):
        raise ValueError(f"bad launch parameters threads={threads} ept={ept}")
    wg = wg.to(torch.int32).contiguous()
    ts = ts.to(torch.int32).contiguous()
    if wg.device.type == "cpu":
        return sweep_ref(p, wg, ts)
    if wg.device.type != "cuda":
        raise ValueError(f"unsupported device {wg.device}")
    lib = _build.library()
    out = torch.empty_like(wg)
    with torch.cuda.device(wg.device):
        err = lib.se_sweep_eval(wg.data_ptr(), ts.data_ptr(), out.data_ptr(),
                                wg.numel(), *params, threads, ept,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "se_sweep_eval")
    sweep_kernel.launches += 1
    return out


sweep_kernel.launches = 0


def point_instructions(table: bool) -> int:
    """SASS instructions of one configuration on the kernel's fast path:
    the never-launched probe kernel of ``csrc/sweep_eval.cu``
    (``sweep_point_probe``; ``table``: gmt_eff read from the table, as
    with warp scheduling and NP <= 1024, else the constant GMT), counting
    its two loads and its store, without NOPs and the closing self-branch.
    Needs the toolkit's ``cuobjdump``; builds the library if need be."""

    fns = _build.sass(_build.build().path)
    name = next(f for f in fns
                if "sweep_point_probe" in f and f"ILi{int(table)}E" in f)
    instrs = [i for i in fns[name] if not i.startswith("NOP")]
    while instrs and instrs[-1].startswith("BRA"):
        instrs.pop()
    return len(instrs)


__all__ = ["sweep_kernel", "magic_u31", "point_instructions"]
