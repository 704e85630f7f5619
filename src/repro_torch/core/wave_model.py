"""Closed-form wave-timing model of the abstract platform.

The port's copy of ``repro.core.wave_model``:

* ``items = size // TS`` work items, grouped into workgroups of ``WG``
  (last group may be short),
* a unit executes its groups sequentially; a group of ``cnt`` items runs
  in ``ceil(cnt / NP)`` waves of at most NP resident elements,
* abstract kernel wave time  C = items·(GMT·TS + TS) + GMT,
* minimum kernel wave time   GMT·TS, plus a per-group epilogue
  ``(min(cnt, NP) − 1) + GMT`` and a host-side final reduction of one
  unit per group,
* optional per-group launch overhead ``L``,
* ND·NU units take groups round-robin; total time is the max over units.

``model_time`` is the exact integer scalar form; ``model_time_torch`` is
the tensor form (the counterpart of ``model_time_jnp``) — identical
formulas over tensors, in int64 by default.  Division and remainder use
floor semantics (``torch.div(..., rounding_mode="floor")``,
``torch.remainder``) so the results match Python's and jnp's ``//``/``%``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _cdiv(a, b):
    return -(-a // b)


@dataclass(frozen=True)
class WaveParams:
    size: int
    NP: int = 4
    GMT: int = 4
    L: int = 0
    kind: str = "abstract"   # "abstract" | "minimum"
    ND: int = 1
    NU: int = 1
    # Warp-based scheduling (the paper's §8 planned extension): resident
    # elements execute in warps of this size; multiple resident warps
    # hide global-memory latency, dividing the effective GMT (down to 1).
    warp: int | None = None

    def gmt_eff(self, resident: int) -> int:
        if self.warp is None:
            return self.GMT
        n_warps = max(1, -(-resident // self.warp))
        return max(1, -(-self.GMT // n_warps))

    @classmethod
    def from_platform(cls, size: int, *, spec=None, el_bytes: int = 4,
                      **kw) -> "WaveParams":
        """Wave parameters whose GMT ratio is derived from a MEASURED
        platform (:func:`gmt_from_spec`) instead of the default 4 — the
        bridge from :class:`repro_torch.calibrate.PlatformSpec` (physical
        constants) to the abstract process model's memory ratio."""

        return cls(size=size, GMT=gmt_from_spec(spec, el_bytes=el_bytes),
                   **kw)


def gmt_from_spec(spec=None, *, el_bytes: int = 4) -> int:
    """The abstract GMT ratio (global-memory time per unit compute)
    implied by a measured platform: how many element-sized FLOPs the
    device completes in the time one element streams from main memory —
    ``peak_flops * el_bytes / hbm_bw``, floored at 1.  ``spec=None``
    resolves the active :func:`repro_torch.calibrate.get_platform_spec`,
    so a calibration artifact reshapes the abstract platform too.

    On the H100 that ratio is about 1,000-1,200 where the default is 4,
    so model times grow ~250x: the int32 sweep kernel holds them only on
    small lattices (``size * GMT`` must stay under 2^31)."""

    if spec is None:
        from ..calibrate.spec import get_platform_spec
        spec = get_platform_spec()
    return max(1, round(spec.peak_flops * el_bytes / spec.hbm_bw))


def _group_structure(size: int, WG: int, TS: int):
    items = size // TS
    full = items // WG
    rem = items % WG
    g_total = full + (1 if rem else 0)
    return items, full, rem, g_total


def _wave_time(p: WaveParams, TS: int, items: int, resident: int) -> int:
    g = p.gmt_eff(resident)
    if p.kind == "abstract":
        return items * (g * TS + TS) + g
    return g * TS


def _group_time(p: WaveParams, cnt: int, TS: int, items: int) -> int:
    waves = _cdiv(cnt, p.NP)
    resident = min(cnt, p.NP)
    t = waves * _wave_time(p, TS, items, resident)
    if p.kind == "minimum":
        t += (resident - 1) + p.gmt_eff(resident)
    return t + p.L


def model_time(p: WaveParams, WG: int, TS: int) -> int:
    """Exact model termination time for one configuration."""

    items, full, rem, g_total = _group_structure(p.size, WG, TS)
    if items < 1:
        raise ValueError("TS larger than size: no work items")
    if full == 0:            # single short group
        full, rem = 0, items
        g_total = 1

    U = p.ND * p.NU
    t_full = _group_time(p, min(WG, items), TS, items)
    t_rem = _group_time(p, rem, TS, items) if rem else 0

    # round-robin assignment: unit 0 is the fullest; the remainder group
    # (index g_total-1) lands on unit (g_total-1) % U.
    count0 = _cdiv(g_total, U)
    if rem:
        r = (g_total - 1) % U
        count_r = _cdiv(g_total - r, U)
        t0 = count0 * t_full - (t_full - t_rem) * (1 if r == 0 else 0)
        tr = count_r * t_full - (t_full - t_rem)
        device_t = max(t0, tr)
    else:
        device_t = count0 * t_full

    host_t = g_total if p.kind == "minimum" else 0
    return device_t + host_t


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _tcdiv(a: torch.Tensor, b) -> torch.Tensor:
    return -_fdiv(-a, b)


def model_time_torch(p: WaveParams, WG, TS, *,
                     dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Tensor twin of :func:`model_time` (same formulas), elementwise
    over ``WG``/``TS`` on their device.

    Computes in ``dtype``: int64 by default (exact for every lattice the
    repo tunes); ``torch.int32`` reproduces the int32 arithmetic of the
    sweep-eval kernel, wraparound included.

    Invalid points follow the exact engine (``core/sweep.py``
    ``sweep_times``): a configuration with no work item (TS <= 0, or
    ``size // TS < 1``) gets ``iinfo(dtype).max``; WG is clamped to 1
    only as the divisor of ``items``, and enters ``min(WG, items)`` and
    the group times as it is."""

    WG = torch.as_tensor(WG).to(dtype)
    TS = torch.as_tensor(TS, device=WG.device).to(dtype)
    NP, GMT = p.NP, p.GMT

    has_ts = TS >= 1
    TS = torch.where(has_ts, TS, 1)     # a defined division; masked below
    items = _fdiv(torch.full_like(TS, p.size), TS)
    WG_div = WG.clamp(min=1)
    full = _fdiv(items, WG_div)
    rem = torch.remainder(items, WG_div)
    # single short group when items < WG
    short = full == 0
    full = torch.where(short, 0, full)
    rem = torch.where(short, items, rem)
    g_total = full + (rem > 0).to(dtype)

    cnt_full = torch.minimum(WG, items)

    def gmt_eff(resident):
        if p.warp is None:
            return torch.full_like(resident, GMT)
        n_warps = torch.clamp(_tcdiv(resident, p.warp), min=1)
        return torch.clamp(_tcdiv(torch.full_like(resident, GMT), n_warps),
                           min=1)

    def wave_time(its, resident):
        g = gmt_eff(resident)
        if p.kind == "abstract":
            return its * (g * TS + TS) + g
        return g * TS

    def group_time(cnt):
        waves = _tcdiv(cnt, NP)
        resident = torch.clamp(cnt, max=NP)
        t = waves * wave_time(items, resident)
        if p.kind == "minimum":
            t = t + (resident - 1) + gmt_eff(resident)
        return t + p.L

    U = p.ND * p.NU
    t_full = group_time(cnt_full)
    t_rem = torch.where(rem > 0, group_time(torch.clamp(rem, min=1)), 0)

    count0 = _tcdiv(g_total, U)
    r = torch.remainder(g_total - 1, U)
    count_r = _tcdiv(g_total - r, U)
    t0 = count0 * t_full - torch.where(r == 0, t_full - t_rem, 0)
    tr = count_r * t_full - (t_full - t_rem)
    device_t = torch.where(rem > 0, torch.maximum(t0, tr), count0 * t_full)

    t = device_t + (g_total if p.kind == "minimum" else 0)
    # invalid configs (no work items) get the +inf-like sentinel
    return torch.where(has_ts & (items >= 1), t, torch.iinfo(dtype).max)


__all__ = ["WaveParams", "gmt_from_spec", "model_time", "model_time_torch"]
