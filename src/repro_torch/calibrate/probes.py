"""ERT-style microbenchmark probes that fit a :class:`PlatformSpec` (the
port's copy of ``repro.calibrate.probes``).

Four probes, each a *sweep* (raw ``{size -> time}`` samples) and a pure
*fit* (sweep -> one constant), kept apart so the fits are deterministic
and testable on synthetic data:

* **matmul ladder** -> ``peak_flops``: square ``torch.matmul`` products
  (cuBLAS on the card: the probe measures the card's roof, not the
  port's kernel) of rising size; the best achieved FLOP/s across the
  ladder is the empirical compute roof;
* **streaming triad footprint sweep** -> ``hbm_bw``: ``z = x + 1.5 y``
  as ONE kernel (``torch.add(x, y, alpha=1.5, out=z)``: eager
  ``x + 1.5 * y`` is two kernels and five array passes, where the fit
  counts three) over rising working sets; the fit reads the bandwidth
  at the LARGEST footprint, past the caches;
* **tiny-kernel dispatch probe** -> ``dispatch_us``: a scalar add timed
  one launch at a time on the HOST clock, from the launch to the end of
  ``torch.cuda.synchronize()`` — what a serving cost model charges as
  ``dispatch_s`` (CUDA events would time the kernel's ~2 us on the
  device, not the dispatch); the median sample is the fit;
* **collective** -> ``link_bw``: a single-process NCCL all-reduce over
  every local card (``torch.cuda.nccl.all_reduce``, the counterpart of
  the reference's ``pmap`` psum); with fewer than two cards the sweep is
  empty and ``link_bw`` stays at its default, out of ``fitted``.

The matmul and triad sweeps time through
:func:`repro_torch.kernels.common.time_fn` (CUDA events on the card).
Probes run in bf16 on the card and f32 on the CPU, as the reference
probes bf16 on its accelerator and f32 elsewhere.

:func:`run_calibration` runs the probes and returns a calibrated
:class:`PlatformSpec`; :func:`ensure_calibrated` is the load-or-probe
front door (a valid artifact for this device short-circuits the probes).
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import torch

from .spec import (DEFAULT_SPEC, CalibrationError, PlatformSpec,
                   calibrated_replace, device_fingerprint, load_spec,
                   set_platform_spec, spec_path)

# The card's ladders.  The matmul runs 1024-8192: 8192^3 in bf16 is
# 1.1 TFLOP, about 1.5 ms at the tensor cores' roof, long enough that the
# launch is noise (1024^3 is a few microseconds and shows the launch).
# The triad runs 16 MB-4 GB: the H100's L2 is 50 MB, so the footprints
# from 256 MB up stream from HBM, and the fit reads the largest.
MATMUL_SIZES = (1024, 2048, 4096, 8192)
TRIAD_FOOTPRINTS = (1 << 24, 1 << 26, 1 << 28, 1 << 30, 1 << 32)   # bytes
# the reference's ladders, sized for a CPU: the defaults when no card is
# present (the card's 4 GB triad would not fit a small host)
CPU_MATMUL_SIZES = (128, 256, 384, 512)
CPU_TRIAD_FOOTPRINTS = (1 << 20, 4 << 20, 16 << 20, 64 << 20)
# seconds, not minutes, on a CPU: the tests and the plan's "calibrate"
# key.  A card always takes its own ladders: they probe in well under a
# second there, and these sizes would fit its launches and L2, not its
# roofs (0.15 TFLOP/s and 69 GB/s on the H100)
QUICK_MATMUL_SIZES = (64, 128)
QUICK_TRIAD_FOOTPRINTS = (1 << 18, 1 << 20)


def _probe_device() -> torch.device:
    return (torch.device("cuda", 0) if torch.cuda.is_available()
            else torch.device("cpu"))


def _probe_dtype(dev: torch.device) -> torch.dtype:
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# -- sweeps (hardware in the loop) ------------------------------------------


def matmul_flops_sweep(sizes: Sequence[int] = MATMUL_SIZES, *,
                       warmup: int = 1, iters: int = 3
                       ) -> list[dict[str, float]]:
    """Time an ``n x n @ n x n`` matmul per ladder rung; each entry
    carries the rung, its FLOP count (2n^3) and the median us."""

    from ..kernels.common import time_fn
    dev = _probe_device()
    dtype = _probe_dtype(dev)
    out = []
    for n in sizes:
        a = torch.ones((n, n), dtype=dtype, device=dev)
        b = torch.ones((n, n), dtype=dtype, device=dev)
        us = time_fn(lambda: torch.matmul(a, b), device=dev, warmup=warmup,
                     iters=iters)
        out.append({"n": n, "flops": float(2 * n ** 3), "us": us})
        del a, b
    return out


def memory_bw_sweep(footprints: Sequence[int] = TRIAD_FOOTPRINTS, *,
                    warmup: int = 1, iters: int = 3
                    ) -> list[dict[str, float]]:
    """Time a streaming triad ``z = x + 1.5 y`` (one kernel, into a
    preallocated ``z``) per working-set size; each entry carries the
    footprint, the bytes moved (read x, read y, write z) and the median
    us."""

    from ..kernels.common import time_fn
    dev = _probe_device()
    out = []
    for fp in footprints:
        n = max(1, int(fp) // (3 * 4))      # 3 f32 arrays in the set
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        y = torch.ones((n,), dtype=torch.float32, device=dev)
        z = torch.empty_like(x)
        us = time_fn(lambda: torch.add(x, y, alpha=1.5, out=z), device=dev,
                     warmup=warmup, iters=iters)
        out.append({"footprint": float(fp), "bytes": float(3 * n * 4),
                    "us": us})
        del x, y, z
    return out


def dispatch_latency_sweep(reps: int = 16, *, warmup: int = 4
                           ) -> list[float]:
    """Per-dispatch host-clock us of a tiny kernel (a scalar add): each
    sample is ONE launch through its completion (``synchronize`` on the
    card), so the sweep captures the launch-latency distribution rather
    than a throughput average."""

    dev = _probe_device()
    x = torch.zeros((), device=dev)
    for _ in range(max(0, warmup)):
        x + 1.0
    _sync(dev)
    samples = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        x + 1.0
        _sync(dev)
        samples.append((time.perf_counter() - t0) * 1e6)
    return samples


def collective_bw_sweep(sizes: Sequence[int] = (1 << 20,), *,
                        warmup: int = 1, iters: int = 3
                        ) -> list[dict[str, float]]:
    """Time an all-reduce across the local cards (one process, NCCL);
    empty with fewer than two cards, so the fit leaves ``link_bw`` at the
    default and out of the spec's ``fitted`` list."""

    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_dev < 2:
        return []
    from torch.cuda import nccl

    from ..kernels.common import median
    devs = [torch.device("cuda", i) for i in range(n_dev)]

    def sync_all() -> None:
        for d in devs:
            torch.cuda.synchronize(d)

    out = []
    for size in sizes:
        n = max(1, int(size) // 4)
        xs = [torch.ones((n,), dtype=torch.float32, device=d) for d in devs]
        for _ in range(max(0, warmup)):
            nccl.all_reduce(xs)
        sync_all()
        samples = []
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            nccl.all_reduce(xs)
            sync_all()
            samples.append((time.perf_counter() - t0) * 1e6)
        # ring all-reduce moves 2*(n-1)/n of the payload per device
        bytes_per_dev = 2 * (n_dev - 1) / n_dev * n * 4
        out.append({"size": float(size), "devices": n_dev,
                    "bytes_per_device": bytes_per_dev,
                    "us": median(samples)})
    return out


# -- fits (pure, deterministic) ---------------------------------------------


def fit_peak_flops(sweep: Sequence[dict[str, float]]) -> float:
    """Best achieved FLOP/s across the matmul ladder (the ERT reading of
    the compute roof)."""

    if not sweep:
        raise CalibrationError("empty matmul sweep")
    return max(p["flops"] / (p["us"] * 1e-6) for p in sweep)


def fit_bandwidth(sweep: Sequence[dict[str, float]]) -> float:
    """Bytes/s at the LARGEST footprint: the main-memory roof, past the
    caches (small footprints report cache bandwidth)."""

    if not sweep:
        raise CalibrationError("empty memory sweep")
    biggest = max(sweep, key=lambda p: p["bytes"])
    return biggest["bytes"] / (biggest["us"] * 1e-6)


def fit_dispatch_us(samples: Sequence[float]) -> float:
    """Median per-dispatch latency in us."""

    if not samples:
        raise CalibrationError("empty dispatch sweep")
    from ..kernels.common import median
    return median(samples)


def fit_link_bw(sweep: Sequence[dict[str, float]]) -> float | None:
    """Per-link bytes/s from the collective sweep (aggregate achieved
    bandwidth split over the default link count); ``None`` when the probe
    could not run (one card)."""

    if not sweep:
        return None
    best = max(p["bytes_per_device"] / (p["us"] * 1e-6) for p in sweep)
    return best / DEFAULT_SPEC.links


# -- calibration front door --------------------------------------------------


def run_calibration(*, matmul_sizes: Sequence[int] | None = None,
                    footprints: Sequence[int] | None = None,
                    dispatch_reps: int = 16, warmup: int = 1,
                    iters: int = 3, quick: bool = False) -> PlatformSpec:
    """Run every probe and fit a calibrated :class:`PlatformSpec` for the
    running device: the card's ladders on a card, and without one the
    reference's CPU ladders, or with ``quick=True`` the test sizes (same
    probes, smaller working sets)."""

    on_card = _probe_device().type == "cuda"
    quick = quick and not on_card
    if matmul_sizes is None:
        matmul_sizes = (QUICK_MATMUL_SIZES if quick else
                        MATMUL_SIZES if on_card else CPU_MATMUL_SIZES)
    if footprints is None:
        footprints = (QUICK_TRIAD_FOOTPRINTS if quick else
                      TRIAD_FOOTPRINTS if on_card else CPU_TRIAD_FOOTPRINTS)

    mm = matmul_flops_sweep(matmul_sizes, warmup=warmup, iters=iters)
    tr = memory_bw_sweep(footprints, warmup=warmup, iters=iters)
    dp = dispatch_latency_sweep(dispatch_reps)
    co = collective_bw_sweep(warmup=warmup, iters=iters)

    fitted: dict[str, float] = {
        "peak_flops": fit_peak_flops(mm),
        "hbm_bw": fit_bandwidth(tr),
        "dispatch_us": fit_dispatch_us(dp),
    }
    link = fit_link_bw(co)
    if link is not None:
        fitted["link_bw"] = link

    dev = device_fingerprint()
    return calibrated_replace(
        DEFAULT_SPEC, backend=dev["backend"],
        device_kind=dev["device_kind"],
        probes={"matmul": mm, "triad": tr, "dispatch": dp,
                "collective": co, "fitted": sorted(fitted),
                "quick": bool(quick)},
        **fitted)


def ensure_calibrated(path=None, *, force: bool = False,
                      install: bool = True, save: bool = True,
                      quick: bool = False,
                      **probe_kw: Any) -> tuple[PlatformSpec, bool]:
    """Load-or-probe: return ``(spec, probed)`` where ``probed`` says
    whether the probes actually ran.

    A schema-current artifact at ``path`` (default: :func:`spec_path`,
    ``$REPRO_TORCH_PLATFORM_SPEC`` or
    ``~/.cache/repro_torch/platform_spec.json``) calibrated on THIS
    device is a pure load: zero probes.  Otherwise (missing, stale
    schema, foreign device, or ``force=True``) the probes run and the
    fitted spec is written back.  ``install=True`` makes the result the
    process-wide active spec (:func:`set_platform_spec`)."""

    path = spec_path(path)
    if not force:
        try:
            spec = load_spec(path)
            if spec.matches_device():
                if install:
                    set_platform_spec(spec)
                return spec, False
        except (OSError, CalibrationError):
            pass
    spec = run_calibration(quick=quick, **probe_kw)
    if save:
        spec.save(path)
    if install:
        set_platform_spec(spec)
    return spec, True


__all__ = ["MATMUL_SIZES", "TRIAD_FOOTPRINTS", "CPU_MATMUL_SIZES",
           "CPU_TRIAD_FOOTPRINTS", "QUICK_MATMUL_SIZES",
           "QUICK_TRIAD_FOOTPRINTS", "matmul_flops_sweep",
           "memory_bw_sweep", "dispatch_latency_sweep",
           "collective_bw_sweep", "fit_peak_flops", "fit_bandwidth",
           "fit_dispatch_us", "fit_link_bw", "run_calibration",
           "ensure_calibrated"]
