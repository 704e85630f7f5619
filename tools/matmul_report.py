#!/usr/bin/env python3
"""What the ``matmul_tuned`` kernels (bf16 and f32) compile to and how
fast each of their tiles runs, on one CUDA card.

    PYTHONPATH=src python3 tools/matmul_report.py [--out report.json]

Prints one JSON line per part and writes them all to ``--out``
(default ``build/matmul_report.json`` at the checkout's root):

1. ``ptxas``  — registers, spills and warnings of every kernel in
   ``csrc/matmul_tuned.cu``;
2. ``sass``   — per bf16 kernel, the count of each instruction that shows
   the design (HGMMA: wgmma; UTMALDG: TMA loads; SYNCS: mbarriers;
   USETMAXREG: setmaxnreg), from ``cuobjdump -sass`` of the built library,
   with one sample line of each;
3. ``tile``   — each bf16 tile at 8192 x 8192 x K for K in 1024 and 8192:
   its time, TFLOP/s, rel L2 against the plain version, the cost model's
   time and ``torch.matmul``'s time on the same operands.  Times are
   CUDA events over bursts of back-to-back calls, the tiles and
   ``torch.matmul`` in turns, ROUNDS bursts each: the median and the
   least (the card slows its clock under sustained load, so a burst's
   place in the run moves it);
4. ``fit``    — per bn, the time of one block's K step and of one tile's
   epilogue solved from the two K's medians (the cost model's
   ``_WG_STEP_US`` and ``_WG_EPILOGUE_US``);
5. ``f32_ptxas``, ``f32_sass`` — the same for the f32 FMA kernel
   (FFMA, LDS.128, LDGSTS: cp.async, BAR.SYNC);
6. ``f32_tile`` — each f32 tile at 4096 x 4096 x K for K in 1024 and
   4096 beside ``torch.matmul`` (TF32 off), in rotated turns, with the SM
   clock ``nvidia-smi`` reads before and after each K's turns;
7. ``f32_fit`` — the f32 cost model's per-K-step cost (``_STEP_US``):
   the least-squares fit of what each tile's median takes beyond the
   flops at 67 TFLOP/s (or the streamed bytes), over its K steps.

The card's name and power limit come first.  Exits non-zero without a
card, or if a tile's rel L2 exceeds 1e-2.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KS = (1024, 8192)
MN = 8192
REL_L2 = 1e-2
ROUNDS = 5
MARKERS = ("HGMMA", "UTMALDG", "SYNCS", "USETMAXREG", "STG.E.128", "BAR.SYNC")
F32_MARKERS = ("FFMA", "LDS.128", "LDGSTS", "BAR.SYNC", "STG.E.128")
F32_MN = 4096
F32_KS = (1024, 4096)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sass_counts(so: Path, kernel: str = "mm_bf16",
                markers: tuple[str, ...] = MARKERS) -> dict[str, dict]:
    """Instruction counts of each ``kernel`` instantiation in
    ``cuobjdump -sass``."""

    from repro_torch.kernels._build import sass
    out: dict[str, dict] = {}
    for fn, instrs in sass(so).items():
        if kernel not in fn:
            continue
        out[fn] = {"instructions": len(instrs),
                   "counts": {mk: sum(mk in i for i in instrs)
                              for mk in markers},
                   "sample": {mk: next(i for i in instrs if mk in i)
                              for mk in markers
                              if any(mk in i for i in instrs)}}
    return out


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def f32_section(emit, info) -> bool:
    """Parts 5-7: the f32 FMA kernel; False if a tile misses its
    tolerance."""

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import (F32_FLOPS, HBM_BYTES_PER_S,
                                            LAUNCH_US, SMS)
    from repro_torch.kernels.matmul_tuned.ops import (cost_model, matmul_ref,
                                                      matmul_tuned,
                                                      tuning_space)

    mm = info.ptxas.get("matmul_tuned.cu", [])
    emit("f32_ptxas", usage={k: v for k, v in _build.ptxas_usage(mm).items()
                             if "mm_f32" in k})
    emit("f32_sass", kernels=sass_counts(info.path, "mm_f32", F32_MARKERS))
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    ok = True
    points = []
    for K in F32_KS:
        M = N = F32_MN
        a = torch.randn(M, K, generator=g, device="cuda")
        b = torch.randn(K, N, generator=g, device="cuda")
        want = matmul_ref(a, b)
        cfgs = list(tuning_space(M, N, K, dtype_bytes=4))
        err = {}
        for cfg in cfgs:
            diff = (matmul_tuned(a, b, **cfg) - want).abs()
            key = (cfg["bm"], cfg["bn"], cfg["bk"])
            err[key] = float(diff.max())
            ok &= bool((diff <= 2e-3 * K ** 0.5 + 2e-3 * want.abs()).all())
        runs = {"library": lambda: torch.matmul(a, b)}
        for cfg in cfgs:
            runs[(cfg["bm"], cfg["bn"], cfg["bk"])] = \
                lambda cfg=cfg: matmul_tuned(a, b, **cfg)
        names = list(runs)
        bursts: dict = {n: [] for n in names}
        before = smi("clocks.sm,power.draw,temperature.gpu")
        for r in range(ROUNDS):
            for n in names[r % len(names):] + names[:r % len(names)]:
                bursts[n].append(time_ms(runs[n], iters=5, warmup=1))
        after = smi("clocks.sm,power.draw,temperature.gpu")
        med = {n: sorted(v)[len(v) // 2] for n, v in bursts.items()}
        compute_us = 2 * M * N * K / F32_FLOPS * 1e6
        for cfg in cfgs:
            key = (cfg["bm"], cfg["bn"], cfg["bk"])
            bm, bn, bk = key
            streamed = (M * K * (N // bn) + K * N * (M // bm) + M * N) * 4
            base = max(compute_us, streamed / HBM_BYTES_PER_S * 1e6)
            steps = (M // bm) * (N // bn) * (K // bk)
            points.append((med[key] * 1e3 - base - LAUNCH_US, steps / SMS))
            emit("f32_tile", shape=[M, N, K], config=cfg, ms=med[key],
                 least_ms=min(bursts[key]),
                 tflops=2 * M * N * K / med[key] / 1e9,
                 max_abs_err=err[key], library_ms=med["library"],
                 library_least_ms=min(bursts["library"]),
                 ratio=med[key] / med["library"],
                 modeled_ms=cost_model(cfg, M=M, N=N, K=K,
                                       dtype_bytes=4) / 1e3,
                 sm_clock_before=before, sm_clock_after=after)
        del a, b, want
        torch.cuda.empty_cache()
    # t - max(flops, bytes) - launch = step * steps / SMS, least squares
    step = sum(r * s for r, s in points) / sum(s * s for _, s in points)
    emit("f32_fit", step_us=step, points=len(points))
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=str(ROOT / "build" / "matmul_report.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("matmul_report: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import SMS
    from repro_torch.kernels.matmul_tuned.kernel import TILES
    from repro_torch.kernels.matmul_tuned.ops import (cost_model, matmul_ref,
                                                      matmul_tuned)

    lines: list[dict] = []

    def emit(part: str, **fields) -> None:
        lines.append({"part": part, **fields})
        print(json.dumps(lines[-1]), flush=True)

    emit("device", name=torch.cuda.get_device_name(0),
         nvidia_smi=smi("name,power.limit"))

    _build.library()
    info = _build.build_info()
    mm = info.ptxas.get("matmul_tuned.cu", [])
    emit("ptxas", nvcc_s=info.seconds, usage=_build.ptxas_usage(mm),
         warnings=[ln for ln in mm if "warning" in ln or "Performance" in ln])
    emit("sass", kernels=sass_counts(info.path))

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    times: dict[tuple[int, int], float] = {}
    ok = True
    for K in KS:
        a = torch.randn(MN, K, generator=g, device="cuda").to(torch.bfloat16)
        b = torch.randn(K, MN, generator=g, device="cuda").to(torch.bfloat16)
        want = matmul_ref(a, b).float()
        cfgs = [{"bm": 128, "bn": bn, "bk": 64} for bn in TILES[2]["bn"]]
        rel = {}
        for cfg in cfgs:
            got = matmul_tuned(a, b, **cfg).float()
            rel[cfg["bn"]] = float((got - want).norm() / want.norm())
            ok &= rel[cfg["bn"]] <= REL_L2
        runs = {"library": lambda: torch.matmul(a, b)}
        for cfg in cfgs:
            runs[cfg["bn"]] = lambda cfg=cfg: matmul_tuned(a, b, **cfg)
        bursts: dict = {k: [] for k in runs}
        for _ in range(ROUNDS):
            for k, fn in runs.items():
                bursts[k].append(time_ms(fn, iters=10, warmup=2))
        med = {k: sorted(v)[len(v) // 2] for k, v in bursts.items()}
        for cfg in cfgs:
            bn = cfg["bn"]
            times[(bn, K)] = med[bn]
            emit("tile", shape=[MN, MN, K], config=cfg, ms=med[bn],
                 least_ms=min(bursts[bn]),
                 tflops=2 * MN * MN * K / med[bn] / 1e9,
                 rel_l2=rel[bn], library_ms=med["library"],
                 library_least_ms=min(bursts["library"]),
                 modeled_ms=cost_model(cfg, M=MN, N=MN, K=K) / 1e3)
        del a, b, want, got
        torch.cuda.empty_cache()

    fits = {}
    for bn in TILES[2]["bn"]:
        waves = math.ceil((MN // 128) * (MN // bn) / SMS)
        (k0, k1) = KS
        per_tile = {K: times[(bn, K)] * 1e3 / waves for K in KS}
        step_us = (per_tile[k1] - per_tile[k0]) / ((k1 - k0) // 64)
        epilogue_us = per_tile[k0] - (k0 // 64) * step_us
        fits[bn] = {"waves": waves, "step_us": step_us,
                    "epilogue_us": epilogue_us}
    emit("fit", per_bn=fits)
    ok &= f32_section(emit, info)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    if not ok:
        print(f"matmul_report: a tile exceeded rel L2 {REL_L2} (bf16) or "
              f"the f32 tolerance", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
