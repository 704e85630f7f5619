#!/usr/bin/env python3
"""What the bf16 ``matmul_tuned`` kernel compiles to and how fast each of
its tiles runs, on one CUDA card.

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
   ``_WG_STEP_US`` and ``_WG_EPILOGUE_US``).

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


def sass_counts(so: Path) -> dict[str, dict]:
    """Instruction counts of each bf16 kernel in ``cuobjdump -sass``."""

    from repro_torch.kernels._build import sass
    out: dict[str, dict] = {}
    for fn, instrs in sass(so).items():
        if "mm_bf16" not in fn:
            continue
        out[fn] = {"counts": {mk: sum(mk in i for i in instrs)
                              for mk in MARKERS},
                   "sample": {mk: next(i for i in instrs if mk in i)
                              for mk in MARKERS
                              if any(mk in i for i in instrs)}}
    return out


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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)

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

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    if not ok:
        print(f"matmul_report: a tile exceeded rel L2 {REL_L2}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
