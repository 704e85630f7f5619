#!/usr/bin/env python3
"""What the ``flash_attention`` kernels (bf16 and f32) compile to and how
fast each of their tiles runs, on one CUDA card.

    PYTHONPATH=src python3 tools/flash_report.py [--out report.json]

Prints one JSON line per part and writes them all to ``--out``
(default ``build/flash_report.json`` at the checkout's root):

1. ``ptxas``  — registers, spills and warnings (C7515: wgmma serialised
   around an accumulator touched in flight; C7512: serialised for lack of
   registers) of every bf16 instantiation in ``csrc/flash_attention.cu``;
2. ``sass``   — per bf16 kernel, the count of each instruction that shows
   the design (HGMMA: wgmma; UTMALDG: TMA loads; SYNCS: mbarriers; BAR:
   named barriers; MUFU.EX2: the softmax's 2^x), from ``cuobjdump -sass``
   of the built library, with one sample line of each;
3. ``tile``   — each bf16 tile at qwen1.5-4b's shape (1, 20, 4096, 128),
   causal and not: its time, TFLOP/s of the visible pairs, rel L2
   against the plain version, the cost model's time and
   ``scaled_dot_product_attention``'s time on the same inputs.  Times
   are CUDA events over bursts of back-to-back calls, the tiles and the
   library call in rotated turns, ROUNDS bursts each: the median and the
   least (the card slows its clock under sustained load, so a burst's
   place in the run moves it);
4. ``fit``    — per block_k, the time of one block's k-block and its fixed
   cost, solved from the two masks' medians with the blocks spread evenly
   over the SMs (the cost model's ``_WG_STEP_US`` and ``_WG_BLOCK_US``);
5. ``f32_ptxas``, ``f32_sass`` — the same for the f32 FMA kernel (FFMA,
   LDS.128, LDGSTS: cp.async, BAR.SYNC, MUFU.EX2, SHFL.BFLY);
6. ``f32_tile`` — each f32 tile at (1, 20, 1024, 64) and at
   (1, 20, 4096, 128), causal and not, beside
   ``scaled_dot_product_attention`` in rotated turns, with the SM clock
   ``nvidia-smi`` reads before and after each shape's turns;
7. ``f32_fit`` — per head dim and f32 tile, the SM time of one block's
   k-block and its fixed cost, solved as in 4 from that head dim's shape
   (blocks that share an SM split its rate; the cost model's
   ``_F32_STEP_US`` and ``_F32_BLOCK_US``).

The card's name and power limit come first.  Exits non-zero without a
card, or if a tile's rel L2 exceeds 1e-2.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPE = (1, 20, 4096, 128)
REL_L2 = 1e-2
ROUNDS = 7
MARKERS = ("HGMMA", "UTMALDG", "SYNCS", "BAR.SYNC", "BAR.ARV", "STG.E.128",
           "MUFU.EX2")
F32_MARKERS = ("FFMA", "LDS.128", "LDGSTS", "BAR.SYNC", "MUFU.EX2",
               "SHFL.BFLY", "STG.E.128")
# (shape, causal): the f32 cases of chip_smoke.py, each also without the
# causal mask (the fit's two equations at each head dim)
F32_SHAPES = ((1, 20, 1024, 64), (1, 20, 4096, 128))
F32_CASES = tuple((shape, causal) for shape in F32_SHAPES
                  for causal in (True, False))


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


def sass_counts(so: Path, kernel: str = "fa_bf16",
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
    from repro_torch.kernels.common import SMS
    from repro_torch.kernels.flash_attention.kernel import TILES
    from repro_torch.kernels.flash_attention.ops import (attention_ref,
                                                         cost_model,
                                                         flash_attention,
                                                         visible_pairs,
                                                         visited_blocks)

    fa = info.ptxas.get("flash_attention.cu", [])
    emit("f32_ptxas", usage={k: v for k, v in _build.ptxas_usage(fa).items()
                             if "fa_f32" in k})
    emit("f32_sass", kernels=sass_counts(info.path, "fa_f32", F32_MARKERS))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tiles = [(bq, bk) for bq in TILES[4]["block_q"]
             for bk in TILES[4]["block_k"]]
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    ok = True
    times = {}
    for shape, causal in F32_CASES:
        B, H, S, D = shape
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for _ in range(3))
        want = attention_ref(q, k, v, causal=causal)
        err = {}
        for bq, bk in tiles:
            diff = (flash_attention(q, k, v, causal=causal, block_q=bq,
                                    block_k=bk) - want).abs()
            err[(bq, bk)] = float(diff.max())
            ok &= bool((diff <= 2e-4 + 2e-5 * want.abs()).all())
        del want, diff
        runs = {"library": lambda: sdpa(q, k, v, is_causal=causal)}
        for bq, bk in tiles:
            runs[(bq, bk)] = lambda bq=bq, bk=bk: flash_attention(
                q, k, v, causal=causal, block_q=bq, block_k=bk)
        names = list(runs)
        bursts: dict = {n: [] for n in names}
        before = smi("clocks.sm,power.draw,temperature.gpu")
        for r in range(ROUNDS):
            for n in names[r % len(names):] + names[:r % len(names)]:
                bursts[n].append(time_ms(runs[n], iters=5, warmup=1))
        after = smi("clocks.sm,power.draw,temperature.gpu")
        med = {n: sorted(b)[len(b) // 2] for n, b in bursts.items()}
        flops = 4 * B * H * visible_pairs(S, causal) * D
        for bq, bk in tiles:
            cfg = {"block_q": bq, "block_k": bk}
            times[(shape, causal, bq, bk)] = med[(bq, bk)]
            emit("f32_tile", shape=list(shape), causal=causal, config=cfg,
                 ms=med[(bq, bk)], least_ms=min(bursts[(bq, bk)]),
                 tflops=flops / med[(bq, bk)] / 1e9,
                 max_abs_err=err[(bq, bk)], library_ms=med["library"],
                 library_least_ms=min(bursts["library"]),
                 ratio=med[(bq, bk)] / med["library"],
                 modeled_ms=cost_model(cfg, S=S, D=D, BH=B * H,
                                       causal=causal, dtype_bytes=4) / 1e3,
                 sm_clock_before=before, sm_clock_after=after)
        del q, k, v
        torch.cuda.empty_cache()

    # as part 4, at each head dim's shape, in SM time: blocks that share
    # an SM split its rate, so t * SMS = step * k-blocks + fixed * blocks
    # whatever the residency; a negative fixed cost is fitted as 0 (the
    # least-squares step through the origin)
    fits = {}
    for shape in F32_SHAPES:
        _, BH, S, D = shape
        for bq, bk in tiles:
            steps = {c: BH * visited_blocks(S, bq, bk, c)
                     for c in (True, False)}
            t = {c: times[(shape, c, bq, bk)] * 1e3 * SMS
                 for c in (True, False)}
            step_us = (t[False] - t[True]) / (steps[False] - steps[True])
            block_us = (t[True] - step_us * steps[True]) / (BH * S // bq)
            if block_us < 0:
                block_us = 0.0
                step_us = sum(t[c] * steps[c] for c in t) / sum(
                    steps[c] ** 2 for c in t)
            fits[f"D={D} {bq}x{bk}"] = {"step_us": step_us,
                                        "block_us": block_us}
    emit("f32_fit", per_tile=fits)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "flash_report.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_report: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import SMS
    from repro_torch.kernels.flash_attention.kernel import TILES
    from repro_torch.kernels.flash_attention.ops import (attention_ref,
                                                         cost_model,
                                                         flash_attention,
                                                         visible_pairs,
                                                         visited_blocks)

    lines: list[dict] = []

    def emit(part: str, **fields) -> None:
        lines.append({"part": part, **fields})
        print(json.dumps(lines[-1]), flush=True)

    emit("device", name=torch.cuda.get_device_name(0),
         nvidia_smi=smi("name,power.limit"))

    _build.library()
    info = _build.build_info()
    fa = info.ptxas.get("flash_attention.cu", [])
    usage = {k: v for k, v in _build.ptxas_usage(fa).items()
             if "fa_bf16" in k}
    warnings = [ln for ln in fa if "warning" in ln or "Performance" in ln]
    emit("ptxas", nvcc_s=info.seconds, usage=usage, warnings=warnings,
         c7515=sum("C7515" in ln for ln in warnings))
    emit("sass", kernels=sass_counts(info.path))

    B, H, S, D = SHAPE
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=g, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bks = TILES[2]["block_k"]
    times: dict[tuple[int, bool], float] = {}
    ok = True
    for causal in (True, False):
        want = attention_ref(q, k, v, causal=causal).float()
        rel = {}
        for bk in bks:
            got = flash_attention(q, k, v, causal=causal, block_q=128,
                                  block_k=bk).float()
            rel[bk] = float((got - want).norm() / want.norm())
            ok &= rel[bk] <= REL_L2
        del want, got
        runs = {"library": lambda: sdpa(q, k, v, is_causal=causal)}
        for bk in bks:
            runs[bk] = lambda bk=bk: flash_attention(
                q, k, v, causal=causal, block_q=128, block_k=bk)
        names = list(runs)
        bursts: dict = {n: [] for n in names}
        for r in range(ROUNDS):
            for n in names[r % len(names):] + names[:r % len(names)]:
                bursts[n].append(time_ms(runs[n], iters=10, warmup=2))
        med = {n: sorted(b)[len(b) // 2] for n, b in bursts.items()}
        flops = 4 * B * H * visible_pairs(S, causal) * D
        for bk in bks:
            times[(bk, causal)] = med[bk]
            cfg = {"block_q": 128, "block_k": bk}
            emit("tile", shape=list(SHAPE), causal=causal, config=cfg,
                 ms=med[bk], least_ms=min(bursts[bk]),
                 tflops=flops / med[bk] / 1e9, rel_l2=rel[bk],
                 library_ms=med["library"],
                 library_least_ms=min(bursts["library"]),
                 modeled_ms=cost_model(cfg, S=S, D=D, BH=B * H,
                                       causal=causal) / 1e3)

    # t = (step * k-blocks + fixed * blocks) / SMS, the blocks spread
    # evenly over the SMs; the two masks give two equations per block_k
    fits = {}
    blocks = B * H * S // 128
    for bk in bks:
        steps = {c: B * H * visited_blocks(S, 128, bk, c) for c in (True,
                                                                   False)}
        t = {c: times[(bk, c)] * 1e3 * SMS for c in (True, False)}
        step_us = (t[False] - t[True]) / (steps[False] - steps[True])
        fits[bk] = {"step_us": step_us,
                    "block_us": (t[True] - step_us * steps[True]) / blocks}
    emit("fit", per_block_k=fits)
    del q, k, v
    torch.cuda.empty_cache()
    ok &= f32_section(emit, info)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    if not ok:
        print(f"flash_report: a tile exceeded rel L2 {REL_L2} (bf16) or "
              f"the f32 tolerance", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
