#!/usr/bin/env python3
"""What the ``tuned_reduction`` and ``sweep_eval`` kernels compile to and
how fast they run, on one CUDA card.

    PYTHONPATH=src python3 tools/reduce_sweep_report.py [--out report.json]

Prints one JSON line per part and writes them all to ``--out`` (default
``build/reduce_sweep_report.json`` at the checkout's root):

1. ``ptxas``  — registers and spills of every kernel entry in
   ``csrc/tuned_reduction.cu`` and ``csrc/sweep_eval.cu``;
2. ``sass``   — per kernel, its instruction count and the count of the
   instructions that show the design (LDG.E.128: 16-byte loads; IMAD.HI:
   multiply-high, the magic-number divisions; MUFU.RCP: the reciprocal
   inside a division by a runtime divisor; REDUX: a warp's int32 fold;
   SHFL.BFLY: a float warp fold), from ``cuobjdump -sass``; and the
   sweep's instructions per configuration on its fast path (the probe
   kernel), with the gmt_eff table and with a constant GMT;
3. ``reduce`` — the nine (dtype, op) cases at n = 2^28 with the cost
   model's (WG, TS), and a bf16 sum over an unaligned view, each beside
   ``torch.amin`` / ``torch.amax`` / ``torch.sum`` on the same tensor
   (the sum in x's dtype: by default it widens int32 to int64).
   Times are CUDA events over bursts of back-to-back calls, the kernel
   and the library call in rotated turns, ROUNDS bursts each: the median
   and the least;
4. ``sweep``  — the dense 4096 x 4096 lattice with the cost model's
   launch shape, for warp scheduling with the gmt_eff table (NP = 1024),
   the same with a division per point (NP = 1025), a constant GMT (no
   warp) and unaligned arrays (element by element), in rotated bursts;
   its bound is the larger of its bytes and the model's operations a
   point (``point_ops``) at the issue rate, and beside it the time its
   SASS instructions take at that rate;
5. ``fit``    — each cost model against the card: the reduction at a
   grid of (WG, TS) for int32 and bf16, measured beside modeled, and the
   memory latency, a block's fixed cost and the last block's time per
   partial (``_LATENCY_US``, ``_BLOCK_US``, ``_L2_US``) that best fit
   both; the sweep at every launch shape of its lattice, fitted by least
   squares as an issue time plus a cost per block on each SM: the issue
   time a point (``_POINT_PS``; and the share of the issue rate it
   makes of the SASS count) and that cost (``_BLOCK_US``).

The card's name and power limit come first.  Exits non-zero without a
card, or if a kernel's result differs from its plain version.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REDUCE_N = 2**28
SWEEP_SIDE = 4096
ROUNDS = 7
SOURCES = ("tuned_reduction.cu", "sweep_eval.cu")
MARKERS = {"LDG.E.128": r"^(@\S+ )?LDG\.E\S*\.128", "IMAD.HI": r"IMAD\.HI",
           "MUFU.RCP": r"MUFU\.RCP", "REDUX": r"REDUX",
           "SHFL.BFLY": r"SHFL\.BFLY"}
FIT_GRID = [(WG, TS) for WG in (128, 256, 512, 1024)
            for TS in (16, 64, 256, 1024, 4096)]


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


def rotated(runs: dict, rounds: int = ROUNDS, iters: int = 20) -> dict:
    """Median and least burst time of each run, the runs in rotated turns."""

    names = list(runs)
    bursts: dict = {n: [] for n in names}
    for r in range(rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            bursts[n].append(time_ms(runs[n], iters=iters))
    return {n: {"ms": sorted(b)[len(b) // 2], "least_ms": min(b)}
            for n, b in bursts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=str(ROOT / "build" / "reduce_sweep_report.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("reduce_sweep_report: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import WaveParams
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import HBM_BYTES_PER_S, ISSUE_RATE, SMS
    from repro_torch.kernels.sweep_eval import ops as sweep_ops
    from repro_torch.kernels.sweep_eval.kernel import point_instructions
    from repro_torch.kernels.sweep_eval.ref import point_ops
    from repro_torch.kernels.tuned_reduction import ops as red_ops
    from repro_torch.tune import tune

    lines: list[dict] = []
    ok = True

    def emit(part: str, **fields) -> None:
        lines.append({"part": part, **fields})
        print(json.dumps(lines[-1]), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi)

    _build.library()
    info = _build.build_info()
    emit("ptxas", nvcc_s=info.seconds,
         usage={src: _build.ptxas_usage(info.ptxas.get(src, []))
                for src in SOURCES})
    kernels = {}
    for fn, instrs in _build.sass(info.path).items():
        if not any(k in fn for k in ("reduce_kernel", "sweep_eval_kernel",
                                     "sweep_point_probe")):
            continue
        kernels[fn] = {"instructions": len(instrs), **{
            mk: sum(bool(re.search(rx, i)) for i in instrs)
            for mk, rx in MARKERS.items()}}
    emit("sass", kernels=kernels,
         sweep_instr_per_point={"table": point_instructions(table=True),
                                "const": point_instructions(table=False)})

    def modeled(tunable):
        return tune(tunable, engine="grid", cache=None).best_config

    # 3. the reduction's nine cases and an unaligned view ------------------
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    library = {"min": torch.amin, "max": torch.amax,
               "sum": lambda x: torch.sum(x, dtype=x.dtype)}
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        if dtype == torch.int32:
            x = torch.randint(-2**31, 2**31 - 1, (REDUCE_N,), generator=g,
                              device="cuda", dtype=torch.int32)
        else:
            x = (torch.randn(REDUCE_N, generator=g, device="cuda") * 100
                 ).to(dtype)
        cases = [(x, op, op) for op in ("min", "max", "sum")]
        if dtype == torch.bfloat16:
            cases.append((x[3:], "sum", "sum-unaligned-x[3:]"))
        for xv, op, case in cases:
            cfg = modeled(red_ops.ReductionTunable(
                xv.numel(), op=op, dtype_bytes=xv.element_size()))
            got = red_ops.reduce_1d(xv, op=op, **cfg)
            same = torch.equal(got.cpu(), red_ops.reduce_chunked(
                xv, op, cfg["WG"], cfg["TS"]).cpu())
            ok &= same
            t = rotated({"kernel": lambda: red_ops.reduce_1d(xv, op=op, **cfg),
                         "library": lambda: library[op](xv)})
            bound = xv.numel() * xv.element_size() / HBM_BYTES_PER_S * 1e3
            emit("reduce", case=f"{str(dtype)[6:]}-{case}", n=xv.numel(),
                 config=cfg, equal_plain=same, ms=t["kernel"]["ms"],
                 least_ms=t["kernel"]["least_ms"],
                 library_ms=t["library"]["ms"],
                 library_least_ms=t["library"]["least_ms"],
                 bound_ms=bound, of_bound=bound / t["kernel"]["ms"],
                 over_library=t["kernel"]["ms"] / t["library"]["ms"],
                 modeled_ms=red_ops.cost_model(
                     cfg, n=xv.numel(), dtype_bytes=xv.element_size()) / 1e3)
        del x, cases
    torch.cuda.empty_cache()

    # 4. the sweep: gmt_eff by table, by division, constant; unaligned -----
    side = torch.arange(1, SWEEP_SIDE + 1, dtype=torch.int32, device="cuda")
    wg = side.repeat_interleave(SWEEP_SIDE)
    ts = side.repeat(SWEEP_SIDE)
    n = wg.numel()
    cfg = modeled(sweep_ops.SweepEvalTunable(n))
    base = dict(size=2**30, GMT=16, L=8, kind="minimum", NU=132)
    variants = {"table-NP1024": (WaveParams(NP=1024, warp=32, **base), wg, ts),
                "divide-NP1025": (WaveParams(NP=1025, warp=32, **base), wg, ts),
                "const-NP128": (WaveParams(NP=128, **base), wg, ts),
                "table-NP128-unaligned": (WaveParams(NP=128, warp=32, **base),
                                          torch.cat([wg[:1], wg])[1:],
                                          torch.cat([ts[:1], ts])[1:])}
    runs = {}
    for name, (p, a, b) in variants.items():
        same = torch.equal(sweep_ops.sweep_eval(a, b, p, **cfg),
                           sweep_ops.sweep_ref(p, a, b))
        ok &= same
        emit("sweep", variant=name, equal_plain=same)
        runs[name] = lambda p=p, a=a, b=b: sweep_ops.sweep_eval(a, b, p, **cfg)
    instr = point_instructions(table=True)
    bytes_ms = 12 * n / HBM_BYTES_PER_S * 1e3
    issue_ms = instr * n / ISSUE_RATE * 1e3
    for name, t in rotated(runs).items():
        ops_ms = point_ops(variants[name][0]) * n / ISSUE_RATE * 1e3
        emit("sweep", variant=name, n=n, config=cfg, ms=t["ms"],
             least_ms=t["least_ms"], bytes_ms=bytes_ms, ops_ms=ops_ms,
             bound_ms=max(bytes_ms, ops_ms),
             of_bound=max(bytes_ms, ops_ms) / t["ms"],
             table_issue_ms=issue_ms,
             modeled_ms=sweep_ops.cost_model(cfg, n=n) / 1e3)

    # 5. the cost models' fits ----------------------------------------------
    measured = {}                          # (dtype bytes, WG, TS) -> us
    for dtype in (torch.int32, torch.bfloat16):
        x = torch.randint(-1000, 1000, (REDUCE_N,), generator=g,
                          device="cuda", dtype=torch.int32).to(dtype)
        for WG, TS in FIT_GRID:
            measured[(x.element_size(), WG, TS)] = time_ms(
                lambda: red_ops.reduce_1d(x, op="max", WG=WG, TS=TS)) * 1e3
        del x
    names = ("_LATENCY_US", "_BLOCK_US", "_L2_US")
    keep = tuple(getattr(red_ops, k) for k in names)

    def misfit(consts):
        for k, v in zip(names, consts):
            setattr(red_ops, k, v)
        return sum(math.log(red_ops.cost_model(
            {"WG": w, "TS": t}, n=REDUCE_N, dtype_bytes=db) / us) ** 2
            for (db, w, t), us in measured.items())

    model_misfit = misfit(keep)
    best = min((misfit(c), c) for c in (
        (lat / 20, blk / 20, l2 / 40) for lat in range(2, 81)
        for blk in range(0, 41, 2) for l2 in range(0, 41, 2)))
    misfit(keep)
    for db in (4, 2):
        rows = [{"WG": w, "TS": t, "measured_us": us,
                 "modeled_us": red_ops.cost_model(
                     {"WG": w, "TS": t}, n=REDUCE_N, dtype_bytes=db)}
                for (b, w, t), us in measured.items() if b == db]
        fastest = min(rows, key=lambda r: r["measured_us"])
        emit("fit", kernel="tuned_reduction", dtype_bytes=db, op="max",
             n=REDUCE_N, grid=rows, fastest=fastest,
             fastest_bytes_per_s=REDUCE_N * db / fastest["measured_us"] * 1e6)
    emit("fit", kernel="tuned_reduction", log_misfit=best[0],
         **dict(zip(("latency_us", "block_us", "l2_us"), best[1])),
         model_log_misfit=model_misfit, model=dict(zip(names, keep)))
    # t = issue + blocks / SMS * block_us, least squares over the shapes
    p = variants["table-NP1024"][0]
    rows = []
    for c in sweep_ops.tuning_space(n):
        us = time_ms(lambda: sweep_ops.sweep_eval(wg, ts, p, **c)) * 1e3
        rows.append({**c, "measured_us": us,
                     "modeled_us": sweep_ops.cost_model(c, n=n),
                     "blocks": -(-n // (4 * c["threads"] * c["ept"]))})
    xs = [r["blocks"] / SMS for r in rows]
    ys = [r["measured_us"] for r in rows]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    block_us = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sum(
        (x - mx) ** 2 for x in xs)
    issue_us = my - block_us * mx
    emit("fit", kernel="sweep_eval", n=n, grid=rows,
         fastest=min(rows, key=lambda r: r["measured_us"]),
         issue_us=issue_us, point_ps=issue_us * 1e6 / n, block_us=block_us,
         instr_per_point=instr,
         issue_share=instr * n / (ISSUE_RATE / 1e6 * issue_us),
         model_point_ps=sweep_ops._POINT_PS,
         model_block_us=sweep_ops._BLOCK_US)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    if not ok:
        print("reduce_sweep_report: a kernel differs from its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
