#!/usr/bin/env python3
"""Drive the port's tuning loop on one CUDA card, end to end.

    python3 chip_smoke.py

The torch twin of ``examples/autotune_minimum.py`` at the sizes users
tune for.  Each phase prints one JSON line:

1. ``build``  — nvcc time and ``-Xptxas -v`` lines of ``src/repro_torch/csrc``;
2. ``device`` — the card, its capability and its power limit;
3. ``kernel`` — each kernel against its plain PyTorch version at full size
   (error, kernel / plain / library time, bound), one line per case;
4. ``tune``   — the main path: a TuningPlan (the §7 abstract platform with
   the sweep engine, the three kernel tunables with the measure engine)
   into a temporary cache, a second run that must hit, and ``reduce_1d``
   resolving its (WG, TS) through ``@autotune``;
5. ``kernels`` — each kernel's launches during phase 4 (must be > 0).

Then a ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failure
raises: no phase catches its own error, and no result is printed.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

REDUCE_N = 2**28
SWEEP_SIDE = 4096                       # dense 4096 x 4096 lattice, 2^24 points
SWEEP_CHECK_SIZE = 2**30
MM_BF16 = (8192, 8192, 8192)
MM_F32 = (4096, 4096, 4096)
PAPER_SPEC = {"size": 2**20, "NP": 128, "GMT": 16, "L": 8, "kind": "minimum"}
# tolerances, stated: min/max/int sums and the sweep exact; a float sum
# within 1e-6 * sum|x| of the plain version (same f32 fold order, so 0 is
# expected); matmul as the JAX package's tests, rtol tol and atol tol*sqrt(K)
SUM_TOL = 1e-6
MM_TOL = {"bfloat16": 5e-2, "float32": 2e-3}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""

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


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    from repro_torch.kernels.common import HBM_BYTES_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.core import PlatformSpec, WaveParams, model_time, wg_ts_space
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import F32_FLOPS, BF16_FLOPS
    from repro_torch.kernels.matmul_tuned.kernel import matmul_kernel
    from repro_torch.kernels.matmul_tuned.ops import (MatmulTunable,
                                                      matmul_ref, matmul_tuned)
    from repro_torch.kernels.sweep_eval.kernel import sweep_kernel
    from repro_torch.kernels.sweep_eval.ops import (SweepEvalTunable,
                                                    sweep_eval, sweep_ref)
    from repro_torch.kernels.tuned_reduction.kernel import reduce_kernel
    from repro_torch.kernels.tuned_reduction.ops import (ReductionTunable,
                                                         reduce_1d,
                                                         reduce_chunked)
    from repro_torch.tune import (PlatformTunable, TuningCache, TuningPlan,
                                  set_default_cache, tune)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    emit("build", built=info.built, nvcc_s=info.seconds,
         load_s=time.perf_counter() - t0, library=str(info.path),
         ptxas=info.ptxas)

    # 2. device --------------------------------------------------------------
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name,
         capability=".".join(map(str, torch.cuda.get_device_capability(0))),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    def modeled(tunable):
        return tune(tunable, engine="grid", cache=None).best_config

    summary: dict[str, dict] = {}

    # 3. kernels against their plain versions, at full size -----------------
    # 3a. reduction: int32, f32, bf16 x min, max, sum at n = 2^28
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        if dtype == torch.int32:
            x = torch.randint(-2**31, 2**31 - 1, (REDUCE_N,), generator=gen,
                              device=dev, dtype=torch.int32)
        else:
            x = (torch.randn(REDUCE_N, generator=gen, device=dev) * 100
                 ).to(dtype)
        abs_sum = float(x.double().abs().sum())
        library = {"min": torch.amin, "max": torch.amax, "sum": torch.sum}
        for op in ("min", "max", "sum"):
            cfg = modeled(ReductionTunable(REDUCE_N, op=op,
                                           dtype_bytes=x.element_size()))
            got = reduce_1d(x, op=op, **cfg)
            want = reduce_chunked(x, op, cfg["WG"], cfg["TS"])
            err = abs(float(got.double()) - float(want.double()))
            exact64 = float(x.double().sum()) if op == "sum" else None
            if op == "sum" and dtype != torch.int32:
                tol = SUM_TOL * abs_sum
            else:
                tol = 0.0
            if not err <= tol:
                raise AssertionError(f"reduce {dtype} {op}: kernel {got} vs "
                                     f"plain {want} (err {err} > tol {tol})")
            b, by = bound_ms(REDUCE_N * x.element_size() + x.element_size(),
                             REDUCE_N - 1, F32_FLOPS)
            row = {"case": f"{str(dtype)[6:]}-{op}", "n": REDUCE_N,
                   "config": cfg, "max_abs_err": err, "tol": tol,
                   "err_vs_f64": (abs(float(got.double()) - exact64)
                                  if exact64 is not None
                                  and dtype != torch.int32 else None),
                   "ms": time_ms(lambda: reduce_1d(x, op=op, **cfg), 20),
                   "plain_ms": time_ms(lambda: reduce_chunked(
                       x, op, cfg["WG"], cfg["TS"]), 2, warmup=1),
                   "library_ms": time_ms(lambda: library[op](x), 20),
                   "bound_ms": b, "bound_by": by}
            emit("kernel", name="tuned_reduction", **row)
            if dtype == torch.int32 and op == "min":
                summary["tuned_reduction"] = row
        del x
    torch.cuda.empty_cache()

    # 3b. sweep-eval: exact over wg_ts_space(2^30) against the plain version
    # and model_time; timed on a dense 4096 x 4096 lattice
    for warp in (None, 32):
        p = WaveParams(size=SWEEP_CHECK_SIZE, NP=128, GMT=16, L=8,
                       kind="minimum", NU=132, warp=warp)
        arrs = wg_ts_space(p.size).to_arrays()
        wg = torch.as_tensor(arrs["WG"], dtype=torch.int32, device=dev)
        ts = torch.as_tensor(arrs["TS"], dtype=torch.int32, device=dev)
        got = sweep_eval(wg, ts, p, threads=256, ept=1)
        if not torch.equal(got, sweep_ref(p, wg, ts)):
            raise AssertionError(f"sweep kernel != plain version (warp={warp})")
        truth = [model_time(p, int(w), int(t)) for w, t in zip(arrs["WG"],
                                                               arrs["TS"])]
        fits = [i for i, t in enumerate(truth) if t < 2**31 - 1]
        got_l = got.cpu().tolist()
        bad = [i for i in fits if got_l[i] != truth[i]]
        if bad:
            raise AssertionError(f"sweep kernel != model_time at {len(bad)} "
                                 f"points (warp={warp})")
        emit("kernel", name="sweep_eval", case=f"check-2^30-warp={warp}",
             points=len(truth), equal_model_time=len(fits),
             beyond_int32=len(truth) - len(fits))
    side = torch.arange(1, SWEEP_SIDE + 1, dtype=torch.int32, device=dev)
    wg = side.repeat_interleave(SWEEP_SIDE)
    ts = side.repeat(SWEEP_SIDE)
    n = wg.numel()
    cfg = modeled(SweepEvalTunable(n))
    got = sweep_eval(wg, ts, p, **cfg)
    want = sweep_ref(p, wg, ts)
    if not torch.equal(got, want):
        raise AssertionError("sweep kernel != plain version on the dense lattice")
    b, by = bound_ms(3 * 4 * n, 40 * n, F32_FLOPS)
    row = {"case": "dense-4096x4096", "n": n, "config": cfg,
           "max_abs_err": int((got.long() - want.long()).abs().max()),
           "ms": time_ms(lambda: sweep_eval(wg, ts, p, **cfg), 20),
           "plain_ms": time_ms(lambda: sweep_ref(p, wg, ts), 3, warmup=1),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    emit("kernel", name="sweep_eval", **row)
    summary["sweep_eval"] = row
    del wg, ts, got, want

    # 3c. matmul: bf16 at 8192^3, f32 at 4096^3 (library: torch.matmul,
    # TF32 off)
    for dtype, (M, N, K) in ((torch.bfloat16, MM_BF16),
                             (torch.float32, MM_F32)):
        a = torch.randn(M, K, generator=gen, device=dev).to(dtype)
        b_ = torch.randn(K, N, generator=gen, device=dev).to(dtype)
        cfg = modeled(MatmulTunable(M, N, K, dtype_bytes=a.element_size()))
        got = matmul_tuned(a, b_, **cfg).float()
        want = matmul_ref(a, b_).float()
        tol = MM_TOL[str(dtype)[6:]]
        diff = (got - want).abs()
        if not bool((diff <= tol * K ** 0.5 + tol * want.abs()).all()):
            raise AssertionError(f"matmul {dtype}: max err {diff.max()}")
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bb, by = bound_ms((M * K + K * N + M * N) * a.element_size(),
                          2 * M * N * K, peak)
        row = {"case": f"{str(dtype)[6:]}-{M}x{N}x{K}", "config": cfg,
               "max_abs_err": float(diff.max()), "tol": tol,
               "ms": time_ms(lambda: matmul_tuned(a, b_, **cfg), 5),
               "plain_ms": time_ms(lambda: matmul_ref(a, b_), 5),
               "library_ms": time_ms(lambda: torch.matmul(a, b_), 5),
               "bound_ms": bb, "bound_by": by}
        row["tflops"] = 2 * M * N * K / row["ms"] / 1e9
        emit("kernel", name="matmul_tuned", **row)
        if dtype == torch.bfloat16:
            summary["matmul_tuned"] = row
        del a, b_, got, want, diff
    torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # 4. the main path: plan -> measure -> cache -> @autotune ----------------
    counters = (reduce_kernel, sweep_kernel, matmul_kernel)
    for c in counters:
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        cache = TuningCache(Path(tmp) / "tune_cache.json")
        prev = set_default_cache(cache)
        try:
            plan = TuningPlan(name="chip-smoke")
            plan.add(PlatformTunable(PlatformSpec(**PAPER_SPEC)),
                     engine="sweep", label="abstract-platform")
            plan.add(ReductionTunable(REDUCE_N), engine="measure")
            plan.add(SweepEvalTunable(SWEEP_SIDE * SWEEP_SIDE),
                     engine="measure")
            plan.add(MatmulTunable(*MM_BF16), engine="measure")
            report = plan.run(cache=cache)
            if not report.ok:
                raise AssertionError(report.summary() + " " + json.dumps(
                    report.to_json()))
            plat = report.results[0]
            if plat.best_config != {"WG": 128, "TS": 8192} \
                    or plat.t_min != 131224:
                raise AssertionError(f"platform job: {plat}")
            emit("tune", job=plat.label, status=plat.status,
                 best_config=plat.best_config, t_min=plat.t_min)
            for jr in report.results[1:]:
                st = jr.result.stats
                emit("tune", job=jr.label, status=jr.status,
                     modeled_pick=st["modeled_pick"],
                     measured_pick=st["measured_pick"],
                     candidates=st["candidates"], elapsed_s=jr.elapsed_s)
            again = plan.run(cache=cache)
            statuses = [r.status for r in again.results]
            if statuses != ["hit"] * len(plan):
                raise AssertionError(f"second run: {statuses}")
            emit("tune", second_run=statuses)

            x = torch.randint(-2**31, 2**31 - 1, (REDUCE_N,), generator=gen,
                              device=dev, dtype=torch.int32)
            got = reduce_1d(x, op="min")              # (WG, TS) omitted
            decision = reduce_1d.tune(x, op="min")
            want = reduce_chunked(x, "min", **decision.best_config)
            if int(got) != int(want) or int(got) != int(x.min()):
                raise AssertionError(f"reduce_1d: {got} vs plain {want}")
            if decision.stats["cache"] != "hit":
                raise AssertionError(f"reduce_1d.tune: {decision.stats}")
            emit("tune", job="reduce_1d@autotune", result=int(got),
                 config=decision.best_config, cache=decision.stats["cache"])
        finally:
            set_default_cache(prev)
    torch.cuda.synchronize()

    # 5. launches of each kernel during the main path -----------------------
    launches = {"tuned_reduction": reduce_kernel.launches,
                "sweep_eval": sweep_kernel.launches,
                "matmul_tuned": matmul_kernel.launches}
    emit("kernels", launches=launches)
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")

    sources = {"tuned_reduction": ("src/repro_torch/csrc/tuned_reduction.cu",
                                   "src/repro/kernels/tuned_reduction/kernel.py:76"),
               "sweep_eval": ("src/repro_torch/csrc/sweep_eval.cu",
                              "src/repro/kernels/sweep_eval/kernel.py:82"),
               "matmul_tuned": ("src/repro_torch/csrc/matmul_tuned.cu",
                                "src/repro/kernels/matmul_tuned/kernel.py:46")}
    kernels = []
    for k, (src, replaces) in sources.items():
        row = summary[k]
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if row[key] is None or not math.isfinite(row[key]):
                raise AssertionError(f"{k}: {key}={row[key]}")
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
