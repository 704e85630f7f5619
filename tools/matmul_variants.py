#!/usr/bin/env python3
"""The ``matmul_tuned`` kernels beside variants of their own source, on
one CUDA card: what each variant's ptxas says and how fast it runs.

    PYTHONPATH=src python3 tools/matmul_variants.py [--out variants.json]

Each variant is the tree's ``csrc/matmul_tuned.cu`` with one edit:

- ``tree``:      as it is;
- ``unpinned``:  without the operand fence after the accumulators' zero
                 fill, so the compiler may sink the zeros into the K loop
                 (ptxas then serialises the wgmmas: warning C7515);
- ``group8``, ``group32``: blocks grouped 8 or 32 tiles deep along M
                 instead of 16;
- ``f32_no_prefetch``: the f32 kernel reading each k step's fragments
                 just before its FFMAs, not one step ahead;
- ``f32_group8``: f32 blocks grouped 8 tiles deep along M (L2 reuse);
- ``f32_two_blocks``: the f32 128 x 128 tiles capped at 128 registers,
                 two blocks an SM where the ring allows.

All are built at once by nvcc into libraries of their own under
``build/matmul_variants/`` at the checkout's root, each held to the
plain product (rel L2) and timed in turns with ``torch.matmul``: the
bf16 variants at 8192^3 with tiles (128, {256, 128}, 64), the f32 ones
at 4096^3 with tiles (128, 128, {32, 64}); ROUNDS bursts of
back-to-back calls each, between CUDA events, each round in an order
rotated by one; the median and the least reported, with the card's SM
clock as ``nvidia-smi`` reads it before and after.  Prints one JSON line
per part and writes them to ``--out`` (default
``build/matmul_variants.json`` at the checkout's root).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MNK = 8192
ROUNDS = 9
PIN = ("    // pinned here: left free, the compiler sinks the zeros into "
       "the loop\n"
       "    // among the in-flight wgmmas, and ptxas then serialises them "
       "(C7515)\n"
       "    sm90::fence_operands(acc);\n")
GROUP = "constexpr int GROUP_M = 16;"
F32_MNK = 4096
MIN_BLOCKS = "static constexpr int MIN_BLOCKS = smem <= SMEM_PAIR && TM * TN <= 32 ? 2 : 1;"
F32_MAP = "  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;\n"
F32_MAP8 = (
    "  const int tiles_m = M / BM, tiles_n = N / BN;\n"
    "  const int bid = blockIdx.y * gridDim.x + blockIdx.x, per = 8 * tiles_n;\n"
    "  const int first = (bid / per) * 8, gm = min(tiles_m - first, 8);\n"
    "  const int row0 = (first + bid % per % gm) * BM, col0 = (bid % per / gm) * BN;\n")
# the f32 kernel's k-tile loop body lies between these two lines
F32_LOOP = ("    // fragments double-buffered in registers",
            "  sm90::cp_async_wait<0>();\n\n  // epilogue")
F32_PLAIN_LOOP = """    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * T::LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[TG];
#pragma unroll
        for (int g = 0; g < TG; ++g)
          b[g] = *reinterpret_cast<const float4*>(Bs + (k4 + kk) * BN + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int g = 0; g < TG; ++g) {
            acc[i][g].x = fmaf(av, b[g].x, acc[i][g].x);
            acc[i][g].y = fmaf(av, b[g].y, acc[i][g].y);
            acc[i][g].z = fmaf(av, b[g].z, acc[i][g].z);
            acc[i][g].w = fmaf(av, b[g].w, acc[i][g].w);
          }
        }
      }
    }
  }
"""


def swap(old: str, new: str):
    """The edit that replaces ``old`` (which must be in the source)."""

    def edit(src: str) -> str:
        if old not in src:
            raise AssertionError("the edit no longer applies")
        return src.replace(old, new)
    return edit


def between(first: str, last: str, new: str):
    """The edit that replaces the text from ``first`` up to ``last``."""

    def edit(src: str) -> str:
        i, j = src.index(first), src.index(last)
        return src[:i] + new + src[j:]
    return edit


# name: (edit of the source, or None; dtypes timed)
VARIANTS = {
    "tree": (None, ("bf16", "f32")),
    "unpinned": (swap(PIN, ""), ("bf16",)),
    "group8": (swap(GROUP, "constexpr int GROUP_M = 8;"), ("bf16",)),
    "group32": (swap(GROUP, "constexpr int GROUP_M = 32;"), ("bf16",)),
    "f32_no_prefetch": (between(*F32_LOOP, F32_PLAIN_LOOP), ("f32",)),
    "f32_group8": (swap(F32_MAP, F32_MAP8), ("f32",)),
    "f32_two_blocks": (swap(MIN_BLOCKS, MIN_BLOCKS.replace(
        " && TM * TN <= 32", "")), ("f32",)),
}


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=str(ROOT / "build" / "matmul_variants.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("matmul_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    lines: list[dict] = []

    def emit(part: str, **fields) -> None:
        lines.append({"part": part, **fields})
        print(json.dumps(lines[-1]), flush=True)

    emit("device", nvidia_smi=smi("name,power.limit"))
    tree = (_build.CSRC / "matmul_tuned.cu").read_text()
    work = ROOT / "build" / "matmul_variants"
    shutil.rmtree(work, ignore_errors=True)
    nvcc = _build.nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name, (edit, _) in VARIANTS.items():
        src = work / name / "matmul_tuned.cu"
        src.parent.mkdir(parents=True)
        try:
            src.write_text(tree if edit is None else edit(tree))
        except (AssertionError, ValueError) as e:
            raise AssertionError(f"{name}: the edit no longer applies") from e
        (src.parent / "sm90.cuh").write_bytes(
            (_build.CSRC / "sm90.cuh").read_bytes())
        procs[name] = subprocess.Popen(
            [nvcc, *_build.FLAGS, "-shared", "-o",
             str(src.parent / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        ptxas = _build._ptxas_lines(log)
        kernel = "mm_bf16" if "bf16" in VARIANTS[name][1] else "mm_f32"
        usage = {k: v for k, v in _build.ptxas_usage(ptxas).items()
                 if kernel in k or (name == "tree" and "mm_f32" in k)}
        emit("ptxas", variant=name, usage=usage,
             c7515=sum("C7515" in ln for ln in ptxas))
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        lib.mm_matmul.argtypes = _build.SIGNATURES["mm_matmul"]
        lib.mm_matmul.restype = ctypes.c_int
        libs[name] = lib
    emit("build", nvcc_s=time.perf_counter() - t0, variants=len(libs))

    stream = torch.cuda.current_stream().cuda_stream
    # dtype: (code, size, the tiles timed as (bm, bn, bk))
    cases = {"bf16": (2, MNK, [(128, 256, 64), (128, 128, 64)]),
             "f32": (1, F32_MNK, [(128, 128, 32), (128, 128, 64)])}
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype, (code, n, tiles) in cases.items():
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
        a = torch.randn(n, n, generator=g, device="cuda").to(tdt)
        b = torch.randn(n, n, generator=g, device="cuda").to(tdt)
        c = torch.empty(n, n, dtype=tdt, device="cuda")
        want = torch.matmul(a.float(), b.float())

        def launch(lib, tile, a=a, b=b, c=c, n=n, code=code):
            _build.check(lib.mm_matmul(a.data_ptr(), b.data_ptr(),
                                       c.data_ptr(), n, n, n, code, *tile,
                                       stream), "mm_matmul")

        runs = {"torch.matmul": lambda a=a, b=b: torch.matmul(a, b)}
        for name, lib in libs.items():
            if dtype not in VARIANTS[name][1]:
                continue
            for tile in tiles:
                launch(lib, tile)
                torch.cuda.synchronize()
                emit("check", dtype=dtype, variant=name, tile=tile,
                     rel_l2=float((c.float() - want).norm() / want.norm()))
                runs[f"{name}/{tile}"] = \
                    lambda lib=lib, tile=tile: launch(lib, tile)
        del want
        # each round starts one run later, so no run always follows the
        # same one (the clock drifts as the card heats)
        before = smi("clocks.sm,power.draw,temperature.gpu")
        bursts: dict[str, list[float]] = {k: [] for k in runs}
        order = list(runs)
        for r in range(ROUNDS):
            for k in order[r % len(order):] + order[:r % len(order)]:
                bursts[k].append(time_ms(runs[k]))
        emit("times", dtype=dtype, shape=[n] * 3, ms={
            k: {"median": sorted(v)[len(v) // 2], "least": min(v), "all": v}
            for k, v in bursts.items()}, before=before,
            after=smi("clocks.sm,power.draw,temperature.gpu"))
        del a, b, c
        torch.cuda.empty_cache()

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
