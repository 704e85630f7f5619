#!/usr/bin/env python3
"""The bf16 ``matmul_tuned`` kernel beside variants of its own source, on
one CUDA card: what each variant's ptxas says and how fast it runs.

    PYTHONPATH=src python3 tools/matmul_variants.py [--out variants.json]

Each variant is the tree's ``csrc/matmul_tuned.cu`` with one edit:

- ``tree``:      as it is;
- ``unpinned``:  without the operand fence after the accumulators' zero
                 fill, so the compiler may sink the zeros into the K loop
                 (ptxas then serialises the wgmmas: warning C7515);
- ``group8``, ``group32``: blocks grouped 8 or 32 tiles deep along M
                 instead of 16.

All are built at once by nvcc into libraries of their own under
``build/matmul_variants/`` at the checkout's root, each held to the
plain product (rel L2) at 8192^3 and timed there in turns with
``torch.matmul``: ROUNDS bursts of back-to-back calls each, between CUDA
events, each round in an order rotated by one; the median and the least
reported, then the card's SM clock as ``nvidia-smi`` reads it.  Prints one JSON
line per part and writes them to ``--out`` (default
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
VARIANTS = {
    "tree": (None, None),
    "unpinned": (PIN, ""),
    "group8": (GROUP, "constexpr int GROUP_M = 8;"),
    "group32": (GROUP, "constexpr int GROUP_M = 32;"),
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
    for name, (old, new) in VARIANTS.items():
        if old is not None and old not in tree:
            raise AssertionError(f"{name}: the edit no longer applies")
        src = work / name / "matmul_tuned.cu"
        src.parent.mkdir(parents=True)
        src.write_text(tree if old is None else tree.replace(old, new))
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
        usage = {k: v for k, v in _build.ptxas_usage(ptxas).items()
                 if "mm_bf16" in k}
        emit("ptxas", variant=name, usage=usage,
             c7515=sum("C7515" in ln for ln in ptxas))
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        lib.mm_matmul.argtypes = _build.SIGNATURES["mm_matmul"]
        lib.mm_matmul.restype = ctypes.c_int
        libs[name] = lib
    emit("build", nvcc_s=time.perf_counter() - t0, variants=len(libs))

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    a = torch.randn(MNK, MNK, generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(MNK, MNK, generator=g, device="cuda").to(torch.bfloat16)
    c = torch.empty(MNK, MNK, dtype=torch.bfloat16, device="cuda")
    want = torch.matmul(a.float(), b.float())
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, bn):
        _build.check(lib.mm_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                   MNK, MNK, MNK, 2, 128, bn, 64, stream),
                     "mm_matmul")

    runs = {"torch.matmul": lambda: torch.matmul(a, b)}
    for name, lib in libs.items():
        for bn in (256, 128):
            launch(lib, bn)
            torch.cuda.synchronize()
            emit("check", variant=name, bn=bn, rel_l2=float(
                (c.float() - want).norm() / want.norm()))
            runs[f"{name}/bn{bn}"] = lambda lib=lib, bn=bn: launch(lib, bn)
    del want
    # each round starts one run later, so no run always follows the same
    # one (the clock drifts as the card heats)
    bursts: dict[str, list[float]] = {k: [] for k in runs}
    order = list(runs)
    for r in range(ROUNDS):
        for k in order[r % len(order):] + order[:r % len(order)]:
            bursts[k].append(time_ms(runs[k]))
    emit("times", shape=[MNK] * 3, ms={
        k: {"median": sorted(v)[len(v) // 2], "least": min(v), "all": v}
        for k, v in bursts.items()},
        after=smi("clocks.sm,power.draw,temperature.gpu"))

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
