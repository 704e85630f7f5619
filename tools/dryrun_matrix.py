#!/usr/bin/env python3
"""The dry run's whole matrix (every arch × every shape × both
production meshes, with the block records) through ``python -m
repro_torch.launch.dryrun``, one process per (arch, mesh), ``--workers``
at a time, and each record priced on the H100 data sheet.

    PYTHONPATH=src python3 tools/dryrun_matrix.py [--workers N]
        [--microbatches 1] [--out build/dryrun_matrix]

Each process writes ``OUT/<arch>--single-pod.json`` (or
``--multi-pod``) and its log beside it; the records are merged into
``OUT/matrix.json``.  Prints one JSON line per record (status, wall,
roofline terms, dominant term, MFU, peak) and last a summary line: the
matrix's wall, the sum of the processes' walls, the count of each
status, the cells skipped where ``configs.supports`` does not say so and
the cells that failed.  Exits 1 if a cell failed or was skipped where it
is supported.  The records are the single command's (``python -m
repro_torch.launch.dryrun --microbatches 1 --out F``); only the wall
differs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("--single-pod", "--multi-pod")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun_matrix"))
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.calibrate.spec import DEFAULT_SPEC
    from repro_torch.configs import ARCHS, SHAPES, get_config, supports
    from repro_torch.launch.roofline import analyze

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jobs = [(a, m) for m in MESHES for a in sorted(ARCHS)]
    walls: dict[str, float] = {}

    def run(job):
        arch, mesh = job
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, mesh, "--microbatches", str(args.microbatches), "--out",
             str(out / f"{arch}{mesh}.json")],
            cwd=ROOT, env=env, capture_output=True, text=True)
        walls[f"{arch}{mesh}"] = time.perf_counter() - t0
        (out / f"{arch}{mesh}.log").write_text(proc.stdout + proc.stderr)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.workers) as ex:
        list(ex.map(run, jobs))
    wall = time.perf_counter() - t0

    records, missing = [], []
    for arch, mesh in jobs:
        path = out / f"{arch}{mesh}.json"
        if path.exists():
            records += json.loads(path.read_text())
        else:
            missing.append(f"{arch}{mesh}")
    (out / "matrix.json").write_text(json.dumps(records, indent=1))

    status: dict[str, int] = {}
    wrong = []
    for rec in records:
        status[rec["status"]] = status.get(rec["status"], 0) + 1
        ok, _ = supports(get_config(rec["arch"]), SHAPES[rec["shape"]])
        if rec["status"] != ("ok" if ok else "skipped"):
            wrong.append([rec["arch"], rec["shape"], rec["mesh"],
                          rec["status"], rec["reason"][:300]])
        r = analyze(rec, spec=DEFAULT_SPEC)
        line = {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "status": rec["status"],
                "wall_s": rec.get("wall_s")}
        if rec["status"] == "ok":
            line.update(compute_ms=r.compute_s * 1e3,
                        memory_ms=r.memory_s * 1e3,
                        collective_ms=r.collective_s * 1e3,
                        dominant=r.dominant, mfu=r.mfu,
                        peak_gib=r.peak_hbm_gib)
        print(json.dumps(line), flush=True)
    print(json.dumps({"matrix_wall_s": wall, "workers": args.workers,
                      "processes": len(jobs),
                      "sum_process_s": sum(walls.values()),
                      "records": len(records), "status": status,
                      "wrong": wrong, "missing": missing}), flush=True)
    return 1 if wrong or missing else 0


if __name__ == "__main__":
    sys.exit(main())
