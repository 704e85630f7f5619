"""Multi-pod dry-run entry point (the port's copy of ``repro.launch.dryrun``).

Runs every (architecture × input shape) cell on the production meshes —
(16, 16) single pod and (2, 16, 16) multi-pod — each over a fake process
group of 256 or 512 ranks made for the cell (:mod:`.cells`), and records
per cell the per-device memory, FLOPs, bytes and collectives.  Importing
this module starts no process group.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..configs import ARCHS, SHAPES, get_config
from ..runtime.train import TrainConfig
from .cells import lower_block_cell, lower_cell


def run(args) -> int:
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ([True] if args.multi_pod else
              [False] if args.single_pod else [False, True])

    results = []
    failed = 0
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                t0 = time.perf_counter()
                tcfg = TrainConfig(microbatches=args.microbatches)
                overrides = json.loads(args.rules) if args.rules else None
                res = lower_cell(
                    arch, shape, multi_pod=multi_pod, tcfg=tcfg,
                    remat=args.remat or None,
                    logits_dtype=args.logits_dtype or None,
                    rules_overrides=overrides)
                rec = res.to_json()
                # block-level counts beside the module's (all trips)
                if res.status == "ok" and not args.no_blocks:
                    blk = lower_block_cell(
                        arch, shape, multi_pod=multi_pod,
                        remat=args.remat or None, rules_overrides=overrides)
                    rec["block"] = blk.to_json()
                    if get_config(arch).is_encdec:
                        enc = lower_block_cell(
                            arch, shape, multi_pod=multi_pod, part="encoder",
                            remat=args.remat or None,
                            rules_overrides=overrides)
                        rec["enc_block"] = enc.to_json()
                rec["wall_s"] = time.perf_counter() - t0
                results.append(rec)
                mem = res.memory.get("temp_size_in_bytes", 0) / 2**30
                flops = res.cost.get("flops", 0)
                coll = res.collectives.get("total_bytes", 0) / 2**30
                print(f"[{res.mesh}] {arch:26s} {shape:12s} "
                      f"{res.status:8s} lower={res.lower_s:6.1f}s "
                      f"compile={res.compile_s:6.1f}s temp={mem:7.2f}GiB "
                      f"flops/dev={flops:.3e} coll={coll:7.2f}GiB "
                      f"{res.reason[:90]}", flush=True)
                if res.status == "failed":
                    failed += 1
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    print(f"\n{len(results)} cells, {failed} failed", flush=True)
    return 1 if failed else 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto (machine-model default)")
    ap.add_argument("--remat", default="")
    ap.add_argument("--logits-dtype", default="")
    ap.add_argument("--rules", default="", help="JSON rules overrides")
    ap.add_argument("--no-blocks", action="store_true",
                    help="skip the block-level counts")
    ap.add_argument("--out", default="")
    sys.exit(run(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
