"""Hill-climb entry point (the port's copy of ``repro.launch.perf``): run a
cell under a named variant and report its roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch mamba2-2.7b \\
      --shape train_4k --name baseline
  PYTHONPATH=src python -m repro_torch.launch.perf --arch mamba2-2.7b \\
      --shape train_4k --cfg '{"ssd_dtype": "bfloat16"}' --name ssd_bf16

Each run appends a JSON line to ``results/perf_log.jsonl`` (relative to
the working directory), so the iteration history is machine-readable."""

from __future__ import annotations

import argparse
import json
import os
import time

from ..configs import get_config
from ..runtime.train import TrainConfig
from .cells import lower_block_cell, lower_cell
from .roofline import analyze


def run_variant(arch: str, shape: str, name: str, *,
                cfg_overrides: dict | None = None,
                rules_overrides: dict | None = None,
                remat: str | None = None,
                logits_dtype: str | None = None,
                microbatches: int = 0,
                out_path: str = "results/perf_log.jsonl") -> dict:
    """Run the cell and its block-level counts, price it, append the
    line to ``out_path`` and return it."""

    tcfg = TrainConfig(microbatches=microbatches)
    t0 = time.perf_counter()
    res = lower_cell(arch, shape, tcfg=tcfg, remat=remat,
                     logits_dtype=logits_dtype, cfg_overrides=cfg_overrides,
                     rules_overrides=rules_overrides)
    rec = res.to_json()
    if res.status == "ok":
        rec["block"] = lower_block_cell(
            arch, shape, remat=remat, cfg_overrides=cfg_overrides,
            rules_overrides=rules_overrides).to_json()
        if get_config(arch).is_encdec:
            rec["enc_block"] = lower_block_cell(
                arch, shape, part="encoder", remat=remat,
                cfg_overrides=cfg_overrides,
                rules_overrides=rules_overrides).to_json()
    r = analyze(rec)
    out = {
        "variant": name, "arch": arch, "shape": shape,
        "status": res.status, "reason": res.reason[:200],
        "compute_ms": r.compute_s * 1e3, "memory_ms": r.memory_s * 1e3,
        "collective_ms": r.collective_s * 1e3, "dominant": r.dominant,
        "useful": r.useful_ratio, "mfu": r.mfu,
        "peak_hbm_gib": r.peak_hbm_gib,
        "temp_gib": res.memory.get("temp_size_in_bytes", 0) / 2**30,
        "settings": res.settings, "wall_s": time.perf_counter() - t0,
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out, indent=1))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--name", default="baseline")
    ap.add_argument("--cfg", default="", help="JSON ArchConfig overrides")
    ap.add_argument("--rules", default="", help="JSON rules overrides")
    ap.add_argument("--remat", default="")
    ap.add_argument("--logits-dtype", default="")
    ap.add_argument("--microbatches", type=int, default=0)
    args = ap.parse_args(argv)
    run_variant(args.arch, args.shape, args.name,
                cfg_overrides=json.loads(args.cfg) if args.cfg else None,
                rules_overrides=json.loads(args.rules) if args.rules
                else None,
                remat=args.remat or None,
                logits_dtype=args.logits_dtype or None,
                microbatches=args.microbatches)


if __name__ == "__main__":
    main()
