"""End-to-end training driver (the port's copy of
``repro.launch.train``).

Runs real training on the card (``--device cuda:0``, the default) or on
the host (``--device cpu``, the plain PyTorch versions).  ``--preset
smoke`` uses the reduced config; ``--tune`` asks the model-checking
auto-tuner for the distributed configuration (microbatches/remat/FSDP/
compression) before building the step function, priced for this
process's cards (``torch.cuda.device_count()`` of them, each with its
own memory) — the paper's method as a first-class framework feature.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --preset full --batch 8 --seq 2048 --steps 60 --tune
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --preset smoke --steps 50 --inject-failure 20 --ckpt-dir /tmp/ckpt \\
      --device cpu
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ShapeSpec
from ..core.tpu_machine import HBM_BYTES, TPUWorkload
from ..data import DataConfig, SyntheticLM
from ..kernels.common import resolve_device
from ..models import build_model
from ..runtime import (LoopConfig, SimulatedFailure, TrainConfig,
                       build_train_step, init_train_state, run_training)


def _platform(dev: torch.device) -> tuple[int, float]:
    """(GPUs in this process's domain, bytes of memory each) for pricing
    the lattice: the cards this process sees, or one device of the
    data sheet's memory on the host."""

    if dev.type == "cuda":
        return (torch.cuda.device_count(),
                float(torch.cuda.get_device_properties(dev).total_memory))
    return 1, HBM_BYTES


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tune", action="store_true",
                    help="pick distributed config via the auto-tuner")
    ap.add_argument("--use-flash", action="store_true",
                    help="route full-seq self-attention through the "
                         "@autotune'd flash kernel (forward only: a "
                         "training step through it raises)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="simulate a node failure at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N (default cuda:0) or cpu for the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    if args.use_flash:
        cfg = cfg.replace(use_flash=True)
    api = build_model(cfg)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")

    microbatches = args.microbatches
    remat = cfg.remat
    if args.tune:
        from ..tune import TuningPlan
        chips, hbm_bytes = _platform(dev)
        w = TPUWorkload(params=api.param_count(),
                        active_params=api.param_count(),
                        layers=cfg.n_layers, d_model=cfg.d_model,
                        seq=args.seq, global_batch=args.batch,
                        vocab=cfg.vocab)
        plan = TuningPlan(name=f"train.{args.arch}")
        plan.add(w.tunable(chips_per_pod=max(chips, 1), hbm_bytes=hbm_bytes),
                 engine="grid", label="distributed-config")
        report = plan.run(progress=lambda s: print(f"[tune] {s}"))
        job = report.results[0]
        if job.status == "failed":
            raise RuntimeError(f"tuning failed: {job.error}")
        res = job.result
        if not math.isfinite(res.t_min):
            raise RuntimeError("no feasible configuration fits HBM")
        best = res.best_config
        microbatches = min(best["microbatches"], args.batch)
        remat = best["remat"]
        cfg = cfg.replace(remat=remat)
        api = build_model(cfg)
        print(f"[tune] config: microbatches={microbatches} remat={remat} "
              f"fsdp={best['fsdp']} modeled step={res.t_min*1e3:.2f} ms "
              f"(engine={res.engine}, cache {job.status})")

    tcfg = TrainConfig(lr=args.lr, warmup=max(2, args.steps // 20),
                       total_steps=args.steps, microbatches=microbatches)
    state = init_train_state(api, args.seed, tcfg, device=dev)
    step = build_train_step(api, tcfg)
    data = SyntheticLM(cfg, shape, DataConfig(seed=args.seed), device=dev)

    inject = None
    if args.inject_failure >= 0:
        fail_at = {args.inject_failure}

        def inject(s):
            if s in fail_at:
                fail_at.clear()
                print(f"[inject] simulated pod failure at step {s}")
                raise SimulatedFailure(f"injected at {s}")

    t0 = time.perf_counter()
    state, hist = run_training(
        step_fn=step, init_state=state, batch_fn=data.batch,
        cfg=LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every),
        ckpt_dir=args.ckpt_dir or None, inject=inject)
    wall = time.perf_counter() - t0

    print(f"steps={len(hist.losses)} wall={wall:.1f}s "
          f"mean_step={np.mean(hist.step_times)*1e3:.1f}ms "
          f"restarts={hist.restarts} stragglers={len(hist.straggler_events)}")
    print(f"loss: first={hist.losses[0]:.4f} last={hist.losses[-1]:.4f} "
          f"min={min(hist.losses):.4f}")


if __name__ == "__main__":
    main()
