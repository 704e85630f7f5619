"""Tune the 512-device distributed configuration off-hardware on the
port (the paper's headline benefit at fleet scale) — the three cells as
one declarative :class:`~repro_torch.tune.TuningPlan`, with skip-on-hit
caching across re-runs (the twin of ``examples/tune_distributed.py``).

    PYTHONPATH=src python examples/torch_tune_distributed.py

The machine model prices the active platform spec: the H100's data
sheet by default (or ``$REPRO_TORCH_PLATFORM_SPEC``'s calibration), so
its picks differ from the reference's, which prices a TPU.  ``main``
returns each cell's pick and decomposition beside the (16, 16) baseline.
"""

import argparse

from repro_torch.core.tpu_machine import (DistributedTunable, TPUConfig,
                                          step_time, workload_from_arch)
from repro_torch.tune import TuningPlan

CELLS = [("minitron-8b", 1), ("qwen3-32b", 1),
         ("llama4-maverick-400b-a17b", 2)]


def main(argv=None) -> list[dict]:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)

    plan = TuningPlan(name="distributed-train")
    tunables = []
    for arch, pods in CELLS:
        tb = DistributedTunable(workload_from_arch(arch, "train_4k"),
                                chips_per_pod=256, pods=pods)
        tunables.append((arch, pods, tb))
        plan.add(tb, engine="grid", label=f"{arch}/pods={pods}")

    report = plan.run(progress=None)

    cells = []
    for (arch, pods, tb), job in zip(tunables, report.results):
        if job.status == "failed":
            print(f"{arch} ({pods} pod(s)): FAILED — {job.error}")
            continue
        best = tb.to_config(job.best_config)
        t = tb.decomposition(best)
        base = step_time(tb.workload, TPUConfig(dp=16, tp=16, pods=pods))
        cells.append({"arch": arch, "pods": pods, "status": job.status,
                      "config": best, "modeled": t, "baseline": base})
        print(f"{arch} ({pods} pod(s), {t['chips']} chips, cache "
              f"{job.status}):")
        print(f"  tuned : tp={best.tp} dp={best.dp} microbatches="
              f"{best.microbatches} remat={best.remat} fsdp={best.fsdp} "
              f"compress={best.compress_pod_grads}")
        print(f"  modeled step {t['total']*1e3:.1f} ms "
              f"(compute {t['compute']*1e3:.1f} / memory "
              f"{t['memory']*1e3:.1f} / exposed-coll "
              f"{t['exposed_collective']*1e3:.1f}) vs baseline "
              f"{base['total']*1e3:.1f} ms -> "
              f"{base['total']/t['total']:.2f}x")

    print(report.summary())
    return cells


if __name__ == "__main__":
    main()
