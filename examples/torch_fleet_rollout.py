"""Fleet rollout end-to-end on the port: warm a tuning cache from a
declarative plan, export it as a portable artifact, merge it into a
fresh "fleet node" cache, and show an ``@autotune`` kernel call
resolving its block sizes with zero engine runs — the paper's
amortization argument at fleet scale (the twin of
``examples/fleet_rollout.py``, on the same plan file).

    PYTHONPATH=src python examples/torch_fleet_rollout.py [--device cpu]

``--device`` (default ``cuda:0``) is where the kernel tunables measure
and the node's matmul runs; with ``cpu`` the plan's kernel and
scheduler jobs (and the meta job's inner one) get ``"device": "cpu"``
in memory — the plan file is read, never edited.  Without a card and
without ``--device cpu`` it fails with "no CUDA device".

Equivalent CLI (what a real rollout pipeline runs)::

    python -m repro_torch.tune --cache warm.json warmup examples/plans/fleet_warmup.json --workers 4
    python -m repro_torch.tune --cache warm.json export artifact.json
    python -m repro_torch.tune --cache node.json merge artifact.json
    python -m repro_torch.tune --cache node.json ls
"""

import argparse
import json
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.tune import TuningCache, TuningPlan, set_default_cache

PLAN = Path(__file__).parent / "plans" / "fleet_warmup.json"


def plan_spec(device: torch.device) -> dict:
    """The plan file's spec; on the CPU, every job whose tunable takes a
    device is pointed at it."""

    spec = json.loads(PLAN.read_text())
    if device.type == "cpu":
        for job in spec["jobs"]:
            name = job["tunable"]
            if name.startswith("kernels.") or name == "serve.scheduler":
                job["params"] = dict(job.get("params", {}), device="cpu")
            if name == "meta.engine":
                job["params"]["inner"]["params"]["device"] = "cpu"
    return spec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu for the plain versions")
    dev = resolve_device(ap.parse_args(argv).device)

    prev = None
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)

        # 1. warm-up node: run the plan (all four kernel tunables, the
        # serving slot/prefill-chunk/kv-page tunables, and a meta "tune
        # the tuner" job) — jobs are independent, so thread-pool them
        warm = TuningCache(d / "warm.json")
        plan = TuningPlan.from_spec(plan_spec(dev))
        report = plan.run(cache=warm, progress=print, workers=4)
        assert report.ok, report.summary()

        # 2. ship: export a schema-versioned artifact, merge into a fresh
        # node's cache (prefer_measured keeps wall-clock picks on
        # conflict; the bundle's provenance meta rides along as each
        # entry's origin)
        bundle = warm.export_artifact(d / "artifact.json")
        node = TuningCache(d / "node.json")
        merged = node.merge_artifact(d / "artifact.json")
        node.save()
        print(f"shipped {bundle['entry_count']} entries; node merged "
              f"{merged['added']} added / {merged['kept']} kept "
              f"(from {merged['meta']['tool']} on {merged['meta']['host']})")

        # 3. fleet node: @autotune resolves purely from the merged cache
        prev = set_default_cache(node)
        try:
            from repro_torch.kernels.matmul_tuned.ops import matmul_tuned
            a = torch.ones((128, 128), dtype=torch.float32, device=dev)
            decision = matmul_tuned.tune(a, a)
            assert decision.stats["cache"] == "hit", decision.stats
            out = matmul_tuned(a, a)
            assert node.misses == 0, node.stats
            print(f"fleet node: matmul_tuned resolved "
                  f"{decision.best_config} from cache with 0 engine runs "
                  f"(result[0,0]={float(out[0, 0])})")

            # the same plan re-run on the node is 100% hits
            again = plan.run(cache=node)
            assert again.counts["hits"] == len(plan), again.summary()
            print(f"re-warmup on node: {again.summary()}")
        finally:
            set_default_cache(prev)


if __name__ == "__main__":
    main()
