"""Auto-tune the Minimum kernel (paper §7) at realistic scale on the
port, then run the tuned CUDA reduction and check the tuning against its
plain version — all through ``repro_torch.tune`` (the twin of
``examples/autotune_minimum.py``).

    PYTHONPATH=src python examples/torch_autotune_minimum.py [--device cpu]

1. build a :class:`~repro_torch.tune.TuningPlan` with two jobs —
   model-check the (WG, TS) lattice for a 2^20-element reduction on a
   GPU-like abstract platform (15 units × 128 PEs), and tune the
   reduction kernel's own (WG, TS) launch lattice with the same
   machinery (grid engine over its HBM-streaming cost model) — and run
   it through the persistent cache,
2. execute the kernel with WG and TS *omitted* — the ``@autotune``
   decorator resolves them from the warmed tuning cache — and check the
   result against the plain version in the same fold order.

``--device`` (default ``cuda:0``) is where the kernel runs; ``cpu`` runs
its plain PyTorch version.  Without a card and without ``--device cpu``
it fails with "no CUDA device".
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import PlatformSpec
from repro_torch.kernels.common import resolve_device, tunable_device
from repro_torch.kernels.tuned_reduction.ops import (ReductionTunable,
                                                     reduce_1d,
                                                     reduce_chunked)
from repro_torch.tune import PlatformTunable, TuningPlan, tune

SIZE = 1 << 20


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu for the plain version")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. one declarative plan: the paper-style abstract-platform job and
    # the kernel job (for the device the call below runs on), executed
    # through the persistent cache (skip-on-hit)
    plan = TuningPlan(name="minimum-warmup")
    plan.add(PlatformTunable(PlatformSpec(size=SIZE, NP=128, GMT=16, L=8,
                                          kind="minimum")),
             engine="sweep", label="abstract-platform")
    plan.add(ReductionTunable(SIZE, device=tunable_device(None, dev)),
             engine="grid", label="reduction-kernel")

    t0 = time.perf_counter()
    report = plan.run(progress=print)
    assert report.ok, report.summary()
    res, kres = (j.result for j in report.results)
    print(f"abstract platform: optimal WG={res.best_config['WG']} "
          f"TS={res.best_config['TS']} model_time={res.t_min} "
          f"({(time.perf_counter()-t0)*1e3:.1f} ms for the whole plan)")

    # swarm agrees (randomized bounded search, Fig. 5)
    small = PlatformTunable(PlatformSpec(size=64, NP=4, GMT=16,
                                         kind="minimum"))
    r_sw = tune(small, engine="swarm", cache=None, n_walks=8, seed=0)
    r_ex = tune(small, engine="sweep", cache=None)
    print(f"swarm sanity (size=64): swarm t={r_sw.t_min} vs exhaustive "
          f"t={r_ex.t_min}")

    print(f"reduction kernel: WG={kres.best_config['WG']} "
          f"TS={kres.best_config['TS']} modeled {kres.t_min:.1f} us  "
          f"({kres.oracle_calls or 'cached'} configs, cache "
          f"{kres.stats.get('cache')})")

    # 2. run the kernel with WG and TS omitted: @autotune resolves them
    # from the cache (the plan above already warmed it) and validates
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -2**31, 2**31 - 1, SIZE, dtype=np.int64).astype(np.int32)).to(dev)
    got = reduce_1d(x, op="min")
    decision = reduce_1d.tune(x, op="min")
    assert decision.stats["cache"] == "hit"
    want = reduce_chunked(x, "min", **decision.best_config)
    assert int(got) == int(want)
    print(f"tuned kernel result {int(got)} == plain {int(want)}  ✓ "
          f"(WG={decision.best_config['WG']} "
          f"TS={decision.best_config['TS']} from cache)")


if __name__ == "__main__":
    main()
