"""Quickstart on the port: the paper's four-step counterexample method,
end to end, through ``repro_torch.tune`` (the twin of
``examples/quickstart.py``; no device work).

    PYTHONPATH=src python examples/torch_quickstart.py

Step 1 represents the parallel program + platform as a process model,
Step 2 states the over-time property Φ_o = G(FIN → time > T),
Step 3 searches for the minimal termination time (bisection on T),
Step 4 extracts the tuning configuration from the final counterexample.
"""

import argparse
import tempfile
import time
from pathlib import Path

from repro_torch.core import (Counterexample, OverTime, PlatformSpec,
                              build_model, explore)
from repro_torch.tune import PlatformTunable, TuningCache, tune


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)

    # Step 1 — the abstract platform: 4 processing elements, global/local
    # memory ratio 4, input size 16, Minimum-problem kernel (paper §7).
    spec = PlatformSpec(size=16, NP=4, GMT=4, kind="minimum")
    model = build_model(spec)
    print("Step 1: Promela-like model with proctypes:",
          sorted(model.proctypes))

    # Step 2 — the over-time property.
    prop = OverTime(T=100)
    print(f"Step 2: Φ_o = G(FIN → time > {prop.T})")

    # Step 3 — verify; a counterexample is an execution faster than T.
    r = explore(model, prop.violates)
    cex = Counterexample.from_terminal(r.counterexample)
    print(f"Step 3: counterexample found — terminates at time {cex.time} "
          f"(explored {r.states} states)")

    # ... minimized via bisection (Fig. 1): one tunable, any engine from
    # the registry — the paper's loop packaged as repro_torch.tune.tune.
    tunable = PlatformTunable(spec)
    for engine in ("explorer", "swarm", "sweep"):
        t0 = time.perf_counter()
        res = tune(tunable, engine=engine, cache=None)
        dt = time.perf_counter() - t0
        print(f"   engine={engine:9s} T_min={res.t_min:4d} "
              f"config={res.best_config} ({dt:.3f}s)")

    # Step 4 — the final counterexample's configuration is the tuning;
    # the trail replays through the model (SPIN trail simulation).
    res = tune(tunable, engine="explorer", cache=None)
    assert res.witness.validate(build_model(spec))
    print(f"Step 4: optimal tuning parameters = {res.best_config} "
          f"(trail of {len(res.witness.trail)} transitions replays OK)")

    # Beyond the paper: tuned configs persist — the second call with the
    # same fingerprint is served from the TuningCache, no engine run.
    with tempfile.TemporaryDirectory() as d:
        cache = TuningCache(Path(d) / "tune_cache.json")
        tune(tunable, engine="sweep", cache=cache)
        again = tune(tunable, engine="sweep", cache=cache)
        print(f"Cache: second call served from {cache.path.name} "
              f"({again.stats['cache']}, stats={cache.stats})")


if __name__ == "__main__":
    main()
