"""Run one cell of the benchmark on the card this process starts on.

    python3 bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Sets up the cell (weights and inputs from the seed, warm-up), measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints the numbers compared beside their limits as the
last lines of standard error and one JSON result as the last line of
standard output.  Without a CUDA card it exits with 2 and prints no
result; with a JAX module loaded at the end, with 3.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches live at fixed paths inside the
# checkout, so only a cell's first run in a checkout builds
CACHE = ROOT / "build" / "bench_cache"


def environment() -> None:
    """Cache directories for the program, and the checkout's ``src`` (the
    program) and root (the harness) on the import path."""

    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(CACHE / "tune_cache.json")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    import torch

    from bench import harness

    bench_json = harness.load_benchmark()
    cell = harness.find_cell(bench_json, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    run = harness.prepare(bench_json, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0),
                          T_PROCESS)
    limit = harness.power_limit_w()
    if limit is not None:
        run.info["power_limit_w"] = limit
    harness.execute(run)
    out = harness.result(bench_json, run)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"error: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"setup_s {run.setup_s} window_s {run.window_s} "
          f"counters {json.dumps(run.counters)} "
          f"info {json.dumps(run.info)}", file=sys.stderr)
    for name, (value, lim) in run.checks.items():
        print(f"check {name}: {value!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
