"""Readings that set a cell's limits, on the card: the control (the
float32 reference put in the program's place at float8, the precision
below the configuration's bfloat16) and, for a training cell, the
faults a step can have.  Each is judged by the harness as a run of the
cell is, under the cell's own limits, and its ``correct`` printed.  The
benchmark's own runs never run this.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 [--seconds 30]

Serving: a run of the cell with ``--seconds`` whose judged tokens are, at
each served position of the checked requests, the ones the fp8
reference puts first; the program's own gap on the same requests is
printed beside it.  Training: the reference's first steps against the
fp8 reference's, and against the reference on half of each batch (the
mean over the other half); a step that leaves its state unchanged reads
1 by the gradient's and the change's measures and needs no run.  One
JSON line a seed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def chat(bench_json, cell, seed, seconds, device):
    from bench import harness

    run = harness.prepare(bench_json, cell, seed, seconds, False, device,
                          time.perf_counter())
    run.info["control"] = True
    harness.execute(run)
    value, limit = run.checks["max_logit_gap"]
    return {"correct": harness.result(bench_json, run)["correct"],
            "program": {"max_logit_gap": run.info["program_gap"]},
            "control": {"max_logit_gap": value},
            "limit": limit, "checked_tokens": run.info["checked_tokens"],
            "checked_requests": run.info["checked_requests"]}


def train(bench_json, cell, seed, device):
    """Each planted run's readings and its ``correct``, as ``Run.correct``
    judges them under the cell's limits."""

    from bench import harness, model
    from bench.kinds.train_batches import batches, compare, judge
    from bench.reference.train import train_steps

    c = harness.find_cell(bench_json, cell)
    conf = harness.load_config(c["config"])
    traffic = harness.load_traffic(c["traffic"])
    dims = model.Dims.of(conf)
    weights = model.make_weights(dims, seed, model.dtype_of(conf), device)
    n = traffic["check_steps"]
    data = batches(traffic, dims.vocab, seed, device)[:n]
    knobs = conf["train"]
    ref = train_steps(weights, dims, data, knobs, keep_first=True)
    out = {"reference_losses": ref.losses}
    runs = {
        "control": train_steps(weights, dims, data, knobs, fp8=True,
                               keep_first=True),
        "half_batch": train_steps(weights, dims, data[:, :data.shape[1] // 2],
                                  knobs, keep_first=True),
        # a step that returns its state: every loss at the first weights
        "unchanged": train_steps(weights, dims, data,
                                 dict(knobs, lr=0.0, weight_decay=0.0),
                                 keep_first=True),
    }
    for name, st in runs.items():
        readings = compare(st.losses, st.first_grad, st.change, ref,
                           st.first_grads)
        if name == "unchanged":
            # its first moment stays 0 and its parameters do not move:
            # every gradient and change number reads 1
            readings.update(grad_gap=1.0, grad_diff=1.0, change_gap=1.0)
        run = harness.prepare(bench_json, cell, seed, 0.0, False, device,
                              time.perf_counter())
        run.attempted = n
        judge(run, readings)
        out[name] = dict(readings, correct=run.correct)
        out[name + "_losses"] = st.losses
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    from bench.run import environment
    environment()
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench_json = harness.load_benchmark()
    kind = harness.load_traffic(
        harness.find_cell(bench_json, args.workload)["traffic"])["kind"]
    for seed in args.seeds:
        t = time.perf_counter()
        if kind == "closed_chat":
            out = chat(bench_json, args.workload, seed, args.seconds, dev)
        else:
            out = train(bench_json, args.workload, seed, dev)
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t,
                   device=torch.cuda.get_device_name(dev))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
