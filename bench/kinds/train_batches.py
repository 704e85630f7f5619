"""``train_batches``: the program's training step on packed batches of
synthetic documents.

The mix file gives the batch, the sequence length, the lognormal
document lengths and how many distinct batches are made.  Token ids and
document boundaries come from ``--seed``, on the device; documents are
concatenated without padding, each closed by the end-of-document token.
Every batch is made before the window, so no loader is timed.

Set-up builds one train state from the benchmark's weights and drives it
through its first ``check_steps`` steps with the window's own call, on
distinct batches; the window then continues from that same state,
synchronising after every step (its loss is read).

``correct``: the float32 reference follows the first steps from the same
weights on the same batches, and each number the cell's limits name must
stay within its limit.  By the worst leaf, each against the reference's
norm of that leaf or of the median leaf, whichever is larger: the gap
between the program's and the reference's norms of the first step's
clipped gradient (read from the optimizer's first moment), the norm of
that gradient's difference, and the gap between the norms of the
parameters' change over the steps.  Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change.  The largest relative gap of a step's loss is
read beside them.
"""

from __future__ import annotations

import gc
import inspect
import math
import statistics
import time

import numpy as np
import torch

from bench import flops, model
from bench.reference.train import train_steps
from bench.trace import profiled


def batches(traffic: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """(n, B, S) int32 token batches: uniform ids in [1, vocab) with the
    end-of-document id at each boundary of lognormal document lengths."""

    n, B, S = traffic["batches"], traffic["batch"], traffic["seq"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    tok = torch.randint(1, vocab, (n, B, S), generator=gen, device=device,
                        dtype=torch.int32)
    d = traffic["documents"]
    rng = np.random.default_rng([seed, 2])
    total = n * B * S
    lens = np.exp(math.log(d["median"]) + d["sigma"] *
                  rng.standard_normal(total // d["min"] + 1))
    ends = np.cumsum(np.clip(np.rint(lens), d["min"], d["max"]).astype(
        np.int64)) - 1
    ends = ends[ends < total]
    tok.view(-1)[torch.from_numpy(ends).to(device)] = d["eod_token"]
    return tok


def _program_knobs_match(knobs: dict) -> None:
    """The program's AdamW takes its betas and epsilon from its defaults:
    raise unless the configuration states those."""

    from repro_torch.optim import adamw_update

    sig = inspect.signature(adamw_update).parameters
    for ours, theirs in (("beta1", "b1"), ("beta2", "b2"), ("eps", "eps")):
        if knobs[ours] != sig[theirs].default:
            raise ValueError(f"the program's AdamW runs {theirs}="
                             f"{sig[theirs].default}, the file states "
                             f"{ours}={knobs[ours]}")


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median of ref)."""

    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def run(run) -> None:
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train import (TrainConfig, TrainState,
                                           build_train_step)

    conf, traffic, dev = run.conf, run.traffic, run.device
    knobs = conf["train"]
    _program_knobs_match(knobs)
    dims = model.Dims.of(conf)
    cfg = model.program_config(conf, dims, remat=knobs["remat"])
    api = build_model(cfg)
    weights = model.make_weights(dims, run.seed, model.dtype_of(conf), dev)
    model.check_layout(api, weights)
    names = list(weights)
    data = batches(traffic, dims.vocab, run.seed, dev)
    n_check = traffic["check_steps"]
    step = build_train_step(api, TrainConfig(
        lr=knobs["lr"], warmup=knobs["warmup"],
        total_steps=knobs["total_steps"],
        weight_decay=knobs["weight_decay"], clip_norm=knobs["clip_norm"],
        microbatches=knobs["microbatches"]))
    params = model.program_tree(weights)
    state = TrainState(params, adamw_init(params), None)

    def feed(i):
        t = data[i % data.shape[0]]
        return {"tokens": t, "labels": t}

    losses = []
    for i in range(n_check):
        state, metrics = step(state, feed(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            # the clipped gradient as the optimizer got it, m / (1 - b1):
            # its norms on the card, a copy on the host for the reference
            grads = {k: v / (1.0 - knobs["beta1"]) for k, v in
                     model.flat_from_tree(state.opt.m, names).items()}
            first_grad = {k: float(torch.linalg.vector_norm(v))
                          for k, v in grads.items()}
            grads = {k: v.cpu() for k, v in grads.items()}
    change = {k: float(torch.linalg.vector_norm(v.float() -
                                                weights[k].float()))
              for k, v in model.flat_from_tree(state.params, names).items()}

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    steps = bad = 0
    i = n_check
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_process
    t = t0
    while t - t0 < run.seconds:
        state, metrics = step(state, feed(i))
        loss = float(metrics["loss"])
        t = time.perf_counter()
        i += 1
        steps += 1
        bad += not math.isfinite(loss)
    run.window_s = t - t0
    B, S = traffic["batch"], traffic["seq"]
    run.e2e = {"train_tokens_per_s": B * S * steps / run.window_s,
               "setup_s": run.setup_s}
    run.counters = {"steps": steps, "tokens": B * S * steps,
                    "useful_flops": steps * train_flops(dims, B, S),
                    "last_loss": loss}
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    if run.trace:
        # the profiled slices follow the window
        def one():
            nonlocal state, i
            state, m = step(state, feed(i))
            float(m["loss"])
            i += 1
        run.slice = profiled(dev, one, traffic["profile_steps"])
        run.info["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    run.attempted, run.failed = steps, bad

    del state, metrics, step, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = train_steps(weights, dims, data[:n_check], knobs, keep_first=True)
    judge(run, compare(losses, first_grad, change, ref, grads))
    run.info["losses"] = losses
    run.info["reference_losses"] = ref.losses


def judge(run, readings: dict) -> None:
    """Hold the readings against the reference to the cell's limits:
    those the limits name become the run's checks, all are kept in
    ``run.info``."""

    run.info["readings"] = readings
    for name, value in readings.items():
        if name in run.limits:
            run.checks[name] = (value, run.limits[name])


def compare(losses, first_grad, change, ref, grads=None) -> dict:
    """The numbers read against the reference; ``correct`` holds those the
    cell's limits name.  ``grads`` (the first step's clipped gradients)
    adds ``grad_diff``: by the worst leaf, the norm of the gradient's
    difference from the reference's against the reference's norm of that
    leaf or of the median leaf."""

    med = statistics.median(ref.first_grad.values())
    moving = {k for k, g in ref.first_grad.items() if g >= 1e-3 * med}
    out = {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, ref.losses)),
        "grad_gap": worst_leaf_gap(first_grad, ref.first_grad),
        "change_gap": worst_leaf_gap(change, ref.change, moving),
    }
    if grads is not None:
        diff = {k: float(torch.linalg.vector_norm(
            grads[k].to(r.device).float() - r))
            for k, r in ref.first_grads.items()}
        out["grad_diff"] = max(diff[k] / max(ref.first_grad[k], med)
                               for k in diff)
    return out


def train_flops(dims, B: int, S: int) -> float:
    """Model FLOPs of one step: forward and backward (3 × forward) over
    B rows of S tokens, the unembedding at the S - 1 positions that are
    predicted, attention over the causal keys."""

    body = model.matmul_params(dims) - dims.vocab * dims.d
    fwd = B * (flops.forward_flops(dims, body, S, flops.causal_key_sum(0, S))
               + 2.0 * dims.vocab * dims.d * (S - 1))
    return 3.0 * fwd


__all__ = ["batches", "compare", "judge", "run", "train_flops",
           "worst_leaf_gap"]
