#!/usr/bin/env python3
"""Drive the port's main paths on one CUDA card, end to end: the tuning
loop, the dense model path, the paged serving path (qwen1.5-4b at full
width), the model checker, the serving tunables, and the card's
calibration with the Server observed on it.

    python3 chip_smoke.py

Each phase prints one JSON line:

1. ``build``  — nvcc time and ``-Xptxas -v`` lines of ``src/repro_torch/csrc``;
2. ``device`` — the card, its capability and its power limit;
3. ``kernel`` — each kernel against its plain PyTorch version at full size
   (error, kernel / plain / library time, bound), one line per case;
   3a, the reduction, adds a view that is not 16-byte aligned and a NaN;
   3b, the sweep, a lattice that mixes invalid points, and beside its
   bound the fast path's SASS instructions a point (``cuobjdump``); 3c,
   the matmul, also gives each kernel's registers and spills from
   ptxas; 3d is flash attention at qwen1.5-4b's shape, with the registers,
   spills and ptxas warnings of every bf16 instantiation, and an f32 case
   at the same shape; each f32 row (3c and 3d) gives its kernel's
   registers and spills (a spill fails the run) and the SM clock read
   before and after its timing;
4. ``tune``   — the tuning path: a TuningPlan (the §7 abstract platform
   with the sweep engine, the four kernel tunables with the measure
   engine) into a temporary cache, a second run that must hit, and
   ``reduce_1d`` resolving its (WG, TS) through ``@autotune``;
5. ``kernels`` — each tuning kernel's launches during phase 4 (> 0);
6. ``model``  — the model path: qwen1.5-4b with random bf16 weights from a
   seed at S = 4096: (a) every layer's attention through the flash kernel
   against the plain math on the same input; (a') the forward of the same
   weights cut to 4 layers in f32, flash against plain, end to end;
   (a'') the full bf16 ``forward`` timed, 40 flash launches each; (b) a
   ``Server`` draining 4 requests of 512 + 16 tokens; then each kernel's
   launches during (a'') and (b); (c) the cut model's ``Server`` against
   an offline greedy loop through its flash ``forward``;
7. ``paged``  — the paged ``Server`` at the same full width, under the same
   tuning cache: a ``torch.profiler`` trace of one decode tick, contiguous
   and paged (host time, device busy time and idle share, launches, the
   three largest device ops); (a) 8 requests of 512 + 16 tokens in two
   waves through 112 pages of 16; (b) the same with ``share_prefix``
   (all prompts share 256 tokens); n-gram speculation on (a)'s requests;
   (d) self-draft speculation on the 4-layer f32 cut, paged, each tick's
   page tables checked, against its never-speculated drain; then each
   kernel's launches during that path; and (c) paged with a shuffled free
   list, and shared, against the contiguous drain on the f32 cut;
8. ``model_check`` — the paper's model checker on the port: (a) the §7
   Minimum model (NP = GMT = 4) at sizes 8-64 under the ``explorer``,
   ``bnb`` and ``swarm`` engines, each t_min equal to the ``sweep``
   engine's and each witness's trail replayed on the model, and the
   ``sweep_eval`` kernel over the spec's whole lattice on the card: its
   minimum equal to t_min, its value at every witness equal to the
   witness's time; (b) Table 1's abstract rows (``explorer`` at 8 and 16,
   an 8-walk ``swarm`` at 32) against ``sweep``, the paper's value beside
   each; (c) an ``explorer`` witness through the tuning cache and back;
   (d) ``repro_torch.verify``: the allocator model at ``AllocConfig()``
   (canonical), the server and speculation models, the six mutants; (e)
   phase 7(b)'s full-width shared-prefix drain's allocator trace accepted
   as a path of the allocator model; then the kernel's time on each small
   lattice, the phase's seconds and each kernel's launches during it;
9. ``serve_tune`` — the serving tunables at qwen1.5-4b's full width on
   phase 6's weights, under the H100 data-sheet platform spec: (a) the
   five ``serve.*`` tunables built through their factories, each grid
   pick and every lattice point's modeled cost, held to a re-derivation
   here; (b) the slot count under the measure engine, modeled against
   measured drains, and ``choose_batch`` again from the cache; (b') the
   prefill chunk and the page size at their two best modeled points;
   (c) the scheduling policy over one seeded bursty trace through the
   paged Server, every (policy, age limit) drained, with goodput,
   latency and SLO attainment; (d) ``python -m repro_torch.launch.serve``
   with ``--tune-batch --tune-prefill --tune-page`` in-process; (e)
   speculation's depths on the f32 cut with the n-gram drafter; then
   each kernel's launches during the phase (none: the Server attends
   with plain ops), and the checks: the policies' tokens at bf16 (equal
   but where an evicted request re-prefilled, and there only at a near
   tie) and on the f32 cut (equal);
10. ``calibrate`` / ``observe`` — the card calibrated and the Server
   observed on it: (a) ``run_calibration`` at the card's ladders (matmul
   1024-8192 in bf16, a one-kernel triad up to 4 GB, the host-clock
   dispatch probe), the fitted peak FLOP/s and bandwidth within 50-105 %
   of the data sheet and the dispatch within 1-1,000 us, then
   ``ensure_calibrated`` twice (a probe, then a pure load); (b) a plan
   with ``"calibrate": true`` (its ``[calibrate]`` line first, a cache
   key of its own); (c) the Minimum model at sizes 8-64 under the fitted
   GMT (about 1,000): the explorer's t_min and pick against ``sweep``
   and the ``sweep_eval`` kernel, bit-equal to its plain version and to
   the int64 model; (d) phase 9's measured drains over their modeled
   costs under both specs, and the picks under the fitted one; (e) the
   modeled-vs-measured trajectory of the reduction and the bf16 matmul
   at phase 4's shapes; (f) phase 7(b)'s shared drain again with
   ``Observability(trace, metrics, monitor)`` and a ``TracingScheduler``:
   the same tokens, the monitor accepting, the document passing
   ``python -m repro_torch.obs check`` and ``summarize``; (g) the same
   drain profiled, phase by phase; (h) ``python -m
   repro_torch.launch.serve ... --paged --scheduler priority --trace
   --metrics --profile`` as a subprocess; then each kernel's launches
   during (c) and (e).

Then a ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failure
raises: no phase catches its own error, and no result is printed.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

REDUCE_N = 2**28
SWEEP_SIDE = 4096                       # dense 4096 x 4096 lattice, 2^24 points
SWEEP_CHECK_SIZE = 2**30
# WG and TS of the sweep's mixed lattice: invalid (<= 0: TS gives no work
# item, WG takes the kernel's signed path), small, around NP and warp, and
# the int32 extremes
SWEEP_EDGES = (-2**31, -7, -1, 0, 1, 2, 3, 31, 32, 33, 127, 128, 129, 1000,
               2**20, 2**30, 2**31 - 1)
MM_BF16 = (8192, 8192, 8192)
MM_F32 = (4096, 4096, 4096)
PAPER_SPEC = {"size": 2**20, "NP": 128, "GMT": 16, "L": 8, "kind": "minimum"}
# tolerances, stated: the reduction equal to its plain version bit for bit
# (the same fold order, float sums included), the sweep exact; matmul as
# the JAX package's tests, rtol tol and atol tol*sqrt(K), and rel L2 <=
# 1e-2: at K = 8192 the elementwise bound allows 4.5, too loose to catch a
# dropped stage (64 of 8192 terms, rel L2 ~ 0.09)
MM_TOL = {"bfloat16": 5e-2, "float32": 2e-3}
MM_REL_L2 = 1e-2
# flash attention, as the JAX package's kernel tests: bf16
# |got - want| <= 2e-2 + 2e-2 |want| (P and the output rounded to bf16),
# f32 |got - want| <= 2e-4 + 2e-5 |want| (FMA path, no TF32); and in every
# case rel L2 <= 1e-2, since with unit q, k, v over thousands of keys |o|
# is about as small as the bf16 bound, which alone would pass a kernel
# that drops a k-block
FLASH_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-4, 2e-5)}
FLASH_REL_L2 = 1e-2
# (dtype, B, H, S, D, causal, window): qwen1.5-4b's shape first
FLASH_CASES = (("bfloat16", 1, 20, 4096, 128, True, None),
               ("bfloat16", 1, 20, 4096, 128, True, 1024),
               ("bfloat16", 1, 20, 1024, 128, False, None),
               ("float32", 1, 20, 1024, 64, True, None),
               ("float32", 1, 20, 4096, 128, True, None),
               ("float32", 1, 20, 640, 128, True, None))   # phase 7 (d)
# the model path: qwen1.5-4b, a forward at S = 4096, and a Server of 4
# slots x 1024 context draining 4 requests of 512 + 16 tokens
MODEL = "qwen1.5-4b"
FWD_S = 4096
SERVE = {"batch": 4, "context": 1024, "prefill_chunk": 256}
REQUESTS, PROMPT_LEN, MAX_NEW = 4, 512, 16
# The random 40-layer model amplifies any rounding difference about 3x a
# layer: a plain forward from an embedding perturbed by 1e-3 ends O(1)
# away from the unperturbed one (PERF.md section 6), so no implementation
# that rounds differently meets a fixed end-to-end bound at full depth.
# So
# the flash kernel is held to the plain math (a) layer by layer at full
# depth in bf16, each layer's attention on the same input, rel L2 <= 1e-2
# (a wrong mask or scale gives errors of order 1), and (a') end to end on
# the same weights cut to DEPTH_CUT layers in f32, rel L2 <= 1e-1 on the
# last-token logits; the greedy comparison (c) runs on that cut model.
LAYER_ATTN_TOL = 1e-2
DEPTH_CUT = 4
FWD_REL_TOL = 1e-1
GAP_MULT = 10       # argmax compared only where the top-2 gap > 10 d
# phase 7, the paged path: 112 pages of 16 tokens (1,792 tokens; 32 pages
# a 512-token prompt, so three prompts at a time), 8 requests of 512 + 16
# in two waves, all sharing their first 256 tokens (16 pages)
PAGED = dict(SERVE, paged=True, page_size=16, kv_pages=112)
PAGED_REQUESTS = 8
SHARED_PREFIX = 256
SPEC_DEPTH = 4
# phase 8, the model checker: the section 7 Minimum model (NP = GMT = 4)
# under each engine, every model-checked answer held to the sweep_eval
# kernel on the card; Table 1's abstract rows as
# benchmarks/bench_table1.py runs them (size 64's swarm takes minutes a
# walk in Python and is left out); then verify at the reference's sizes
MC_MINIMUM = {8: ("explorer", "bnb", "swarm"), 16: ("explorer", "bnb", "swarm"),
              32: ("explorer", "bnb", "swarm"), 64: ("bnb", "swarm")}
MC_ABSTRACT = ((8, "explorer"), (16, "explorer"), (32, "swarm"))
MC_SWARM = {"n_walks": 8, "seed": 1, "keep_trails": True}
MC_ABSTRACT_SWARM = dict(MC_SWARM, depth_limit=2_000_000)
# size -> (model_time, TS, WG), the paper's Table 1 (bench_table1.py)
PAPER_T1 = {8: (44, 4, 4), 16: (156, 4, 8), 32: (584, 4, 16),
            64: (2224, 8, 32), 128: (9344, 64, 64), 256: (36234, 4, 4),
            512: (142090, 4, 4), 1024: (549912, 32, 16)}
# the server models of tests/test_verify_models.py: (config, scenario)
MC_SERVERS = {
    "fcfs": (dict(policy="fcfs", batch=3),
             dict(name="t", prompts=((3, 3, 3), (4, 4, 4, 4), (5, 5)),
                  max_new=(2, 1, 1))),
    "fcfs-share": (dict(policy="fcfs", batch=3, share_prefix=True),
                   dict(name="share",
                        prompts=((7, 7, 7, 7), (7, 7, 7, 5), (7, 7)),
                        max_new=(2, 1, 1))),
    "priority": (dict(policy="priority", batch=2, aging_slack=3),
                 dict(name="slo", prompts=((3, 3, 3), (4, 4), (5, 5, 5)),
                      max_new=(2, 1, 1),
                      slo=("batch", "interactive", "interactive"))),
    "prefix": (dict(policy="prefix", batch=3, share_prefix=True),
               dict(name="pf", prompts=((7, 7, 7, 7), (7, 7, 7, 5), (9, 9)),
                    max_new=(2, 1, 1))),
}
MC_SMALL_ALLOC = dict(n_slots=2, page_size=2, pages_per_slot=2, n_pages=3)
# phase 9, the serving tunables at full width: the expected load the
# factories are sized for (a), measured for the slot count (b) and the
# driver (d); the scheduler's bursty trace through phase 7's paged Server
# (c); speculation's depths on the f32 cut with the n-gram drafter (e)
TUNE_LOAD = dict(context=1024, requests=8, max_new=16)
TUNE_PROMPT, TUNE_SLOTS = 512, 4
SCHED = dict(context=1024, batch=4, page_size=16, kv_pages=112,
             prefill_chunk=256, requests=12, burst=4, burst_every=10,
             prompt_len=(128, 512), max_new=(8, 16), interactive_frac=0.5,
             shared_frac=0.5, prefix_len=256, seed=0,
             policies=("fcfs", "prefix", "priority"), age_limits=(4, 32))
# the measure engine's settings: the slot count's four best modeled
# points, one timed drain each (after one warmup drain), to keep the
# host-bound phase near 2 minutes; every scheduling point once; the
# chunk's and the page's two best points once
SLOT_ENGINE = {"top_k": 4, "repeats": 1}
SCHED_ENGINE = {"top_k": 6, "repeats": 1}
PAIR_ENGINE = {"top_k": 2, "repeats": 1}
SPEC_LOAD = dict(context=1024, prompt_len=128, requests=4, max_new=16,
                 batch=4, drafters=("ngram",))
MODEL_REL = 1e-9    # a modeled cost against its plain re-derivation
# phase 10(h): the serving driver at phase 6's load, paged through phase
# 7's 112 pages, with the policy, trace, metrics and profile flags
OBSERVE_DRIVER = ["--arch", MODEL, "--preset", "full", "--requests", "4",
                  "--batch", "4", "--context", "1024", "--prompt-len", "512",
                  "--max-new", "16", "--prefill-chunk", "256", "--paged",
                  "--kv-pages", "112", "--scheduler", "priority", "--metrics",
                  "--profile"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def timed_f32(fn, iters: int) -> tuple[float, list[str]]:
    """``time_ms`` of an f32 FMA kernel, with the SM clock that
    ``nvidia-smi`` reads just before and just after: the f32 times have
    moved between calls more than the clock-bound bf16 ones."""

    before = nvidia_smi("clocks.sm")
    ms = time_ms(fn, iters)
    return ms, [before, nvidia_smi("clocks.sm")]


def check_no_spills(name: str, usage: dict | None) -> None:
    """An FMA kernel keeps its tiles in registers: a spill is a fault."""

    if usage is None or usage.get("spill_stores", 0) or \
            usage.get("spill_loads", 0):
        raise AssertionError(f"{name}: ptxas usage {usage} (want no spills)")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""

    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    from repro_torch.kernels.common import HBM_BYTES_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def model_path(dev, gen, counters, flash_ms: float) -> dict:
    """Phase 6: qwen1.5-4b at full width on the card, under a temporary
    tuning cache.  ``flash_ms`` is phase 3d's kernel time at the model
    shape (the same modeled tile ``@autotune`` picks here), for the flash
    kernel's share of a forward.  Then phase 7 (:func:`paged_path`) on the
    same weights and cache.  Returns the launches of each kernel during
    phase 6's main path, (a'') and (b), and during phase 7's (the
    comparisons' launches, before and after them, are not counted), and
    phase 7(b)'s allocator trace."""

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.attention import attention
    from repro_torch.models.common import rms_norm, tree_leaves, tree_map
    from repro_torch.models.transformer import (_embed, block_params,
                                                layer_forward)
    from repro_torch.runtime import Server
    from repro_torch.tune import TuningCache, set_default_cache

    cfg = get_config(MODEL)
    if not cfg.use_flash:
        raise AssertionError(f"{MODEL} does not route through flash")
    plain_cfg = cfg.replace(use_flash=False)
    api, plain_api = build_model(cfg), build_model(plain_cfg)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = api.init(g, device=dev)
    torch.cuda.synchronize()
    emit("model", part="init", arch=MODEL, params=api.param_count(),
         weight_bytes=sum(t.numel() * t.element_size()
                          for t in tree_leaves(params)),
         init_s=time.perf_counter() - t0)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def compare_last_logits(a_api, b_api, p, toks):
        got = a_api.forward(p, {"tokens": toks})[0, -1].float()
        want = b_api.forward(p, {"tokens": toks})[0, -1].float()
        idx, gap = top2(want)
        return {"max_abs_diff": float((got - want).abs().max()),
                "rel_l2": rel(got, want), "top2_gap": float(gap),
                "argmax_equal": int(got.argmax()) == int(idx)}

    toks = torch.randint(0, cfg.vocab, (1, FWD_S), generator=gen,
                         device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).tolist()
               for _ in range(REQUESTS)]
    flash = counters[-1]
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        prev = set_default_cache(TuningCache(Path(tmp) / "tune_cache.json"))
        try:
            # (a) full depth, bf16, teacher-forced layer by layer: each
            # layer's attention with the flash kernel against the plain
            # math on the same input (the plain chain's)
            pos = torch.arange(FWD_S, device=dev)[None]
            hp = _embed(params, toks)
            local = []
            for i in range(cfg.n_layers):
                bp = block_params(params["blocks"], i)["0_dense"]
                hn = rms_norm(hp, bp["ln1"])
                local.append(rel(attention(bp["attn"], cfg, hn, pos,
                                           use_flash=True),
                                 attention(bp["attn"], cfg, hn, pos)))
                hp = layer_forward(bp, plain_cfg, "dense", hp, pos)
            emit("model", part="layers", S=FWD_S, attn_rel_l2=local,
                 max_attn_rel_l2=max(local))
            if not max(local) <= LAYER_ATTN_TOL:
                raise AssertionError(f"flash attention in the model: layer "
                                     f"rel error {max(local)} > "
                                     f"{LAYER_ATTN_TOL}")
            del hp, hn
            torch.cuda.empty_cache()

            # (a') the same weights cut to DEPTH_CUT layers, in f32: the
            # whole forward, flash against plain, end to end
            cut = cfg.replace(n_layers=DEPTH_CUT)
            api_cut = build_model(cut)
            plain_cut = build_model(cut.replace(use_flash=False))
            p_cut = {k: (tree_map(lambda t: t[:DEPTH_CUT].float(), v)
                         if k == "blocks" else v.float())
                     for k, v in params.items()}
            before = flash.launches
            cmp = compare_last_logits(api_cut, plain_cut, p_cut, toks)
            d = cmp["max_abs_diff"]
            emit("model", part="forward_f32_cut", n_layers=DEPTH_CUT,
                 S=FWD_S, f32_flash_launches=flash.launches - before, **cmp)
            if not cmp["rel_l2"] <= FWD_REL_TOL:
                raise AssertionError(f"flash vs plain forward: relative "
                                     f"error {cmp['rel_l2']} > {FWD_REL_TOL}")
            if cmp["top2_gap"] > GAP_MULT * d and not cmp["argmax_equal"]:
                raise AssertionError("flash vs plain forward: argmax "
                                     "differs at a clear top-2 gap")
            torch.cuda.empty_cache()

            # the main path from here: its launches are the ones counted
            for c in counters:
                c.launches = 0
            # (a'') full-depth bf16 forward at S = 4096 through the flash
            # kernel; the first call lets @autotune resolve the blocks
            api.forward(params, {"tokens": toks})
            fwd_ms, per_fwd = [], []
            for _ in range(3):
                before = flash.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = api.forward(params, {"tokens": toks})
                torch.cuda.synchronize()
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
                per_fwd.append(flash.launches - before)
                if not bool(torch.isfinite(logits[0, -1]).all()) or \
                        logits.shape != (1, FWD_S, cfg.vocab):
                    raise AssertionError(f"forward: {logits.shape}, "
                                         f"non-finite logits")
                del logits
            if per_fwd != [cfg.n_layers] * 3:
                raise AssertionError(f"flash launches per forward {per_fwd}, "
                                     f"want {cfg.n_layers}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain_api.forward(params, {"tokens": toks})
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            fwd = sorted(fwd_ms)[1]
            emit("model", part="forward", S=FWD_S, forward_ms=fwd,
                 forward_ms_all=fwd_ms, plain_forward_ms=plain_ms,
                 flash_launches_per_forward=per_fwd[0],
                 flash_share=cfg.n_layers * flash_ms / fwd)
            torch.cuda.empty_cache()

            # (b) a Server drains seeded requests at full depth in bf16 (no
            # flash on this path: chunked prefill and decode attend the
            # contiguous rings)
            server = Server(api, params, **SERVE)
            reqs = [server.submit(p, max_new=MAX_NEW) for p in prompts]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not all(r.done and len(r.out) == MAX_NEW for r in reqs):
                raise AssertionError("server did not finish every request")
            n_tok = sum(len(r.out) for r in reqs)
            emit("model", part="server", **SERVE, requests=REQUESTS,
                 prompt_len=PROMPT_LEN, max_new=MAX_NEW, ticks=server.ticks,
                 wall_s=wall, tokens=n_tok, tok_per_s=n_tok / wall,
                 stats=server.stats())
            del server
            torch.cuda.empty_cache()
            # the main path ends here: (c) is a check, not counted
            launches = [c.launches for c in counters]

            # (c) greedy: a Server on the cut f32 model against an offline
            # loop through its flash forward, padded right to a multiple of
            # 128 (causal masking keeps the padding inert) and fed the
            # Server's tokens, so a near tie never ends the comparison.  At
            # a decisive step (offline top-2 gap >= 10 d) the Server's token
            # must BE the offline argmax; at a near tie its logit must lie
            # within 10 d of the offline maximum.
            server = Server(api_cut, p_cut, **SERVE)
            reqs = [server.submit(p, max_new=MAX_NEW) for p in prompts]
            server.run_until_drained()
            before = flash.launches
            seqs = [list(p) for p in prompts]
            decisive, equal, worst, gaps = ([0] * REQUESTS, [0] * REQUESTS,
                                            0.0, [])
            for step in range(MAX_NEW):
                logits = padded_logits(api_cut, p_cut, seqs, dev)
                nxt, gap = (t.tolist() for t in top2(logits))
                served = torch.tensor([r.out[step] for r in reqs],
                                      device=dev)
                deficit = (logits.amax(dim=-1) - logits.gather(
                    1, served[:, None])[:, 0]).tolist()
                del logits
                gaps.append(gap)
                for r in range(REQUESTS):
                    tok = reqs[r].out[step]
                    if gap[r] >= GAP_MULT * d:
                        decisive[r] += 1
                        if nxt[r] != tok:
                            raise AssertionError(
                                f"request {r} step {step}: offline {nxt[r]} "
                                f"!= server {tok} at top-2 gap {gap[r]} "
                                f">= {GAP_MULT} d = {GAP_MULT * d}")
                    elif deficit[r] > GAP_MULT * d:
                        raise AssertionError(
                            f"request {r} step {step}: server token {tok} "
                            f"is {deficit[r]} below the offline max")
                    equal[r] += nxt[r] == tok
                    worst = max(worst, deficit[r])
                    seqs[r].append(tok)
            emit("model", part="greedy_f32_cut", n_layers=DEPTH_CUT,
                 f32_flash_launches=flash.launches - before,
                 ticks=server.ticks, decisive_compared=decisive,
                 equal_to_offline_argmax=equal, steps=MAX_NEW,
                 gap_threshold=GAP_MULT * d, max_deficit=worst,
                 min_top2_gap=min(min(g_) for g_ in gaps),
                 server_out=[r.out for r in reqs])
            if min(decisive) < 1:
                raise AssertionError(f"a request had no decisive step: "
                                     f"{decisive}")
            del server
            torch.cuda.empty_cache()

            # 7. the paged path, under the same tuning cache
            paged, shared_trace = paged_path(dev, counters, api, params,
                                             api_cut, p_cut, d)
        finally:
            set_default_cache(prev)
    torch.cuda.synchronize()
    return {"launches": launches, "paged_launches": paged,
            "shared_trace": shared_trace, "api": api, "params": params,
            "plain_api": plain_api, "api_cut": api_cut, "p_cut": p_cut}


def top2(logits):
    import torch
    top = torch.topk(logits.float(), 2, dim=-1)
    return top.indices[..., 0], top.values[..., 0] - top.values[..., 1]


def padded_logits(api, params, seqs, dev):
    """Each sequence's next-token logits (one row a sequence, f32) from
    one forward over the batch padded right to a multiple of 128, so it
    takes the flash gate (causal masking keeps the padding inert)."""

    import torch
    L = max(len(q) for q in seqs)
    batch = torch.zeros((len(seqs), -(-L // 128) * 128), dtype=torch.int32,
                        device=dev)
    for i, q in enumerate(seqs):
        batch[i, :len(q)] = torch.tensor(q, dtype=torch.int32, device=dev)
    last = torch.tensor([len(q) - 1 for q in seqs], device=dev)
    logits = api.forward(params, {"tokens": batch})
    return logits[torch.arange(len(seqs), device=dev), last].float()


def two_waves(server, prompts, max_new, after_tick=None) -> dict:
    """Submit the first half of ``prompts``, tick until each of them is
    decoding (or done), submit the rest and drain, calling
    ``after_tick(server)`` after every tick.  Returns the requests, wall
    time (host clock around synchronised work) and the most pages shared
    on any tick."""

    import torch
    half = len(prompts) // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [server.submit(q, max_new=max_new) for q in prompts[:half]]
    shared = 0

    def tick():
        nonlocal shared
        n = server.tick()
        if server.alloc is not None:
            shared = max(shared, server.alloc.shared_pages)
        if after_tick is not None:
            after_tick(server)
        return n

    for _ in range(10_000):
        if all(r.out or r.done for r in reqs):
            break
        tick()
    reqs += [server.submit(q, max_new=max_new) for q in prompts[half:]]
    for _ in range(10_000):
        if tick() == 0 and not server.queue:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done and len(r.out) == max_new for r in reqs):
        raise AssertionError(f"{len(reqs)} requests: not every one finished "
                             f"with {max_new} tokens")
    return {"reqs": reqs, "wall_s": wall, "max_shared_pages": shared}


def tick_profile(server) -> dict:
    """One engine tick under ``torch.profiler``: host time around it
    (the tick ends in a sync), the device's busy time (the union of its
    kernel and copy intervals) and idle share over the tick, the kernel
    launches, and the three device ops that took the most time.  Device
    fields are None when the trace holds no device event."""

    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.tick()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    events = prof.profiler.kineto_results.events()
    device = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in events if e.device_type() == DeviceType.CUDA),
                    key=lambda ev: ev[1])
    busy, end = 0, None
    per_name: dict = collections.defaultdict(int)
    for name, t_s, t_e in device:
        per_name[name] += t_e - t_s
        if end is None or t_s > end:
            busy += t_e - t_s
            end = t_e
        elif t_e > end:
            busy += t_e - end
            end = t_e
    copies = sum(n.startswith(("Memcpy", "Memset")) for n, _, _ in device)
    busy_ms = busy / 1e6 if device else None
    return {"profiled_host_ms": host_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / host_ms) if device else None,
            "kernels": len(device) - copies if device else None,
            "copies": copies if device else None,
            "top_device_ops": [[n[:100], t / 1e6] for n, t in sorted(
                per_name.items(), key=lambda kv: -kv[1])[:3]]}


def first_divergence(api_cut, p_cut, prompts, got, want, d, dev) -> dict:
    """Two drains' tokens of the same requests on the f32 cut, held by
    phase 6(c)'s rule: up to a request's first differing step the
    histories are equal, and that step must be a near tie of the offline
    forward (top-2 gap < 10 d) with both tokens' logits within 10 d of
    its maximum.  Later steps continue different histories and are not
    compared."""

    import torch
    equal, diverged = 0, []
    for r, (q, g, w) in enumerate(zip(prompts, got, want)):
        if len(g) != len(w):
            raise AssertionError(f"request {r}: {len(g)} != {len(w)} tokens")
        k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if k is None:
            equal += len(g)
            continue
        equal += k
        logits = padded_logits(api_cut, p_cut, [list(q) + w[:k]], dev)[0]
        _, gap = top2(logits)
        deficits = [float(logits.max() - logits[t]) for t in (g[k], w[k])]
        if float(gap) >= GAP_MULT * d or max(deficits) > GAP_MULT * d:
            raise AssertionError(
                f"request {r} step {k}: {g[k]} != {w[k]} at top-2 gap "
                f"{float(gap)}, deficits {deficits} (10 d = {GAP_MULT * d})")
        diverged.append({"request": r, "step": k, "top2_gap": float(gap),
                         "max_deficit": max(deficits)})
        del logits
    return {"tokens_equal": equal, "tokens": sum(len(w) for w in want),
            "divergences": diverged}


def backs_exactly_its_positions(server) -> None:
    """After a tick each live slot backs ceil(pos / page_size) logical
    pages and the pool holds no other page (no sharing), as a drain that
    never speculated does at the same positions: a draft's pages past
    the accepted tokens were rewound."""

    alloc = server.alloc
    ps, held = alloc.spec.page_size, 0
    for s in server.live_slots():
        backed = int((alloc.page_table[s] >= 0).sum())
        want = -(-int(server.slot_pos[s]) // ps)
        if backed != want:
            raise AssertionError(f"slot {s} at {server.slot_pos[s]} backs "
                                 f"{backed} pages, want {want}")
        held += want
    if alloc.free_pages != alloc.spec.n_pages - held:
        raise AssertionError(f"{alloc.free_pages} free pages, want "
                             f"{alloc.spec.n_pages - held}")


class RecordingDrafter:
    """Passes ``propose`` to a drafter and keeps every (history, draft)."""

    def __init__(self, inner):
        self.inner, self.name, self.calls = inner, inner.name, []

    def propose(self, tokens, depth):
        draft = self.inner.propose(tokens, depth)
        self.calls.append((list(tokens), list(draft)))
        return draft


def drafts_against_target(api_cut, p_cut, calls, seqs, d, dev) -> dict:
    """Each recorded draft against the target's own tokens after the same
    history (``seqs``: each request's prompt + output).  At a draft's
    first token that differs, the target's forward there must be a near
    tie (top-2 gap < 10 d, both tokens within 10 d of its maximum): a
    self-draft drafts with the target, so any other rejection is a wrong
    forward."""

    mismatches = []
    for hist, draft in calls:
        full = next(q for q in seqs if q[:len(hist)] == hist)
        n = len(hist)
        j = next((i for i, t in enumerate(draft) if t != full[n + i]), None)
        if j is None:
            continue
        logits = padded_logits(api_cut, p_cut, [full[:n + j]], dev)[0]
        _, gap = top2(logits)
        deficits = [float(logits.max() - logits[t])
                    for t in (draft[j], full[n + j])]
        if float(gap) >= GAP_MULT * d or max(deficits) > GAP_MULT * d:
            raise AssertionError(
                f"draft token {draft[j]} != target {full[n + j]} at "
                f"position {n + j}, top-2 gap {float(gap)}, deficits "
                f"{deficits} (10 d = {GAP_MULT * d})")
        mismatches.append({"position": n + j, "top2_gap": float(gap)})
        del logits
    return {"drafts": len(calls), "rejected_at_near_tie": mismatches}


def paged_path(dev, counters, api, params, api_cut, p_cut, d) -> tuple:
    """Phase 7: the paged Server at qwen1.5-4b's full width.  (profile) one
    decode tick, contiguous and paged, under ``torch.profiler``; (a)
    paged, 8 requests of 512 + 16 in two waves through 112 pages; (b) the
    same with ``share_prefix`` and the ``prefix`` scheduler; (d') n-gram
    speculation on prompts of one token repeated, which this random model
    continues with a repeated token, so drafts fire and most are accepted;
    (d) self-draft speculation on the f32 cut, paged, against its
    never-speculated paged drain.  Those are the path whose launches are
    returned (the self-draft's forwards take the flash kernel).  Then the
    checks: (c) paged with a shuffled free list and shared, against the
    contiguous drain, on the f32 cut; (d)'s tokens against the
    never-speculated drain's, and each of its drafts against the target's
    tokens; (d')'s tokens against its never-speculated drain's, counted
    (bf16 at full depth: not asserted).  Returns the launches and (b)'s
    allocator trace with its spec, its prompts, tokens, ticks and wall
    time (phase 10 observes the same drain)."""

    import numpy as np
    import torch
    from repro_torch.runtime import DraftModelDrafter, Server

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, api.cfg.vocab, SHARED_PREFIX).tolist()
    prompts = [prefix + rng.integers(0, api.cfg.vocab,
                                     PROMPT_LEN - SHARED_PREFIX).tolist()
               for _ in range(PAGED_REQUESTS)]
    for c in counters:
        c.launches = 0

    # (profile) one decode tick with 4 decoding slots, contiguous and
    # paged (full backing, so both hold the same 4 requests)
    for mode, kw in (("contiguous", {}), ("paged", {"paged": True})):
        server = Server(api, params, **SERVE, **kw)
        reqs = [server.submit(q, max_new=MAX_NEW) for q in prompts[:4]]
        while not all(r.out for r in reqs):
            server.tick()
        server.tick()                           # warm decode tick
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.tick()
        host_ms = (time.perf_counter() - t0) * 1e3
        prof = tick_profile(server)
        emit("paged", part="tick_profile", mode=mode, decoding_slots=4,
             host_ms=host_ms, **prof)
        del server, reqs
    torch.cuda.empty_cache()

    def serve_line(part, run, server, **extra):
        n_tok = sum(len(r.out) for r in run["reqs"])
        emit("paged", part=part, **PAGED, requests=PAGED_REQUESTS,
             prompt_len=PROMPT_LEN, max_new=MAX_NEW, ticks=server.ticks,
             wall_s=run["wall_s"], tokens=n_tok,
             tok_per_s=n_tok / run["wall_s"], deferrals=server.deferrals,
             peak_used_pages=server.peak_used_pages,
             peak_active=server.peak_active, kv_stats=server.kv_stats(),
             stats=server.stats(), **extra)

    # (a) paged, full width, bf16
    server = Server(api, params, **PAGED)
    run_a = two_waves(server, prompts, MAX_NEW)
    serve_line("paged_bf16", run_a, server)
    out_a = [r.out for r in run_a["reqs"]]
    del server

    # (b) share_prefix: the last four map the first four's 16 pages; the
    # allocator records every call, for phase 8(e)
    server = Server(api, params, **PAGED, share_prefix=True,
                    scheduler="prefix")
    server.alloc.trace = []
    run_b = two_waves(server, prompts, MAX_NEW)
    shared_trace = {"trace": list(server.alloc.trace),
                    "spec": server.alloc.spec, "n_slots": server.batch,
                    "prompts": prompts,
                    "out": [r.out for r in run_b["reqs"]],
                    "ticks": server.ticks, "wall_s": run_b["wall_s"]}
    equal = sum(x == y for o_a, o_b in zip(out_a, (r.out for r in
                                                    run_b["reqs"]))
                for x, y in zip(o_a, o_b))
    serve_line("shared_bf16", run_b, server,
               max_shared_pages=run_b["max_shared_pages"],
               tokens_equal_to_paged=equal)
    if run_b["max_shared_pages"] <= 0 or server.share_hits <= 0:
        raise AssertionError("share_prefix never shared a page")
    del server

    # (d') n-gram speculation at full width: on (a)'s random prompts no
    # n-gram recurs and nothing is drafted, so each prompt is one token
    # repeated; after every tick each live slot backs exactly its
    # positions (the paged verify, the length-gated commit and the rewind
    # at 40 layers)
    rep_prompts = [[t] * PROMPT_LEN for t in prefix[:PAGED_REQUESTS]]
    server = Server(api, params, **PAGED, speculate="ngram",
                    spec_depth=SPEC_DEPTH)
    run = two_waves(server, rep_prompts, MAX_NEW,
                    after_tick=backs_exactly_its_positions)
    st = server.stats()
    if st["spec_ticks"] <= 0 or st["spec_proposed"] <= 0:
        raise AssertionError(f"the n-gram drafter drafted nothing: {st}")
    ngram = (server, run)

    # (d) self-draft on the f32 cut, paged, 4 requests: after every tick
    # each live slot backs exactly its positions and the pool holds no
    # other page
    spec_prompts = prompts[:4]

    def drain(**kw):
        server = Server(api_cut, p_cut, **PAGED, **kw)
        verified = {"slots": 0, "tokens": 0}
        reqs = [server.submit(q, max_new=MAX_NEW) for q in spec_prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10_000):
            before = {id(r): (len(r.out), r.spec_proposed)
                      for r in server.slot_req if r is not None}
            if server.tick() == 0 and not server.queue:
                break
            backs_exactly_its_positions(server)
            for r in reqs:
                if id(r) in before and r.spec_proposed > before[id(r)][1]:
                    verified["slots"] += 1
                    verified["tokens"] += len(r.out) - before[id(r)][0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(r.done and len(r.out) == MAX_NEW for r in reqs):
            raise AssertionError("speculative drain did not finish")
        return server, [r.out for r in reqs], verified, wall

    base_srv, base_out, _, base_wall = drain()
    drafter = RecordingDrafter(DraftModelDrafter(api_cut, p_cut, bucket=128))
    spec_srv, spec_out, verified, spec_wall = drain(speculate=drafter,
                                                    spec_depth=SPEC_DEPTH)
    released = (spec_srv.alloc.free_pages == spec_srv.alloc.spec.n_pages
                and bool((spec_srv.alloc.page_table < 0).all()))
    if not released:
        raise AssertionError("the speculative drain kept pages after its "
                             "last request retired")
    st = spec_srv.stats()
    launches = [c.launches for c in counters]   # the path ends here

    # (d')'s line, and its tokens against a never-speculated paged drain
    server, run = ngram
    ng_base = Server(api, params, **PAGED)
    base = two_waves(ng_base, rep_prompts, MAX_NEW)
    equal = sum(x == y for r, b in zip(run["reqs"], base["reqs"])
                for x, y in zip(r.out, b.out))
    serve_line("ngram_bf16", run, server, prompts="one token repeated",
               accept_rate=server.stats()["accept_rate"],
               tokens_equal_to_unspeculated=equal, base_ticks=ng_base.ticks,
               base_wall_s=base["wall_s"])
    del server, run, ng_base, base, ngram
    torch.cuda.empty_cache()

    # the checks: (c) paged (free list shuffled from a seed) and shared,
    # each against the contiguous drain, on the f32 cut
    runs = {}
    for name, kw in (("contiguous", dict(SERVE)),
                     ("paged_shuffled", dict(PAGED)),
                     ("shared", dict(PAGED, share_prefix=True,
                                     scheduler="prefix"))):
        server = Server(api_cut, p_cut, **kw)
        if server.alloc is not None:
            server.alloc._free = [int(x) for x in np.random.default_rng(
                3).permutation(server.alloc.spec.n_pages)]
        run = two_waves(server, prompts, MAX_NEW)
        runs[name] = ([r.out for r in run["reqs"]], server.stats(),
                      run["max_shared_pages"])
        del server
    for name in ("paged_shuffled", "shared"):
        cmp = first_divergence(api_cut, p_cut, prompts, runs[name][0],
                               runs["contiguous"][0], d, dev)
        emit("paged", part=f"{name}_vs_contiguous_f32_cut",
             n_layers=DEPTH_CUT, gap_threshold=GAP_MULT * d,
             share_hits=runs[name][1]["share_hits"],
             max_shared_pages=runs[name][2], **cmp)
    if runs["shared"][1]["share_hits"] <= 0:
        raise AssertionError("the f32 shared drain never shared")

    # (d)'s tokens against the never-speculated drain's, the same rule
    cmp = first_divergence(api_cut, p_cut, spec_prompts, spec_out, base_out,
                           d, dev)
    emit("paged", part="self_draft_f32_cut", n_layers=DEPTH_CUT,
         spec_depth=SPEC_DEPTH, accept_rate=st["accept_rate"],
         spec_ticks=st["spec_ticks"], ticks=spec_srv.ticks,
         base_ticks=base_srv.ticks, verified_slots=verified["slots"],
         tokens_per_verified_slot=(verified["tokens"] / verified["slots"]
                                   if verified["slots"] else None),
         wall_s=spec_wall, base_wall_s=base_wall,
         released_every_page=released, gap_threshold=GAP_MULT * d,
         **drafts_against_target(api_cut, p_cut, drafter.calls,
                                 [list(q) + o for q, o in
                                  zip(spec_prompts, spec_out)], d, dev),
         **cmp)
    if verified["slots"] <= 0:
        raise AssertionError("self-draft never verified a draft")
    del base_srv, spec_srv
    torch.cuda.empty_cache()
    return launches, shared_trace


def model_check(dev, counters, shared_trace) -> dict:
    """Phase 8: the paper's model checker, with the sweep_eval kernel on
    the card holding its answers.  (a) the Minimum model at each size and
    engine: t_min equal to the ``sweep`` engine's, the witness's trail
    replayed on the model, and the kernel over the spec's whole (WG, TS)
    lattice: its minimum equal to t_min, its value at the witness equal
    to the witness's time, and equal to its plain version point for
    point; (b) Table 1's abstract rows against ``sweep`` (the kernel
    implements the Minimum model only), the paper's value beside each;
    (c) a witness through the tuning cache and back; (d) ``verify``: the
    allocator model at ``AllocConfig()``, the server and speculation
    models, the six mutants with their trails replayed on the real
    allocator; (e) phase 7(b)'s allocator trace as a model path.  Returns
    each kernel's launches during (a)-(e) and the kernel's time on each
    Minimum lattice, measured after the launches are read."""

    import torch
    from repro_torch.core import PlatformSpec, build_model
    from repro_torch.kernels.common import ISSUE_RATE
    from repro_torch.kernels.sweep_eval.ops import (point_ops, sweep_eval,
                                                    sweep_ref)
    from repro_torch.runtime.kv import PagedKVAllocator
    from repro_torch.verify import (
        MUTANTS, AllocConfig, AllocatorSemantics, ConformanceError,
        ServerConfig, ServerScenario, ServerSemantics, SpecConfig,
        SpecSemantics, allocator_invariants, build_driver_model,
        coupled_explore, replay_ops, server_invariants, spec_invariants,
        trace_accepted, violates_any)
    from repro_torch.core.explorer import explore
    from repro_torch.tune import PlatformTunable, TuningCache, tune

    t_phase = time.perf_counter()
    for c in counters:
        c.launches = 0
    lattices = {}

    def engine_row(spec, engine, kw):
        tunable = PlatformTunable(spec)
        sweep = tune(tunable, engine="sweep", cache=None)
        t0 = time.perf_counter()
        res = tune(tunable, engine=engine, cache=None, **kw)
        wall = time.perf_counter() - t0
        valid = res.witness.validate(build_model(spec))
        if res.t_min != sweep.t_min or not valid:
            raise AssertionError(f"{spec.kind} size {spec.size} {engine}: "
                                 f"t_min {res.t_min} (sweep {sweep.t_min}), "
                                 f"witness replays: {valid}")
        return res, sweep, wall, {
            "kind": spec.kind, "size": spec.size, "engine": res.engine,
            "t_min": res.t_min, "sweep_t_min": sweep.t_min,
            "best_config": res.best_config,
            "sweep_best_config": sweep.best_config,
            "states": res.stats.get("states"),
            "terminals": res.stats.get("terminals"),
            "walks": res.stats.get("walks"), "wall_s": wall,
            "witness_depth": res.witness.depth, "witness_replays": valid}

    # (a) the Minimum model, each model-checked answer on the card
    for size, engines in MC_MINIMUM.items():
        spec = PlatformSpec(size, NP=4, GMT=4, kind="minimum")
        wave = PlatformTunable(spec).wave
        choices = spec.config_choices()
        wg = torch.tensor([w for w, _ in choices], dtype=torch.int32,
                          device=dev)
        ts = torch.tensor([t for _, t in choices], dtype=torch.int32,
                          device=dev)
        times = sweep_eval(wg, ts, wave, threads=64, ept=1)
        plain = sweep_ref(wave, wg.cpu(), ts.cpu())
        if not torch.equal(times.cpu(), plain):
            raise AssertionError(f"minimum size {size}: the kernel differs "
                                 f"from its plain version")
        on_card = dict(zip(choices, times.cpu().tolist()))
        lattices[size] = (wg, ts, wave)
        for engine in engines:
            kw = MC_SWARM if engine == "swarm" else {}
            res, _, _, row = engine_row(spec, engine, kw)
            w = res.witness
            at_witness = on_card[(w.config["WG"], w.config["TS"])]
            if min(on_card.values()) != res.t_min or at_witness != w.time:
                raise AssertionError(
                    f"minimum size {size} {engine}: kernel minimum "
                    f"{min(on_card.values())}, at the witness {at_witness}; "
                    f"model checker {res.t_min}, witness {w.time}")
            emit("model_check", part="minimum", lattice_points=len(choices),
                 kernel_min=min(on_card.values()),
                 kernel_at_witness=at_witness, **row)

    # (b) Table 1's abstract rows, held to the host sweep
    for size, engine in MC_ABSTRACT:
        spec = PlatformSpec(size, NP=4, GMT=4, kind="abstract")
        kw = MC_ABSTRACT_SWARM if engine == "swarm" else {}
        _, _, _, row = engine_row(spec, engine, kw)
        paper = PAPER_T1[size]
        emit("model_check", part="table1_abstract",
             paper={"t": paper[0], "TS": paper[1], "WG": paper[2]}, **row)

    # (c) a model-checked witness through the cache and back
    with tempfile.TemporaryDirectory() as tmp:
        spec = PlatformSpec(16, NP=4, GMT=4, kind="minimum")
        path = Path(tmp) / "tune_cache.json"
        cache = TuningCache(path)
        first = tune(PlatformTunable(spec), engine="explorer", cache=cache)
        cache.save()
        again = tune(PlatformTunable(spec), engine="explorer",
                     cache=TuningCache(path))
        valid = again.witness.validate(build_model(spec))
        if first.stats["cache"] != "miss" or \
                again.stats["cache"] != "hit" or not valid or \
                again.witness.trail != first.witness.trail:
            raise AssertionError(f"cache round trip: {first.stats['cache']}, "
                                 f"{again.stats['cache']}, replays {valid}")
        emit("model_check", part="cache", first=first.stats["cache"],
             second=again.stats["cache"], t_min=again.t_min,
             witness_depth=again.witness.depth, witness_replays=valid)

    # (d) verify at the reference's sizes
    t0 = time.perf_counter()
    res = explore(build_driver_model(AllocatorSemantics(AllocConfig(),
                                                        canonical=True)),
                  violates_any(allocator_invariants()), schedule="por")
    emit("model_check", part="verify_allocator", config="AllocConfig()",
         canonical=True, status=res.status, states=res.states,
         transitions=res.transitions, wall_s=time.perf_counter() - t0)
    if res.status != "verified":
        raise AssertionError(f"allocator model: {res.status}")
    for name, (cfg_kw, scen_kw) in MC_SERVERS.items():
        cfg = ServerConfig(**cfg_kw)
        t0 = time.perf_counter()
        res = explore(build_driver_model(ServerSemantics(
            cfg, ServerScenario(**scen_kw))), violates_any(
                server_invariants(cfg)), schedule="por")
        emit("model_check", part="verify_server", case=name,
             status=res.status, states=res.states,
             wall_s=time.perf_counter() - t0)
        if res.status != "verified":
            raise AssertionError(f"server model {name}: {res.status}")
    cfg = SpecConfig()
    t0 = time.perf_counter()
    res = explore(build_driver_model(SpecSemantics(cfg)),
                  violates_any(spec_invariants(cfg)), schedule="por")
    emit("model_check", part="verify_spec", status=res.status,
         states=res.states, wall_s=time.perf_counter() - t0)
    if res.status != "verified":
        raise AssertionError(f"speculation model: {res.status}")
    sem = AllocatorSemantics(AllocConfig(**MC_SMALL_ALLOC), canonical=True)
    for name, cls in sorted(MUTANTS.items()):
        res = coupled_explore(sem, cls)
        if res.ok or not res.ops:
            raise AssertionError(f"mutant {name} not caught")
        try:
            replay_ops(sem, list(res.ops), cls)
        except ConformanceError:
            pass
        else:
            raise AssertionError(f"mutant {name}: its trail replays clean")
        replay_ops(sem, list(res.ops), PagedKVAllocator)
        emit("model_check", part="verify_mutant", mutant=name, caught=True,
             trail_ops=len(res.ops), states=res.states)

    # (e) phase 7(b)'s full-width shared-prefix drain as a model path
    spec = shared_trace["spec"]
    trace = shared_trace["trace"]
    t0 = time.perf_counter()
    trace_accepted(AllocatorSemantics(AllocConfig(
        n_slots=shared_trace["n_slots"], page_size=spec.page_size,
        pages_per_slot=spec.pages_per_slot, n_pages=spec.n_pages),
        canonical=False), trace)
    ops = sorted({m for m, _, _ in trace})
    emit("model_check", part="drain_trace_accepted", records=len(trace),
         ops=ops, n_pages=spec.n_pages, page_size=spec.page_size,
         wall_s=time.perf_counter() - t0)
    if "share" not in ops or "cow_pages" not in ops:
        raise AssertionError(f"the shared drain's trace holds {ops}")
    launches = [c.launches for c in counters]
    phase_s = time.perf_counter() - t_phase

    # the kernel on each Minimum lattice, timed after the launches are read
    kernel_ms = {}
    for size, (wg, ts, wave) in lattices.items():
        n = wg.numel()
        b, by = bound_ms(3 * 4 * n, point_ops(wave) * n, ISSUE_RATE)
        kernel_ms[size] = {
            "points": n,
            "ms": time_ms(lambda: sweep_eval(wg, ts, wave, threads=64,
                                             ept=1), 100),
            "plain_ms": time_ms(lambda: sweep_ref(wave, wg, ts), 20),
            "bound_ms": b, "bound_by": by}
    emit("model_check", part="sweep_eval_small", times=kernel_ms,
         launch=[64, 1])
    emit("model_check", part="total", seconds=phase_s)
    return {"launches": launches, "kernel_ms": kernel_ms}


class Recording:
    """A tunable passed through to an engine, keeping each measured
    point's last drain counters (the tunable keeps only the last call's).
    Its fingerprint is the tunable's, so its cache entries are the ones
    ``choose_batch``/``choose_scheduler`` read."""

    def __init__(self, inner):
        self.inner, self.name, self.points = inner, inner.name, {}

    def space(self):
        return self.inner.space()

    def cost(self, cfg):
        return self.inner.cost(cfg)

    def fingerprint(self):
        return self.inner.fingerprint()

    def measure(self, cfg, *, warmup=1, iters=1):
        us = self.inner.measure(cfg, warmup=warmup, iters=iters)
        self.points[json.dumps(dict(cfg), sort_keys=True)] = \
            self.inner.last_stats
        return us

    def stats(self, cfg) -> dict:
        return self.points[json.dumps(dict(cfg), sort_keys=True)]


def rederived_us(name, tb, cfg, spec) -> float:
    """A serving tunable's modeled drain written out again from
    ``kv_cache_stream_s`` and the platform constants (the reference's
    models: bf16 weights, 2 bytes a parameter; the scheduler's priced on
    its architecture's reduced config, with 50 us a tick)."""

    from repro_torch.configs import get_config
    from repro_torch.runtime.tunables import kv_cache_stream_s as kv
    from repro_torch.runtime.workload import TraceConfig

    def ceil(a, b):
        return -(-a // b)

    bw, peak = spec.hbm_bw, spec.peak_flops
    if name == "serve.scheduler":
        acfg = get_config(tb.arch).reduced()
        L, dm = acfg.n_layers, acfg.d_model
        weights = 2 * (acfg.vocab * dm + L * 12 * dm * dm) / bw
        prefix = cfg["policy"] == "prefix"
        mp = sum(tb.prompt_len) / 2 + tb.shared_frac * tb.prefix_len
        mn = sum(tb.max_new) / 2
        pre = ceil(mp, tb.prefill_chunk)
        if prefix:
            pre *= max(0.1, 1 - tb.shared_frac * tb.prefix_len / mp)
        service = pre + mn
        pool = (tb.kv_pages * tb.page_size if tb.kv_pages
                else tb.batch * tb.context)
        foot = ceil(mp + mn, tb.page_size) * tb.page_size
        if prefix:
            foot -= tb.shared_frac * tb.prefix_len
        conc = max(1.0, min(tb.batch, pool / max(1.0, foot)))
        burst = (tb.burst if tb.arrival == "bursty"
                 else max(1.0, tb.rate * service))
        wait = burst / 2 / conc * service
        if cfg["policy"] == "priority":
            wait = burst * tb.interactive_frac / 2 / conc * service
        dl = TraceConfig().deadlines["interactive"]
        met_int = (1.0 if wait + service <= dl
                   else max(0.05, dl / (wait + service)))
        met = tb.interactive_frac * met_int + 1 - tb.interactive_frac
        tick_us = (weights + kv(conc, L, int(mp + mn),
                                acfg.n_kv_heads * acfg.hd) + 50e-6) * 1e6
        return (ceil(tb.requests, conc) * service * tick_us
                / max(1.0, met * tb.requests * mn))
    weights = tb.param_bytes / bw
    flops = 2 * (tb.param_bytes / 2) / peak      # a token's, bf16 weights
    if name == "serve.decode_batch":
        b = cfg["batch"]
        tick = (weights + kv(b, tb.layers, tb.context, tb.kv_width)
                + tb.dispatch_s)
        return ceil(tb.requests, b) * tb.mean_new * tick * 1e6
    B, L, C = tb.batch, tb.layers, tb.context
    if name == "serve.kv_page":
        page = cfg["page"]
        totals = [min(q, C - tb.mean_new) + tb.mean_new
                  for q in tb.prompt_lens]
        mean_total = sum(totals) / len(totals)
        foot = sum(ceil(t, page) * page for t in totals) / len(totals)
        conc = max(1, min(B, int((tb.pool_tokens or B * C) // foot)))
        ticks = (ceil(int(mean_total - tb.mean_new), tb.prefill_chunk)
                 + tb.mean_new)
        tick = (weights + kv(conc, L, int(mean_total), tb.kv_width)
                + conc * ceil(int(mean_total), page) * tb.page_gather_s
                + tb.dispatch_s)
        return ceil(tb.requests, conc) * ticks * tick * 1e6
    stream = weights + kv(B, L, C, tb.kv_width) + tb.dispatch_s
    if name == "serve.prefill_chunk":
        c = cfg["chunk"]
        prefill = stream + flops * c * B + B * L * c * (C + c) * 4 / bw
        decode = stream + flops * B
        return ceil(tb.requests, B) * (ceil(tb.prompt_len, c) * prefill
                                       + tb.mean_new * decode) * 1e6
    d = cfg["depth"]                                  # serve.spec_depth
    a = {"ngram": tb.accept_ngram, "draft": tb.accept_draft}[cfg["drafter"]]
    spec_tick = (2 * (weights + flops * (d + 1) * B) + stream
                 - weights)                         # one KV stream a tick
    if cfg["drafter"] == "draft":
        spec_tick += d * tb.draft_cost_ratio * (weights + flops * B)
    tokens = 1 + sum(a ** i for i in range(1, d + 1))
    return ceil(tb.requests, B) * (ceil(tb.prompt_len, 32)
                                   * (stream + flops * B)
                                   + tb.mean_new / tokens * spec_tick) * 1e6


def policy_divergence(api, plain_api, params, base, other, dev) -> dict:
    """Phase 9(c)'s rule at bf16 full width, for two policies' drains of
    one trace: a request never evicted under either policy ran the same
    arithmetic in both (fixed step shapes, one row a slot), so its tokens
    must be equal; an evicted one re-prefilled its generated tokens in a
    chunk, so up to its first differing step its tokens are equal and
    that step must be a near tie, as phase 7's rule has it (top-2 gap
    under 10 d, both tokens within 10 d of the maximum), with d the
    largest difference of two correct bf16 forwards' logits (flash and
    plain) at that history."""

    equal, total, diverged = 0, 0, []
    for rid, (prompt, w, evicted_w) in base.items():
        _, g, evicted_g = other[rid]
        if len(g) != len(w):
            raise AssertionError(f"request {rid}: {len(g)} != {len(w)} "
                                 f"tokens")
        total += len(w)
        k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if k is None:
            equal += len(w)
            continue
        equal += k
        if not (evicted_w or evicted_g):
            raise AssertionError(f"request {rid} step {k}: {g[k]} != "
                                 f"{w[k]}, never evicted under either "
                                 f"policy")
        hist = list(prompt) + w[:k]
        flash = padded_logits(api, params, [hist], dev)[0]
        plain = padded_logits(plain_api, params, [hist], dev)[0]
        d = float((flash - plain).abs().max())
        _, gap = top2(flash)
        deficits = [float(flash.max() - flash[t]) for t in (g[k], w[k])]
        if float(gap) >= GAP_MULT * d or max(deficits) > GAP_MULT * d:
            raise AssertionError(
                f"request {rid} step {k}: {g[k]} != {w[k]} at top-2 gap "
                f"{float(gap)}, deficits {deficits} (10 d = {GAP_MULT * d})")
        diverged.append({"request": rid, "step": k, "top2_gap": float(gap),
                         "d": d})
    return {"tokens_equal": equal, "tokens": total, "divergences": diverged}


def serve_tune(dev, counters, model) -> dict:
    """Phase 9: the serving tunables at qwen1.5-4b's full width, on phase
    6's bf16 weights, under the H100 data-sheet constants.  (a) the five
    tunables built through their factories, the grid engine's pick and
    every lattice point's modeled cost, each held to a plain
    re-derivation; (b) the slot count under the measure engine (real
    contiguous drains of the shortlist, modeled against measured), then
    ``choose_batch`` again, a cache hit, and (b') the prefill chunk and
    the page size, each at its two best modeled points; (c) the
    scheduling policy under
    the measure engine over one seeded bursty trace through the paged
    Server, every lattice point drained; (d) the serving driver's
    ``--tune-*`` flags in-process; (e) speculation's depths measured on
    the f32 cut with the n-gram drafter.  Those are the path whose
    launches are returned (none is expected: the Server attends with
    plain ops).  Then the checks: (c)'s tokens across policies by
    :func:`policy_divergence`, and the same trace on the f32 cut, where
    every policy must give every request the same tokens."""

    import contextlib
    import io

    import torch
    from repro_torch.calibrate import (DEFAULT_SPEC, get_platform_spec,
                                       set_platform_spec)
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.runtime.scheduler import make_scheduler
    from repro_torch.runtime.speculate import spec_depth_tunable
    from repro_torch.runtime.tunables import (choose_batch, choose_scheduler,
                                              decode_batch_tunable,
                                              kv_page_tunable,
                                              prefill_chunk_tunable,
                                              scheduler_tunable,
                                              timed_trace_drain)
    from repro_torch.runtime.workload import generate_trace
    from repro_torch.tune import TuningCache, set_default_cache, tune

    api, params = model["api"], model["params"]
    api_cut, p_cut = model["api_cut"], model["p_cut"]
    t_phase = time.perf_counter()
    for c in counters:
        c.launches = 0
    prev_spec = set_platform_spec(DEFAULT_SPEC)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cache = TuningCache(Path(tmp) / "serve_tune.json")

            # (a) the modeled picks
            spec = get_platform_spec()
            tunables = {
                "serve.decode_batch": decode_batch_tunable(
                    api, params=params, **TUNE_LOAD),
                "serve.prefill_chunk": prefill_chunk_tunable(
                    api, prompt_len=TUNE_PROMPT, batch=TUNE_SLOTS,
                    params=params, **TUNE_LOAD),
                "serve.kv_page": kv_page_tunable(
                    api, prompt_lens=[TUNE_PROMPT], batch=TUNE_SLOTS,
                    params=params, **TUNE_LOAD),
                "serve.spec_depth": spec_depth_tunable(
                    api, prompt_len=TUNE_PROMPT, batch=TUNE_SLOTS,
                    params=params, **TUNE_LOAD),
                "serve.scheduler": scheduler_tunable(api, params=params,
                                                     **SCHED)}
            picks, measured = {}, {}

            def keep(name, tb, res, rec):
                measured[name] = {"tunable": tb, "points": [
                    (dict(c["config"]), c["measured"], c["modeled"],
                     rec.stats(c["config"])["ticks"])
                    for c in res.stats["candidates"]]}

            for name, tb in tunables.items():
                res = tune(tb, engine="grid", cache=None)
                lattice = []
                for cfg in tb.space():
                    got, want = tb.cost(cfg), rederived_us(name, tb, cfg,
                                                           spec)
                    if not abs(got - want) <= MODEL_REL * abs(want):
                        raise AssertionError(f"{name} {cfg}: modeled {got} "
                                             f"us, re-derived {want}")
                    lattice.append([dict(cfg), got])
                picks[name] = dict(res.best_config)
                emit("serve_tune", part="modeled", tunable=name,
                     pick=picks[name], modeled_us=res.t_min,
                     hbm_bw=spec.hbm_bw, peak_flops=spec.peak_flops,
                     lattice=lattice)

            # (b) the slot count, measured: choose_batch's tune, through
            # Recording for each point's counters
            rec = Recording(decode_batch_tunable(api, params=params,
                                                 **TUNE_LOAD))
            t0 = time.perf_counter()
            res = tune(rec, engine="measure", cache=cache, **SLOT_ENGINE)
            tune_s = time.perf_counter() - t0
            keep("serve.decode_batch", rec.inner, res, rec)
            for c in res.stats["candidates"]:
                st = rec.stats(c["config"])
                emit("serve_tune", part="measured_batch",
                     batch=c["config"]["batch"], modeled_us=c["modeled"],
                     measured_us=c["measured"],
                     measured_over_modeled=c["measured"] / c["modeled"],
                     ticks=st["ticks"], tokens=st["tokens_generated"])
                if st["tokens_generated"] != (TUNE_LOAD["requests"]
                                              * TUNE_LOAD["max_new"]):
                    raise AssertionError(f"slot count drain: {st}")
            t0 = time.perf_counter()
            batch, again = choose_batch(api, params=params, cache=cache,
                                        engine="measure", **TUNE_LOAD,
                                        **SLOT_ENGINE)
            again_s = time.perf_counter() - t0
            emit("serve_tune", part="measured_batch_pick",
                 modeled_pick=res.stats["modeled_pick"],
                 measured_pick=res.stats["measured_pick"], tune_s=tune_s,
                 second_call=again.stats.get("cache"), second_pick=batch,
                 second_call_s=again_s)
            if again.stats.get("cache") != "hit" or \
                    batch != res.best_config["batch"]:
                raise AssertionError(f"choose_batch again: {batch}, "
                                     f"{again.stats}")

            # (b') the prefill chunk and the page size, measured: (a)'s
            # tunables, their two best modeled points drained once each
            for name in ("serve.prefill_chunk", "serve.kv_page"):
                rec = Recording(tunables[name])
                res = tune(rec, engine="measure", cache=cache,
                           **PAIR_ENGINE)
                keep(name, rec.inner, res, rec)
                for c in res.stats["candidates"]:
                    st = rec.stats(c["config"])
                    emit("serve_tune", part="measured", tunable=name,
                         **c["config"], modeled_us=c["modeled"],
                         measured_us=c["measured"],
                         measured_over_modeled=c["measured"] / c["modeled"],
                         ticks=st["ticks"], tokens=st["tokens_generated"],
                         deferrals=st["deferrals"])
                emit("serve_tune", part="measured_pick", tunable=name,
                     modeled_pick=res.stats["modeled_pick"]["config"],
                     measured_pick=res.best_config)

            # (c) the scheduling policy, measured over one seeded trace
            rec = Recording(scheduler_tunable(api, params=params, **SCHED))
            t0 = time.perf_counter()
            res = tune(rec, engine="measure", cache=cache, **SCHED_ENGINE)
            tune_s = time.perf_counter() - t0
            keep("serve.scheduler", rec.inner, res, rec)
            outs = {}
            for c in res.stats["candidates"]:
                st = rec.stats(c["config"])
                emit("serve_tune", part="scheduler", **c["config"],
                     us_per_goodput_token=c["measured"],
                     modeled_us_per_goodput_token=c["modeled"],
                     **{k: st[k] for k in (
                         "goodput_tokens", "tokens", "p50_all", "p99_all",
                         "slo_attainment", "deferrals", "preemptions",
                         "shared_tokens", "ticks", "mean_active")})
                outs[(c["config"]["policy"], c["config"]["age_limit"])] = {
                    rid: (r["request"].prompt, list(r["request"].out),
                          r["request"].preempted > 0)
                    for rid, r in st["records"].items()}
            again_pick, again = choose_scheduler(
                api, params=params, cache=cache, engine_kw=SCHED_ENGINE,
                **SCHED)
            emit("serve_tune", part="scheduler_pick",
                 pick=res.best_config, modeled_pick=picks["serve.scheduler"],
                 tune_s=tune_s, second_call=again.stats.get("cache"))
            if again.stats.get("cache") != "hit" or \
                    list(again_pick) != [res.best_config["policy"],
                                         res.best_config["age_limit"]]:
                raise AssertionError(f"choose_scheduler again: {again_pick}")
            if len(outs) != len(SCHED["policies"]) * len(SCHED["age_limits"]):
                raise AssertionError(f"measured points: {sorted(outs)}")
            del rec
            torch.cuda.empty_cache()

            # (d) the serving driver, in-process, under a cache of its own
            argv = ["--arch", MODEL, "--preset", "full", "--context", "1024",
                    "--requests", "4", "--prompt-len", "512", "--max-new",
                    "16", "--tune-batch", "--tune-prefill", "--tune-page",
                    "--tune-engine", "grid"]
            buf = io.StringIO()
            prev = set_default_cache(TuningCache(Path(tmp) / "driver.json"))
            try:
                with contextlib.redirect_stdout(buf):
                    serve_main(argv)
            finally:
                set_default_cache(prev)
            lines = buf.getvalue().splitlines()
            emit("serve_tune", part="driver", argv=argv, output=lines)
            if sum(ln.startswith("[tune]") for ln in lines) != 3 or \
                    not any("parameters on cuda:0" in ln for ln in lines) \
                    or not any(ln.startswith("served 4 requests / 64 tokens")
                               for ln in lines):
                raise AssertionError("the serving driver's output")
            torch.cuda.empty_cache()

            # (e) speculation's depths, measured on the f32 cut
            rec = Recording(spec_depth_tunable(api_cut, params=p_cut,
                                               **SPEC_LOAD))
            res = tune(rec, engine="measure", cache=None, top_k=4, repeats=1)
            keep("serve.spec_depth", rec.inner, res, rec)
            for c in res.stats["candidates"]:
                st = rec.stats(c["config"])
                emit("serve_tune", part="spec_depth_f32_cut",
                     n_layers=DEPTH_CUT, **c["config"],
                     modeled_us=c["modeled"], measured_us=c["measured"],
                     measured_over_modeled=c["measured"] / c["modeled"],
                     **{k: st[k] for k in ("spec_proposed", "spec_accepted",
                                           "ticks", "tokens_generated")})
            emit("serve_tune", part="spec_depth_pick",
                 modeled_pick_full_width=picks["serve.spec_depth"],
                 measured_pick_f32_cut=res.best_config,
                 modeled_pick_f32_cut=res.stats["modeled_pick"]["config"])
            if len(res.stats["candidates"]) != 4:
                raise AssertionError("speculation: not every depth measured")
            torch.cuda.synchronize()
            # (f) the path ends here
            launches = [c.launches for c in counters]
            phase_s = time.perf_counter() - t_phase

            # the checks: (c)'s tokens across policies at bf16, full width
            base = outs[(SCHED["policies"][0], SCHED["age_limits"][0])]
            for key, other in outs.items():
                emit("serve_tune", part="policy_tokens_bf16", policy=key[0],
                     age_limit=key[1], against=SCHED["policies"][0],
                     **policy_divergence(api, model["plain_api"], params,
                                         base, other, dev))
            # and on the f32 cut, exactly
            trace = generate_trace(scheduler_tunable(
                api_cut, **SCHED).trace_config())
            cut = {}
            for policy in SCHED["policies"]:
                st = {}
                timed_trace_drain(
                    api_cut, p_cut, trace, batch=SCHED["batch"],
                    context=SCHED["context"],
                    prefill_chunk=SCHED["prefill_chunk"], paged=True,
                    page_size=SCHED["page_size"],
                    kv_pages=SCHED["kv_pages"],
                    scheduler=make_scheduler(
                        policy, age_limit=SCHED["age_limits"][0]),
                    share_prefix=policy == "prefix", stats_out=st,
                    warmup=0, iters=1)
                cut[policy] = {rid: list(r["request"].out)
                               for rid, r in st["records"].items()}
                emit("serve_tune", part="policy_tokens_f32_cut",
                     n_layers=DEPTH_CUT, policy=policy,
                     equal_to=SCHED["policies"][0],
                     equal=cut[policy] == cut[SCHED["policies"][0]],
                     **{k: st[k] for k in ("ticks", "goodput_tokens",
                                           "deferrals", "preemptions",
                                           "shared_tokens")})
            if any(v != cut[SCHED["policies"][0]] for v in cut.values()):
                raise AssertionError("the f32 cut's tokens differ across "
                                     "policies")
    finally:
        set_platform_spec(prev_spec)
    torch.cuda.synchronize()
    emit("serve_tune", part="phase", seconds=phase_s,
         checks_s=time.perf_counter() - t_phase - phase_s)
    return {"launches": launches, "picks": picks, "tunables": tunables,
            "measured": measured}


def repriced(measured, tunables, picks, fitted) -> None:
    """Phase 10(d): phase 9's measured drains against each tunable's
    modeled cost under the data-sheet spec and under the fitted one (the
    models as they are: the fitted bandwidth and FLOP/s, the tunables'
    own 50 us dispatch), and with the fitted dispatch latency put in the
    tunables' ``dispatch_s`` (charged once a tick, as the models charge
    it).  For the slot count, the implied dispatches a tick are the
    measured tick less the fitted model's bytes and FLOPs a tick (its
    tick less its one dispatch), over the fitted dispatch latency.
    Then each tunable's grid pick under the fitted spec against phase 9's
    (a)."""

    import dataclasses

    from repro_torch.calibrate import DEFAULT_SPEC, set_platform_spec
    from repro_torch.tune import tune

    prev = set_platform_spec(DEFAULT_SPEC)
    try:
        default = {name: [tb["tunable"].cost(cfg) for cfg, *_ in
                          tb["points"]] for name, tb in measured.items()}
        set_platform_spec(fitted)
        for name, entry in measured.items():
            tb = entry["tunable"]
            has_dispatch = hasattr(tb, "dispatch_s")
            tb_disp = (dataclasses.replace(tb, dispatch_s=fitted.dispatch_s)
                       if has_dispatch else None)
            rows = []
            for (cfg, us, modeled, ticks), d_us in zip(entry["points"],
                                                       default[name]):
                if abs(d_us - modeled) > MODEL_REL * abs(modeled):
                    raise AssertionError(f"{name} {cfg}: phase 9 modeled "
                                         f"{modeled}, now {d_us}")
                f_us = tb.cost(cfg)
                row = {"config": cfg, "measured_us": us, "ticks": ticks,
                       "modeled_default_us": d_us, "modeled_fitted_us": f_us,
                       "ratio_default": us / d_us, "ratio_fitted": us / f_us}
                if has_dispatch:
                    fd_us = tb_disp.cost(cfg)
                    row.update(modeled_fitted_dispatch_us=fd_us,
                               ratio_fitted_dispatch=us / fd_us,
                               measured_tick_us=us / ticks)
                if name == "serve.decode_batch":
                    # the model's ticks: ceil(requests / slots) waves of
                    # mean_new decode ticks
                    model_ticks = (-(-tb.requests // cfg["batch"])
                                   * tb.mean_new)
                    work_us = f_us / model_ticks - tb.dispatch_s * 1e6
                    row.update(modeled_work_per_tick_us=work_us,
                               implied_dispatches_per_tick=(
                                   (us / ticks - work_us)
                                   / fitted.dispatch_us))
                rows.append(row)
            emit("calibrate", part="repriced", tunable=name,
                 dispatch_us_fitted=fitted.dispatch_us, points=rows)
        moved = {}
        for name, tb in tunables.items():
            pick = dict(tune(tb, engine="grid", cache=None).best_config)
            moved[name] = {"default": picks[name], "fitted": pick,
                           "moved": pick != picks[name]}
        emit("calibrate", part="repriced_picks", picks=moved)
    finally:
        set_platform_spec(prev)


def calibrate_and_observe(dev, counters, model, served) -> dict:
    """Phase 10: the card calibrated, and the Server observed on it.
    (a) the probes at the card's ladders, the fit against the data sheet,
    then ``ensure_calibrated`` twice on a temporary artifact (the second
    a pure load); (b) a plan with ``"calibrate": true``; (c) the Minimum
    model at sizes 8-64 under the fitted GMT: the explorer's t_min and
    pick against ``sweep`` and the ``sweep_eval`` kernel, bit-equal to
    its plain version; (d) phase 9's measured drains re-priced under the
    fitted spec; (e) the trajectory on the reduction's and the bf16
    matmul's tunables at phase 4's shapes; (f) phase 7(b)'s full-width
    shared drain again, observed (trace, metrics, monitor) through a
    ``TracingScheduler``, its tokens equal to 7(b)'s, its document
    checked by the obs CLI; (g) the same drain profiled, with the drain
    unobserved before (f) and after (g) for their wall times; (h) the serving
    driver with ``--scheduler priority --trace --metrics --profile`` as a
    subprocess.  (c) and (e) are the path whose launches are returned.
    The active platform spec is set explicitly and restored at the end."""

    import os

    import torch
    from repro_torch.calibrate import (DEFAULT_SPEC, ensure_calibrated,
                                       run_calibration, run_trajectory,
                                       set_platform_spec)
    from repro_torch.core import PlatformSpec, WaveParams, model_time_torch
    from repro_torch.kernels.matmul_tuned.ops import MatmulTunable
    from repro_torch.kernels.sweep_eval.ops import sweep_eval, sweep_ref
    from repro_torch.kernels.tuned_reduction.ops import ReductionTunable
    from repro_torch.obs import Observability, validate_trace
    from repro_torch.runtime import Server, TracingScheduler, make_scheduler
    from repro_torch.tune import (PlatformTunable, TuningCache, TuningPlan,
                                  set_default_cache, tune)

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    prev_spec = set_platform_spec(DEFAULT_SPEC)
    prev_env = os.environ.get("REPRO_TORCH_PLATFORM_SPEC")
    prev_cache = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["REPRO_TORCH_PLATFORM_SPEC"] = str(
                Path(tmp) / "plan_spec.json")
            prev_cache = set_default_cache(TuningCache(Path(tmp) /
                                                       "cache.json"))

            # (a) the probes at the card's ladders
            t0 = time.perf_counter()
            fitted = run_calibration()
            cal_s = time.perf_counter() - t0
            pr = fitted.probes
            for sweep in ("matmul", "triad", "dispatch", "collective"):
                emit("calibrate", part=f"sweep_{sweep}", rows=pr[sweep])
            shares = {key: getattr(fitted, key) / getattr(DEFAULT_SPEC, key)
                      for key in ("peak_flops", "hbm_bw")}
            emit("calibrate", part="fit", card=smi, seconds=cal_s,
                 fitted=pr["fitted"], constants=fitted.constants(),
                 data_sheet=DEFAULT_SPEC.constants(),
                 share_of_data_sheet=shares, hash=fitted.calibration_hash())
            for key, share in shares.items():
                if not 0.5 <= share <= 1.05:
                    raise AssertionError(f"fitted {key} is {share:.1%} of the "
                                         f"data sheet (want 50-105 %)")
            if not 1.0 <= fitted.dispatch_us <= 1000.0:
                raise AssertionError(f"fitted dispatch {fitted.dispatch_us} "
                                     f"us (want 1-1,000)")
            path = Path(tmp) / "platform_spec.json"
            first, probed1 = ensure_calibrated(path, install=False,
                                               quick=True)
            again, probed2 = ensure_calibrated(path, install=False,
                                               quick=True)
            emit("calibrate", part="ensure_calibrated",
                 probed=[probed1, probed2], hash=again.calibration_hash(),
                 same=again == first)
            if not probed1 or probed2 or again != first or \
                    again.calibration_hash() == "default":
                raise AssertionError("ensure_calibrated: probe then load")
            torch.cuda.empty_cache()

            # (b) the plan's "calibrate" key: the uncalibrated plan under
            # the data-sheet spec, then the calibrated one
            job = {"tunable": "kernels.tuned_reduction",
                   "params": {"n": REDUCE_N}, "engine": "grid"}
            cache = TuningCache(Path(tmp) / "plan_cache.json")
            plain = TuningPlan.from_spec({"name": "plain", "jobs": [job]}
                                         ).run(cache=cache)
            lines: list[str] = []
            plan = TuningPlan.from_spec({"name": "calibrated",
                                         "calibrate": True, "jobs": [job]})
            report = plan.run(cache=cache, progress=lines.append)
            emit("calibrate", part="plan", lines=lines,
                 keys=[plain.results[0].key, report.results[0].key],
                 statuses=[plain.results[0].status,
                           report.results[0].status])
            if not lines[0].startswith("[calibrate] probed cuda/") or \
                    not report.ok or \
                    report.results[0].key == plain.results[0].key:
                raise AssertionError(f"calibrated plan: {lines}")
            set_platform_spec(fitted)

            # the path from here: (c) and (e)
            for c in counters:
                c.launches = 0

            # (c) the Minimum model under the card's GMT
            for size in MC_MINIMUM:
                wave = WaveParams.from_platform(size, spec=fitted, NP=4,
                                                kind="minimum")
                spec = PlatformSpec(size, NP=4, GMT=wave.GMT, kind="minimum")
                if PlatformTunable(spec).wave != wave:
                    raise AssertionError(f"size {size}: {wave} != "
                                         f"{PlatformTunable(spec).wave}")
                choices = spec.config_choices()
                wg = torch.tensor([w for w, _ in choices], dtype=torch.int32,
                                  device=dev)
                ts = torch.tensor([t for _, t in choices], dtype=torch.int32,
                                  device=dev)
                times = sweep_eval(wg, ts, wave, threads=64, ept=1)
                exact = model_time_torch(wave, wg.cpu(), ts.cpu())
                if not torch.equal(times.cpu(), sweep_ref(wave, wg.cpu(),
                                                          ts.cpu())) \
                        or int(exact.max()) >= 2**31 - 1 or \
                        not torch.equal(times.cpu().long(), exact):
                    raise AssertionError(f"minimum size {size} at GMT "
                                         f"{wave.GMT}: kernel, plain and "
                                         f"int64 model differ")
                on_card = dict(zip(choices, times.cpu().tolist()))
                sweep = tune(PlatformTunable(spec), engine="sweep",
                             cache=None)
                t0 = time.perf_counter()
                res = tune(PlatformTunable(spec), engine="explorer",
                           cache=None)
                wall = time.perf_counter() - t0
                pick = (res.best_config["WG"], res.best_config["TS"])
                t_min = min(on_card.values())
                base = WaveParams(size, NP=4, GMT=4, kind="minimum")
                base_t = model_time_torch(base, wg.cpu(), ts.cpu()).tolist()
                argmin = {c for c, t in on_card.items() if t == t_min}
                base_argmin = {c for c, t in zip(choices, base_t)
                               if t == min(base_t)}
                emit("calibrate", part="minimum", size=size, GMT=wave.GMT,
                     lattice_points=len(choices), t_min=res.t_min,
                     sweep_t_min=sweep.t_min, kernel_min=t_min,
                     kernel_at_pick=on_card[pick], pick=res.best_config,
                     sweep_pick=sweep.best_config,
                     argmin=sorted(argmin), argmin_at_gmt4=sorted(base_argmin),
                     pick_moved=argmin != base_argmin,
                     largest_time=int(exact.max()), states=res.stats.get(
                         "states"), wall_s=wall)
                if not res.t_min == sweep.t_min == t_min == on_card[pick] \
                        or on_card[(sweep.best_config["WG"],
                                    sweep.best_config["TS"])] != t_min:
                    raise AssertionError(
                        f"minimum size {size} at GMT {wave.GMT}: explorer "
                        f"{res.t_min}, sweep {sweep.t_min}, kernel {t_min}")

            # (d) phase 9's drains re-priced (host only)
            repriced(served["measured"], served["tunables"],
                     served["picks"], fitted)

            # (e) the modeled-vs-measured trajectory, phase 4's shapes
            traj_path = Path(tmp) / "trajectory.json"
            run = run_trajectory(
                [("tuned_reduction-2^28", ReductionTunable(REDUCE_N)),
                 ("matmul_tuned-bf16-8192", MatmulTunable(*MM_BF16))],
                path=traj_path)
            torch.cuda.synchronize()
            launches = [c.launches for c in counters]   # the path ends here
            emit("calibrate", part="trajectory",
                 calibration=run["calibration"], platform=run["platform"],
                 tunables=run["tunables"])
            if len(run["tunables"]) != 2 or \
                    run["calibration"] != fitted.calibration_hash():
                raise AssertionError(f"trajectory: {run}")
            torch.cuda.empty_cache()

            # (f) phase 7(b)'s drain, observed
            api, params = model["api"], model["params"]
            st7 = model["shared_trace"]

            def shared_drain(obs, scheduler):
                server = Server(api, params, **PAGED, share_prefix=True,
                                scheduler=scheduler, obs=obs)
                with torch.inference_mode():
                    run = two_waves(server, st7["prompts"], MAX_NEW)
                return server, run

            def unobserved():
                # the same drain with obs=None, beside (f) and (g) in this
                # phase: 7(b)'s wall time is from another point of the run
                server, run = shared_drain(None, "prefix")
                if [r.out for r in run["reqs"]] != st7["out"]:
                    raise AssertionError("the unobserved drain's tokens "
                                         "moved since phase 7(b)")
                del server
                return run["wall_s"]

            walls = [unobserved()]
            obs = Observability(trace=True, metrics=True, monitor=True)
            sched = TracingScheduler(make_scheduler("prefix"),
                                     recorder=obs.recorder)
            server, run_f = shared_drain(obs, sched)
            out_f = [r.out for r in run_f["reqs"]]
            doc_path = Path(tmp) / "observed.json"
            doc = obs.export(str(doc_path))
            problems = validate_trace(doc)
            cli = {}
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            for cmd in ("check", "summarize"):
                proc = subprocess.run(
                    [sys.executable, "-m", "repro_torch.obs", cmd,
                     str(doc_path)], capture_output=True, text=True, env=env,
                    timeout=300)
                cli[cmd] = {"rc": proc.returncode,
                            "out": proc.stdout.splitlines()[:24]}
            mon = doc["monitor"]
            decisions = sum(d is not None for _, d in sched.trace)
            emit("observe", part="observed_drain", **PAGED,
                 requests=PAGED_REQUESTS, ticks=server.ticks,
                 ticks_unobserved=st7["ticks"], wall_s=run_f["wall_s"],
                 wall_s_unobserved_before=walls[0],
                 wall_s_phase7b=st7["wall_s"],
                 tokens_equal=out_f == st7["out"],
                 events=len(doc["traceEvents"]), trace_problems=problems,
                 monitor={k: mon[k] for k in ("status", "ops_checked",
                                              "polls", "truncated")},
                 scheduler=sched.kind, decisions=len(sched.trace),
                 decisions_made=decisions, cli=cli)
            if out_f != st7["out"] or problems or \
                    mon["status"] != "accepted" or mon["ops_checked"] <= 0 \
                    or any(v["rc"] for v in cli.values()) or \
                    not sched.trace or decisions <= 0:
                raise AssertionError("the observed drain failed its checks")
            del server, obs, sched, doc
            torch.cuda.empty_cache()

            # (g) the same drain, profiled
            obs = Observability(trace=False, metrics=False, profile=True)
            server, run_g = shared_drain(obs, "prefix")
            report = obs.profiler.report()
            walls.append(unobserved())
            emit("observe", part="profiled_drain", ticks=server.ticks,
                 wall_s=run_g["wall_s"], wall_s_observed=run_f["wall_s"],
                 wall_s_unobserved=walls,
                 tokens_equal=[r.out for r in run_g["reqs"]] == st7["out"],
                 warmup_ticks=obs.profiler.warmup_ticks, phases=report,
                 card=smi)
            if not {"prefill", "decode", "host"} <= set(report) or \
                    [r.out for r in run_g["reqs"]] != st7["out"]:
                raise AssertionError(f"profiled drain: {sorted(report)}")
            del server, obs
            torch.cuda.empty_cache()

            # (h) the serving driver with the new flags, as a subprocess
            argv = OBSERVE_DRIVER + ["--trace",
                                     str(Path(tmp) / "driver_trace.json")]
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       REPRO_TORCH_TUNE_CACHE=str(Path(tmp) / "driver.json"))
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m",
                                   "repro_torch.launch.serve", *argv],
                                  capture_output=True, text=True, env=env,
                                  timeout=600)
            lines = proc.stdout.splitlines()
            want = ("scheduler: policy=priority", "trace: ",
                    "conformance monitor: accepted", "phase profile (",
                    "# TYPE serve_retired counter")
            found = {w: any(w in ln for ln in lines) for w in want}
            emit("observe", part="driver", argv=argv, rc=proc.returncode,
                 seconds=time.perf_counter() - t0,
                 output=[ln for ln in lines if not ln.startswith("#")
                         and not ln.startswith("serve_")][:40],
                 prometheus_lines=sum(ln.startswith("serve_")
                                      for ln in lines),
                 found=found, stderr=proc.stderr[-2000:])
            if proc.returncode != 0 or not all(found.values()):
                raise AssertionError(f"the serving driver: rc "
                                     f"{proc.returncode}, {found}")
    finally:
        set_platform_spec(prev_spec)
        set_default_cache(prev_cache)
        if prev_env is None:
            os.environ.pop("REPRO_TORCH_PLATFORM_SPEC", None)
        else:
            os.environ["REPRO_TORCH_PLATFORM_SPEC"] = prev_env
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    emit("calibrate", part="phase", seconds=phase_s)
    return {"launches": launches, "fitted": fitted}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.core import PlatformSpec, WaveParams, model_time, wg_ts_space
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import (BF16_FLOPS, F32_FLOPS,
                                            HBM_BYTES_PER_S, ISSUE_RATE)
    from repro_torch.kernels.flash_attention.kernel import flash_kernel
    from repro_torch.kernels.flash_attention.ops import (
        FlashAttentionTunable, attention_ref, flash_attention, visible_pairs)
    from repro_torch.kernels.matmul_tuned.kernel import matmul_kernel
    from repro_torch.kernels.matmul_tuned.ops import (MatmulTunable,
                                                      matmul_ref, matmul_tuned)
    from repro_torch.kernels.sweep_eval.kernel import (point_instructions,
                                                      sweep_kernel)
    from repro_torch.kernels.sweep_eval.ops import (SweepEvalTunable,
                                                    point_ops, sweep_eval,
                                                    sweep_ref)
    from repro_torch.kernels.tuned_reduction.kernel import reduce_kernel
    from repro_torch.kernels.tuned_reduction.ops import (ReductionTunable,
                                                         reduce_1d,
                                                         reduce_chunked)
    from repro_torch.tune import (PlatformTunable, TuningCache, TuningPlan,
                                  set_default_cache, tune)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    emit("build", built=info.built, nvcc_s=info.seconds,
         load_s=time.perf_counter() - t0, library=str(info.path),
         ptxas=info.ptxas)

    # 2. device --------------------------------------------------------------
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name,
         capability=".".join(map(str, torch.cuda.get_device_capability(0))),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    def modeled(tunable):
        return tune(tunable, engine="grid", cache=None).best_config

    summary: dict[str, dict] = {}

    # 3. kernels against their plain versions, at full size -----------------
    # 3a. reduction: int32, f32, bf16 x min, max, sum at n = 2^28, and a
    # bf16 sum over an unaligned view (x[3:]), element by element; the
    # library's sum keeps x's dtype (torch.sum widens int32 to int64)
    library = {"min": torch.amin, "max": torch.amax,
               "sum": lambda x: torch.sum(x, dtype=x.dtype)}

    def reduce_case(x, op, case):
        cfg = modeled(ReductionTunable(x.numel(), op=op,
                                       dtype_bytes=x.element_size()))
        got = reduce_1d(x, op=op, **cfg)
        want = reduce_chunked(x, op, cfg["WG"], cfg["TS"])
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"reduce {case}: kernel {got} != plain "
                                 f"{want}")
        if x.dtype == torch.int32 and op == "sum":
            wrapped = (int(x.long().sum()) + 2**31) % 2**32 - 2**31
            if int(got) != wrapped:
                raise AssertionError(f"int32 sum {got} != {wrapped} (mod 2^32)")
        elif op != "sum" and not torch.equal(got, library[op](x)):
            raise AssertionError(f"reduce {case}: {got} != {library[op](x)}")
        n = x.numel()
        b, by = bound_ms(n * x.element_size() + x.element_size(), n - 1,
                         F32_FLOPS)
        row = {"case": case, "n": n, "config": cfg,
               "max_abs_err": abs(float(got.double()) - float(want.double())),
               "tol": 0.0,
               "err_vs_f64": (abs(float(got.double()) - float(x.double().sum()))
                              if op == "sum" and x.dtype != torch.int32
                              else None),
               "ms": time_ms(lambda: reduce_1d(x, op=op, **cfg), 20),
               "plain_ms": time_ms(lambda: reduce_chunked(
                   x, op, cfg["WG"], cfg["TS"]), 2, warmup=1),
               "library_ms": time_ms(lambda: library[op](x), 20),
               "bound_ms": b, "bound_by": by}
        emit("kernel", name="tuned_reduction", **row)
        return row

    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        if dtype == torch.int32:
            x = torch.randint(-2**31, 2**31 - 1, (REDUCE_N,), generator=gen,
                              device=dev, dtype=torch.int32)
        else:
            x = (torch.randn(REDUCE_N, generator=gen, device=dev) * 100
                 ).to(dtype)
        for op in ("min", "max", "sum"):
            row = reduce_case(x, op, f"{str(dtype)[6:]}-{op}")
            if dtype == torch.int32 and op == "min":
                summary["tuned_reduction"] = row
        if dtype == torch.bfloat16:
            reduce_case(x[3:], "sum", "bfloat16-sum-unaligned-x[3:]")
        if dtype == torch.float32:             # NaN propagates
            x[REDUCE_N // 3] = float("nan")
            for op in ("min", "max"):
                cfg = modeled(ReductionTunable(REDUCE_N, op=op))
                if not bool(torch.isnan(reduce_1d(x, op=op, **cfg))):
                    raise AssertionError(f"reduce f32 {op}: NaN dropped")
        del x
    torch.cuda.empty_cache()

    # 3b. sweep-eval: exact over wg_ts_space(2^30) against the plain version
    # and model_time; timed on a dense 4096 x 4096 lattice
    for warp in (None, 32):
        p = WaveParams(size=SWEEP_CHECK_SIZE, NP=128, GMT=16, L=8,
                       kind="minimum", NU=132, warp=warp)
        arrs = wg_ts_space(p.size).to_arrays()
        wg = torch.as_tensor(arrs["WG"], dtype=torch.int32, device=dev)
        ts = torch.as_tensor(arrs["TS"], dtype=torch.int32, device=dev)
        got = sweep_eval(wg, ts, p, threads=256, ept=1)
        if not torch.equal(got, sweep_ref(p, wg, ts)):
            raise AssertionError(f"sweep kernel != plain version (warp={warp})")
        truth = [model_time(p, int(w), int(t)) for w, t in zip(arrs["WG"],
                                                               arrs["TS"])]
        fits = [i for i, t in enumerate(truth) if t < 2**31 - 1]
        got_l = got.cpu().tolist()
        bad = [i for i in fits if got_l[i] != truth[i]]
        if bad:
            raise AssertionError(f"sweep kernel != model_time at {len(bad)} "
                                 f"points (warp={warp})")
        emit("kernel", name="sweep_eval", case=f"check-2^30-warp={warp}",
             points=len(truth), equal_model_time=len(fits),
             beyond_int32=len(truth) - len(fits))
    # the mixed lattice: every pair of SWEEP_EDGES and random int32 pairs,
    # at size 2^30 and at size 0 (no work item anywhere)
    edges = torch.tensor(SWEEP_EDGES, dtype=torch.int32, device=dev)
    wg = torch.cat([edges.repeat_interleave(len(SWEEP_EDGES)),
                    torch.randint(-2**31, 2**31 - 1, (2**20,), generator=gen,
                                  device=dev, dtype=torch.int32)])
    ts = torch.cat([edges.repeat(len(SWEEP_EDGES)),
                    torch.randint(-2**31, 2**31 - 1, (2**20,), generator=gen,
                                  device=dev, dtype=torch.int32)])
    invalid = int(((wg <= 0) | (ts <= 0)).sum())
    for q in (p, WaveParams(size=0, NP=128, GMT=16, L=8, kind="minimum",
                            NU=132, warp=32)):
        got = sweep_eval(wg, ts, q, threads=256, ept=4)
        if not torch.equal(got, sweep_ref(q, wg, ts)):
            raise AssertionError(f"sweep kernel != plain version on the "
                                 f"mixed lattice (size={q.size})")
    emit("kernel", name="sweep_eval", case="mixed-invalid", points=wg.numel(),
         invalid_points=invalid, sizes=[p.size, 0], equal_plain=True)

    # the dense lattice, timed; its bound counts the model's operations a
    # point at the card's issue rate, and beside it the time the fast
    # path's SASS instructions a point take at that rate
    side = torch.arange(1, SWEEP_SIDE + 1, dtype=torch.int32, device=dev)
    wg = side.repeat_interleave(SWEEP_SIDE)
    ts = side.repeat(SWEEP_SIDE)
    n = wg.numel()
    cfg = modeled(SweepEvalTunable(n))
    got = sweep_eval(wg, ts, p, **cfg)
    want = sweep_ref(p, wg, ts)
    if not torch.equal(got, want):
        raise AssertionError("sweep kernel != plain version on the dense lattice")
    instr = point_instructions(table=p.warp is not None and p.NP <= 1024)
    b, by = bound_ms(3 * 4 * n, point_ops(p) * n, ISSUE_RATE)
    row = {"case": "dense-4096x4096", "n": n, "config": cfg,
           "max_abs_err": int((got.long() - want.long()).abs().max()),
           "ops_per_point": point_ops(p), "instr_per_point": instr,
           "bytes_ms": 3 * 4 * n / HBM_BYTES_PER_S * 1e3,
           "issue_ms": instr * n / ISSUE_RATE * 1e3,
           "ms": time_ms(lambda: sweep_eval(wg, ts, p, **cfg), 20),
           "plain_ms": time_ms(lambda: sweep_ref(p, wg, ts), 3, warmup=1),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    emit("kernel", name="sweep_eval", **row)
    summary["sweep_eval"] = row
    del wg, ts, got, want

    # 3c. matmul: bf16 at 8192^3, f32 at 4096^3 (library: torch.matmul,
    # TF32 off); with each kernel's registers and spills from ptxas
    mm_usage = _build.ptxas_usage(info.ptxas.get("matmul_tuned.cu", []))
    for dtype, (M, N, K) in ((torch.bfloat16, MM_BF16),
                             (torch.float32, MM_F32)):
        a = torch.randn(M, K, generator=gen, device=dev).to(dtype)
        b_ = torch.randn(K, N, generator=gen, device=dev).to(dtype)
        cfg = modeled(MatmulTunable(M, N, K, dtype_bytes=a.element_size()))
        got = matmul_tuned(a, b_, **cfg).float()
        want = matmul_ref(a, b_).float()
        tol = MM_TOL[str(dtype)[6:]]
        diff = (got - want).abs()
        rel_l2 = float(diff.norm() / want.norm())
        if not bool((diff <= tol * K ** 0.5 + tol * want.abs()).all()) \
                or not rel_l2 <= MM_REL_L2:
            raise AssertionError(f"matmul {dtype}: max err {diff.max()}, "
                                 f"rel L2 {rel_l2} (<= {MM_REL_L2})")
        if dtype == torch.bfloat16:
            entry = f"mm_bf16ILi{cfg['bn']}E"
        else:
            entry = f"mm_f32ILi{cfg['bm']}ELi{cfg['bn']}ELi{cfg['bk']}E"
        usage = next((u for name, u in mm_usage.items() if entry in name),
                     None)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bb, by = bound_ms((M * K + K * N + M * N) * a.element_size(),
                          2 * M * N * K, peak)
        run = lambda: matmul_tuned(a, b_, **cfg)
        if dtype == torch.float32:
            check_no_spills(entry, usage)
            ms, clocks = timed_f32(run, 10)
        else:
            ms, clocks = time_ms(run, 10), None
        row = {"case": f"{str(dtype)[6:]}-{M}x{N}x{K}", "config": cfg,
               "max_abs_err": float(diff.max()), "rel_l2": rel_l2,
               "tol": [tol, MM_REL_L2],
               "ptxas": usage, "sm_clock": clocks,
               "ms": ms,
               "plain_ms": time_ms(lambda: matmul_ref(a, b_), 5),
               "library_ms": time_ms(lambda: torch.matmul(a, b_), 10),
               "bound_ms": bb, "bound_by": by}
        row["tflops"] = 2 * M * N * K / row["ms"] / 1e9
        emit("kernel", name="matmul_tuned", **row)
        if dtype == torch.bfloat16:
            summary["matmul_tuned"] = row
        del a, b_, got, want, diff
    torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # 3d. flash attention at qwen1.5-4b's shape, windowed, non-causal and
    # f32 (library: scaled_dot_product_attention, timed only as a yardstick)
    fa_lines = info.ptxas.get("flash_attention.cu", [])
    fa_usage = _build.ptxas_usage(fa_lines)
    emit("kernel", name="flash_attention", case="ptxas-bf16",
         usage={k: u for k, u in fa_usage.items() if "fa_bf16" in k},
         warnings=[ln for ln in fa_lines
                   if "warning" in ln or "Performance" in ln])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dname, B, H, S, D, causal, window in FLASH_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev
                               ).to(dtype) for _ in range(3))
        cfg = modeled(FlashAttentionTunable(
            S=S, D=D, BH=B * H, causal=causal, window=window,
            dtype_bytes=q.element_size()))
        run = lambda: flash_attention(q, k, v, causal=causal, window=window,
                                      **cfg)
        got = run().float()
        plain = lambda: attention_ref(q, k, v, causal=causal, window=window)
        want = plain().float()
        atol, rtol = FLASH_TOL[dname]
        diff = (got - want).abs()
        rel_l2 = float(diff.norm() / want.norm())
        if not bool((diff <= atol + rtol * want.abs()).all()) \
                or not rel_l2 <= FLASH_REL_L2:
            raise AssertionError(f"flash {dname} S={S} causal={causal} "
                                 f"window={window}: max err {diff.max()}, "
                                 f"rel L2 {rel_l2} (<= {FLASH_REL_L2})")
        if window is None:
            library = lambda: sdpa(q, k, v, is_causal=causal)
        else:
            i = torch.arange(S, device=dev)
            keep = (i[None, :] <= i[:, None]) & \
                (i[None, :] >= i[:, None] - window + 1)
            library = lambda: sdpa(q, k, v, attn_mask=keep)
        pairs = visible_pairs(S, causal, window)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        bb, by = bound_ms(4 * B * H * S * D * q.element_size(),
                          4 * B * H * pairs * D, peak)
        entry = (f"fa_bf16ILi{cfg['block_k']}ELi{D}E" if dname == "bfloat16"
                 else f"fa_f32ILi{cfg['block_q']}ELi{cfg['block_k']}ELi{D}E")
        usage = next((u for n_, u in fa_usage.items() if entry in n_), None)
        if dname == "float32":
            check_no_spills(entry, usage)
            ms, clocks = timed_f32(run, 10)
        else:
            ms, clocks = time_ms(run, 10), None
        row = {"case": f"{dname}-S{S}-D{D}-causal={causal}-window={window}",
               "config": cfg, "max_abs_err": float(diff.max()),
               "ptxas": usage, "sm_clock": clocks,
               "rel_l2": rel_l2, "tol": [atol, rtol, FLASH_REL_L2],
               "ms": ms,
               "plain_ms": time_ms(plain, 3, warmup=1),
               "library_ms": time_ms(library, 10),
               "bound_ms": bb, "bound_by": by}
        row["tflops"] = 4 * B * H * pairs * D / row["ms"] / 1e9
        emit("kernel", name="flash_attention", **row)
        if "flash_attention" not in summary:
            summary["flash_attention"] = row
        del q, k, v, got, want, diff
    torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # 4. the main path: plan -> measure -> cache -> @autotune ----------------
    counters = (reduce_kernel, sweep_kernel, matmul_kernel, flash_kernel)
    for c in counters:
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        cache = TuningCache(Path(tmp) / "tune_cache.json")
        prev = set_default_cache(cache)
        try:
            plan = TuningPlan(name="chip-smoke")
            plan.add(PlatformTunable(PlatformSpec(**PAPER_SPEC)),
                     engine="sweep", label="abstract-platform")
            plan.add(ReductionTunable(REDUCE_N), engine="measure")
            plan.add(SweepEvalTunable(SWEEP_SIDE * SWEEP_SIDE),
                     engine="measure")
            plan.add(MatmulTunable(*MM_BF16), engine="measure")
            plan.add(FlashAttentionTunable(S=FWD_S, D=128, BH=20),
                     engine="measure")
            report = plan.run(cache=cache)
            if not report.ok:
                raise AssertionError(report.summary() + " " + json.dumps(
                    report.to_json()))
            plat = report.results[0]
            if plat.best_config != {"WG": 128, "TS": 8192} \
                    or plat.t_min != 131224:
                raise AssertionError(f"platform job: {plat}")
            emit("tune", job=plat.label, status=plat.status,
                 best_config=plat.best_config, t_min=plat.t_min)
            for jr in report.results[1:]:
                st = jr.result.stats
                emit("tune", job=jr.label, status=jr.status,
                     modeled_pick=st["modeled_pick"],
                     measured_pick=st["measured_pick"],
                     candidates=st["candidates"], elapsed_s=jr.elapsed_s)
            again = plan.run(cache=cache)
            statuses = [r.status for r in again.results]
            if statuses != ["hit"] * len(plan):
                raise AssertionError(f"second run: {statuses}")
            emit("tune", second_run=statuses)

            x = torch.randint(-2**31, 2**31 - 1, (REDUCE_N,), generator=gen,
                              device=dev, dtype=torch.int32)
            got = reduce_1d(x, op="min")              # (WG, TS) omitted
            decision = reduce_1d.tune(x, op="min")
            want = reduce_chunked(x, "min", **decision.best_config)
            if int(got) != int(want) or int(got) != int(x.min()):
                raise AssertionError(f"reduce_1d: {got} vs plain {want}")
            if decision.stats["cache"] != "hit":
                raise AssertionError(f"reduce_1d.tune: {decision.stats}")
            emit("tune", job="reduce_1d@autotune", result=int(got),
                 config=decision.best_config, cache=decision.stats["cache"])
        finally:
            set_default_cache(prev)
    torch.cuda.synchronize()

    # 5. launches of each kernel during the main path -----------------------
    launches = {"tuned_reduction": reduce_kernel.launches,
                "sweep_eval": sweep_kernel.launches,
                "matmul_tuned": matmul_kernel.launches,
                "flash_attention": flash_kernel.launches}
    emit("kernels", phase_of="tune", launches=launches)
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")

    # 6. the model path: qwen1.5-4b at full width ----------------------------
    names = list(launches)
    model = model_path(dev, gen, counters, summary["flash_attention"]["ms"])
    emit("kernels", phase_of="model", launches=dict(zip(names,
                                                        model["launches"])))
    if model["launches"][names.index("flash_attention")] <= 0:
        raise AssertionError("flash attention never launched on the model "
                             "path")
    emit("kernels", phase_of="paged", launches=dict(zip(
        names, model["paged_launches"])))
    # the paged path attends its pages with plain ops; the self-draft's
    # forwards go through the flash kernel
    if model["paged_launches"][names.index("flash_attention")] <= 0:
        raise AssertionError("flash attention never launched on the paged "
                             "path")
    # 8. the model checker, held to the sweep_eval kernel on the card ------
    checked = model_check(dev, counters, model["shared_trace"])
    emit("kernels", phase_of="model_check", launches=dict(zip(
        names, checked["launches"])))
    if checked["launches"][names.index("sweep_eval")] <= 0:
        raise AssertionError("sweep_eval never launched on the model "
                             "checker's path")
    # 9. the serving tunables at full width ---------------------------------
    served = serve_tune(dev, counters, model)
    emit("kernels", phase_of="serve_tune", launches=dict(zip(
        names, served["launches"])))
    # 10. the card calibrated, the Server observed ------------------------
    observed = calibrate_and_observe(dev, counters, model, served)
    emit("kernels", phase_of="calibrate", launches=dict(zip(
        names, observed["launches"])))
    idle = [k for k in ("sweep_eval", "tuned_reduction", "matmul_tuned")
            if observed["launches"][names.index(k)] <= 0]
    if idle:
        raise AssertionError(f"never launched in phase 10: {idle}")
    for kernel, *counts in zip(names, model["launches"],
                               model["paged_launches"], checked["launches"],
                               served["launches"], observed["launches"]):
        launches[kernel] += sum(counts)

    sources = {"tuned_reduction": ("src/repro_torch/csrc/tuned_reduction.cu",
                                   "src/repro/kernels/tuned_reduction/kernel.py:76"),
               "sweep_eval": ("src/repro_torch/csrc/sweep_eval.cu",
                              "src/repro/kernels/sweep_eval/kernel.py:82"),
               "matmul_tuned": ("src/repro_torch/csrc/matmul_tuned.cu",
                                "src/repro/kernels/matmul_tuned/kernel.py:46"),
               "flash_attention": (
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:107")}
    kernels = []
    for k, (src, replaces) in sources.items():
        row = summary[k]
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if row[key] is None or not math.isfinite(row[key]):
                raise AssertionError(f"{k}: {key}={row[key]}")
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
