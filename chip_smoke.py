#!/usr/bin/env python3
"""Drive the port's two main paths on one CUDA card, end to end: the
tuning loop and the dense model path (qwen1.5-4b at full width).

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
   an offline greedy loop through its flash ``forward``.

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
               ("float32", 1, 20, 4096, 128, True, None))
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
    kernel's share of a forward.  Returns the launches of each kernel
    during the main path, (a'') and (b); the comparisons' launches,
    before and after it, are not counted."""

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

    def top2(logits):
        top = torch.topk(logits.float(), 2, dim=-1)
        return top.indices[..., 0], top.values[..., 0] - top.values[..., 1]

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
                L = PROMPT_LEN + step
                batch = torch.zeros((REQUESTS, -(-L // 128) * 128),
                                    dtype=torch.int32, device=dev)
                batch[:, :L] = torch.tensor(seqs, dtype=torch.int32,
                                            device=dev)
                logits = api_cut.forward(p_cut, {"tokens": batch})[:, L - 1]
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
        finally:
            set_default_cache(prev)
    torch.cuda.synchronize()
    return {"launches": launches}


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
    for kernel, n in zip(names, model["launches"]):
        launches[kernel] += n

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
