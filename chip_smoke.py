#!/usr/bin/env python3
"""Drive the port's main paths on one CUDA card, end to end: the tuning
loop, the dense model path, the paged serving path (qwen1.5-4b at full
width), the model checker, the serving tunables, the card's calibration
with the Server observed on it, the fleet rollout and verification
CLIs, the other model families (hymba, mamba2, whisper, mixtral and
llama-3.2-vision at full width, the last two cut in depth), training
(smollm-135m at full width), the sharded paths of every family on a
1x1 mesh (llama4-maverick at one block) with the dry run of the
production meshes on the card's host, and the examples' torch twins
(qwen3-32b served whole).

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
   before and after its timing; 3e is the paged decode kernel at
   chat-c64's decode step and at every shape the other phases serve
   paged (qwen3-32b whole at one slot, phase 7's four slots, hymba's and
   mixtral's windows, smollm's 9 / 3 heads), each held to its plain
   version and timed beside its byte bound over the live keys, its plain
   version and SDPA over the already-gathered K/V, with its
   instantiations' registers and spills (a spill fails the run);
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
   during (c) and (e);
11. ``fleet`` / ``verify_cli`` — the fleet rollout and the verification
   gate, each CLI a subprocess (``python -m repro_torch.tune``,
   ``python -m repro_torch.verify``) on a temporary cache and platform
   spec: (a) ``examples/plans/fleet_warmup.json`` warmed whole with
   ``--workers 4``, its ``[calibrate]`` line first, the platform job
   against the explorer, the meta job's lattice searched for real; (b) a
   plan at the main path's shapes (the four kernel tunables under
   ``measure`` and ``grid``, the five serving tunables as phase 9 prices
   them, a meta job over the 2^28 reduction); (c) ``export --platform
   cuda``, ``merge`` into a fresh node cache, ``ls``, ``prune``, a CPU
   bundle merged and pruned; (d) the node resolving the four kernels
   from its cache at (b)'s shapes (no miss), each held to its plain
   version, and both plans again as pure hits; (e) ``verify lint``,
   ``check``, ``mutants``, a mutant's trail and phase 10(f)'s monitor
   trail replayed; then each kernel's launches during the warm-ups and
   (d);
12. ``families`` — the earlier phases' weights released, the flash
   kernel at each family's attention shape against its plain version
   (``kernel`` lines: time, plain, SDPA with the window mask, the bound
   over the pairs inside the mask), then each family on its own path, a
   line each with its config, depth cuts, the bf16 forward's ms, flash's
   share and launches, and its drains' ticks, wall and tokens per second:
   (a) hymba-1.5b whole (forward at S = 4096, every layer's attention
   flash against plain, a Server of 4 slots at 2,048 draining 4 x
   (1,536 + 16) contiguous and paged, n-gram speculation, a profiled
   decode tick; on an f32 cut of 4 layers the Server against the offline
   flash forward, n-gram and self-draft drains against the plain drain);
   (b) mamba2-2.7b whole (forward, a drain; on the f32 cut the
   recurrence against the chunked scan); (c) whisper-medium whole
   (encoder over 1,500 frames, decoder at S = 512 through flash, a Server
   with frames; the f32 cut against the offline enc-dec greedy); (d)
   mixtral-8x22b at 2 of 56 layers (the f32 cut with no drops: prefill
   and decode logits against the forward's); (e) llama-3.2-vision-90b at
   one block of 5 of 100 layers, with 1,024 image embeddings; then each
   kernel's launches over the five paths;
13. ``train`` — smollm-135m trained at full width (30 layers, d 576,
   134.5 M params) in bf16 at B = 8, S = 2048, after phase 12 released
   its weights: (a) one ``build_train_step`` step of an f32 cut of 2
   layers on the card against the plain CPU step from the same state,
   and at full width ``microbatches=4`` against ``microbatches=1``; (b)
   the machine model's one-card lattice at microbatches 1, 2 and 4 (8
   cut since phase 14 came, for time) × every remat, 1 warm and 3
   timed steps, measured beside ``step_time``'s
   modeled ms with peak memory (``oom`` recorded), the modeled pick, the
   measured best and the pick's rank; (c) ``python -m
   repro_torch.launch.train`` for 60 steps with checkpoints every 20
   and a failure injected at 30 (one restart, the loss falls, the last
   checkpoint read back; tokens/s and 6·N·tokens over time over phase
   10's fitted peak); (d) the same with ``--tune``, whose pick must be
   (b)'s modeled pick and must have run; (e) flash attention under a
   gradient: one launch, then ``backward`` raises; then each kernel's
   launches over (b)-(e);
14. ``distributed`` — the sharded paths on a 1x1 NCCL mesh (world size
   1) and the dry run on the card's host: (a) qwen1.5-4b at full width
   and depth in bf16, its params placed by ``shard_like``: a forward at
   S = 4096 with the flash kernel under ``local_map`` (40 launches)
   against the unsharded forward's last-token logits (rel L2 1e-2, and
   whether bit-equal), a ``decode_step`` at B = 4 over a 1,024 context
   against the unsharded one, each timed beside the unsharded; (b)
   smollm-135m at B = 8, S = 2048, remat full, state and batch as
   DTensors: 3 steps against 3 unsharded steps (loss rel 1e-3), step
   ms and peak memory beside phase 13's lattice point, a checkpoint
   saved from the mesh and loaded onto it bit-equal; (c) ``python -m
   repro_torch.launch.dryrun`` in the background from the phase's
   start, one subprocess a cell on all but one of the host's cores, train
   cells at one microbatch: all ten archs × the four shapes on 16 × 16,
   qwen3-32b's train_4k on 2 × 16 × 16 (status and reason; the whole
   matrix is ``tools/dryrun_matrix.py``'s), each priced by ``analyze``
   on the H100 data sheet with its wall seconds (a cell that fails, or
   is skipped where ``supports`` does not say so, fails the phase); (d)
   ``lower_cell`` on a fake 1 × 1 group at (b)'s shape, its peak within
   25 % of (b)'s measured peak; (e) hymba-1.5b, mamba2-2.7b and whisper-medium whole,
   mixtral-8x22b at 2 layers, llama-3.2-vision-90b at one block, each
   placed on the mesh: the forward at phase 12's S (flash under
   ``local_map``) and a decode step at phase 12's batch over a 1,024
   context against the unsharded ones, logits rel L2 1e-2, the written
   state equal, each timed; (f) llama4-maverick at one block (a dense and
   a 128-expert MoE layer, ~37 GB of bf16 weights): flash at (1, 40,
   4096, 128) causal against the plain math layer by layer, then (e)'s
   checks at S = 4096 and B = 2, with its peak memory; then each
   kernel's launches over (a), (b), (e) and (f), and the phase's
   seconds;
15. ``examples`` — the six torch twins of ``examples/*.py``
   (``examples/torch_*.py``) after phase 14 released its weights, each
   on a temporary tuning cache and platform spec (the fleet's is phase
   10's fitted artifact, so its ``[calibrate]`` loads): (a) each twin's
   ``main`` in-process at the reference example's arguments, checked as
   the CPU tests check it (t_min 24 and 131,224 and the picks, the
   reduction's pick the cost model's argmin and its result its plain
   version's, the fleet's 12 jobs, 12 shipped, the node's matmul with
   no miss and 12 hits, 10 requests / 60 tokens in 18 ticks contiguous
   and paged, 220 steps with one restart, the distributed picks
   ``tune_distributed``'s); (b) ``python
   examples/torch_autotune_minimum.py`` as a subprocess, loading no
   ``jax`` or ``repro`` module; (c) the serving twin with ``--preset
   full``, qwen3-32b whole contiguous then paged (the memory allocated
   before each driver run, its peak, ticks and tokens/s), and the
   training twin with ``--preset full`` (smollm-135m at full width, 220
   steps, the loss's first and last); then the reduction's and the
   matmul's launches over (a) and (c).

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
# phase 3e, paged decode at the shapes the port serves paged, pages of 16,
# bf16: (case, B, H, Hkv, hd, pages in the pool, page-table width M,
# window, positions).  chat-c64's decode step: 64 slots of 64 pages in a
# 2,304-page pool, qwen1.5-4b's 20 heads of 128, each slot at a position
# drawn as the cell draws its requests ("chat": a prompt, lognormal median
# 256, sigma 0.9, in [32, 768], plus a share of an output, lognormal median
# 96, sigma 0.8, in [16, 256]); qwen3-32b served whole, one slot of 8 kv
# heads of 8 query heads at 4,096 keys; phase 7's 4 slots of qwen1.5-4b (4
# splits); hymba-1.5b's 25 / 5 heads of 64 with its 1,024-token window at
# 2,048 (phase 12), past the window; smollm-135m's 9 / 3 heads of 64 at
# 8 slots of 2,048; mixtral-8x22b's 48 / 8 heads of 128 with its 4,096-token
# window at 8,192, past the window.  Positions (lo, hi) are drawn uniform
# in [lo, hi]; with a window, the pages wholly before it are -1, as the
# Server gives them back.  The kernel is held to its plain version at
# 1e-2 + 1e-2 |want| (the output rounded once to bf16 after f32 sums in
# another order) and rel L2 <= 1e-2
PAGED_CASES = (("chat-c64", 64, 20, 20, 128, 2304, 64, None, "chat"),
               ("qwen3-32b-b1", 1, 64, 8, 128, 320, 256, None,
                (4095, 4095)),
               ("qwen1.5-4b-b4", 4, 20, 20, 128, 256, 64, None,
                (256, 527)),
               ("hymba-1.5b", 4, 25, 5, 64, 512, 128, 1024, (1024, 2047)),
               ("smollm-135m", 8, 9, 3, 64, 1024, 128, None, (0, 2047)),
               ("mixtral-8x22b", 2, 48, 8, 128, 1024, 512, 4096,
                (4096, 8191)))
PAGED_TOL = 1e-2
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


# phase 11, the fleet rollout: the reference's plan file as it is, then a
# plan at the main path's shapes (phase 4's parameter names) warmed under
# both engines, and a meta job over the 2^28 reduction
FLEET_PLAN = ROOT / "examples" / "plans" / "fleet_warmup.json"
FLEET_KERNELS = (("kernels.tuned_reduction", {"n": REDUCE_N}),
                 ("kernels.sweep_eval", {"n": SWEEP_SIDE * SWEEP_SIDE}),
                 ("kernels.matmul_tuned", dict(zip("MNK", MM_BF16))),
                 ("kernels.flash_attention", {"S": FWD_S, "D": 128, "BH": 20}))
FLEET_META_SPACE = {"top_k": [1, 2], "repeats": [1, 3]}
# phase 12, the other model families at full width, random bf16 weights
# from a seed: each forward through the flash kernel (S = 4096; whisper's
# decoder at 512 over 1,500 frames), a Server drain, and, on an f32 cut of
# the same weights to FAMILY_CUT layers, the kernel against the plain math
# and the Server against the offline forward.  mixtral-8x22b is cut to 2
# of its 56 layers and llama-3.2-vision-90b to one block (4 dense + 1
# cross of 100 layers): one card holds neither whole.  llama4-maverick
# (one block is ~37 GB of bf16 weights) runs in phase 14(f).
FAMILY_CUT = 4
FAMILIES = {
    "hymba-1.5b": dict(serve=dict(batch=4, context=2048, prefill_chunk=256),
                       requests=4, prompt_len=1536, fwd_s=FWD_S,
                       spec_prompt_len=256),
    "mamba2-2.7b": dict(serve=dict(batch=4, context=1024,
                                   prefill_chunk=256),
                        requests=4, prompt_len=512, fwd_s=FWD_S),
    "whisper-medium": dict(serve=dict(batch=4, context=1024,
                                      prefill_chunk=256),
                           requests=4, prompt_len=256, fwd_s=512),
    "mixtral-8x22b": dict(serve=dict(batch=2, context=1024,
                                     prefill_chunk=256),
                          requests=2, prompt_len=512, fwd_s=FWD_S,
                          n_layers=2),
    "llama-3.2-vision-90b": dict(serve=dict(batch=2, context=1024,
                                            prefill_chunk=256),
                                 requests=2, prompt_len=512, fwd_s=FWD_S,
                                 n_layers=5),
}
# flash at each family's attention shape, (B, H, S, D, causal, window);
# llama4-maverick's block runs in phase 14(f)
FAMILY_FLASH = {"hymba-1.5b": (1, 25, FWD_S, 64, True, 1024),
                "whisper-medium": (1, 16, 512, 64, True, None),
                "mixtral-8x22b": (1, 48, FWD_S, 128, True, 4096),
                "llama-3.2-vision-90b": (1, 64, FWD_S, 128, True, None),
                "llama4-maverick-400b-a17b": (1, 40, FWD_S, 128, True,
                                              None)}
# (f) the serving driver on hymba at full width, as a user runs it
FAMILY_DRIVER = ["--arch", "hymba-1.5b", "--preset", "full", "--requests",
                 "4", "--batch", "4", "--context", "2048", "--prompt-len",
                 "1536", "--max-new", "16", "--prefill-chunk", "256"]
# the recurrence (serving) against the chunked scan (forward) on mamba2's
# f32 cut: rel L2 of the logits at every teacher-forced position
SCAN_REL_TOL = 1e-3
# mixtral's f32 cut with no drops: prefill and decode logits against the
# forward's, rel L2 each
MOE_CAPACITY = 16.0
MOE_REL_TOL = 1e-3
# phase 13: smollm-135m trained at full width in bf16, B = 8, S = 2048
# (the model of the reference's examples/train_smollm.py)
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_LR = 3e-3
# (a) the card's step against the plain CPU step on an f32 cut of 2
# layers at B = 1, S = 512 (the CPU step at full size takes minutes):
# loss rel 1e-4; params within 1e-5 + 1e-4 relative but at most 0.1 % of
# the elements, each within 4 lr (an Adam step of a gradient within a few
# eps of 0 moves by ~lr whatever that gradient's rounding)
TRAIN_CUT = 2
TRAIN_CUT_SHAPE = (1, 512)
TRAIN_CUT_TOL = {"loss_rel": 1e-4, "atol": 1e-5, "rtol": 1e-4,
                 "outlier_share": 1e-3}
# microbatches 4 against 1 at full width: the reference's own tolerance
# (tests/test_system.py): loss rel 2e-2, params max abs 5e-2
TRAIN_MB_TOL = {"loss_rel": 2e-2, "params_abs": 5e-2}
# (b) the lattice: microbatches 1-4 x every remat, 1 warm and 3 timed
# steps (8 microbatches, 29-58 s of steps over the three remats on an
# H100, cut to keep the script within its time with phase 14)
TRAIN_MB = (1, 2, 4)
TRAIN_REMAT = ("none", "dots", "full")
TRAIN_TIMED = 3
# (c)/(d) the training driver as a user runs it
TRAIN_DRIVER = ["--arch", TRAIN_ARCH, "--preset", "full", "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
# (e) flash under a gradient at smollm's attention shape, one layer
FLASH_GRAD_SHAPE = (1, 9, TRAIN_SEQ, 64)


# phase 14: the sharded paths on a 1x1 NCCL mesh, the dry run on the host
# qwen1.5-4b's last-token logits on the mesh against the unsharded
# forward (phase 6(a)'s bound), smollm-135m's losses against the
# unsharded steps, the dry run's peak against the measured one
DIST_LOGITS_REL = 1e-2
DIST_LOSS_REL = 1e-3
DIST_PEAK_REL = 0.25
DIST_STEPS = 3
DIST_DENSE = ("smollm-135m", "qwen1.5-4b", "minitron-8b", "qwen3-32b")
DIST_OTHERS = ("mamba2-2.7b", "mixtral-8x22b", "llama4-maverick-400b-a17b",
               "llama-3.2-vision-90b", "hymba-1.5b", "whisper-medium")
DIST_MULTI = ("qwen3-32b", "train_4k")
# (e) the other families on the mesh at phase 12's widths and depths:
# flash launches a forward (self-attention layers; whisper's encoder at
# 1,500 frames does not tile by 128 and takes the plain math)
DIST_FAMILY_FLASH = {"hymba-1.5b": 32, "mamba2-2.7b": 0,
                     "whisper-medium": 24, "mixtral-8x22b": 2,
                     "llama-3.2-vision-90b": 4}
# (f) llama4-maverick at one block (a dense and a 128-expert MoE layer):
# the forward at S = 4096, the decode at B = 2 over a 1,024 context
MAVERICK = "llama4-maverick-400b-a17b"
MAVERICK_BLOCK = dict(n_layers=2, fwd_s=FWD_S, batch=2, context=1024)
# (c)'s train cells at one microbatch: the auto factor (4-16 at these
# archs) repeats the same layers' work, and the fake run pays host
# dispatch for every op (qwen3-32b's auto 16 took 593 s on a CPU)
DIST_MICROBATCHES = 1
# phase 15: the examples' torch twins, at the reference examples'
# arguments, then the two driver twins with ``--preset full``
EXAMPLES = ROOT / "examples"
EXAMPLE_TWINS = ("quickstart", "autotune_minimum", "fleet_rollout",
                 "serve_batch", "train_smollm", "tune_distributed")
FULL = ["--preset", "full"]


# runs ``python -m <argv[1]> <argv[2:]>`` and, at exit, writes the
# kernels' launch counts of that process to $CHIP_SMOKE_LAUNCHES
CLI_PRELUDE = """
import atexit, json, os, runpy, sys
from repro_torch.kernels.flash_attention.kernel import flash_kernel
from repro_torch.kernels.matmul_tuned.kernel import matmul_kernel
from repro_torch.kernels.sweep_eval.kernel import sweep_kernel
from repro_torch.kernels.tuned_reduction.kernel import reduce_kernel

def _dump():
    with open(os.environ["CHIP_SMOKE_LAUNCHES"], "w") as f:
        json.dump({"tuned_reduction": reduce_kernel.launches,
                   "sweep_eval": sweep_kernel.launches,
                   "matmul_tuned": matmul_kernel.launches,
                   "flash_attention": flash_kernel.launches}, f)

atexit.register(_dump)
runpy.run_module(sys.argv.pop(1), run_name="__main__", alter_sys=True)
"""


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


def chat_positions(rng, B: int, limit: int):
    """Each of ``B`` decoding slots' position as chat-c64 draws its
    requests: a prompt plus a uniform share of an output (PAGED_CASES)."""

    import numpy as np
    prompt = np.clip(np.round(rng.lognormal(np.log(256), 0.9, B)), 32, 768)
    out = np.clip(np.round(rng.lognormal(np.log(96), 0.8, B)), 16, 256)
    pos = prompt + np.floor(rng.uniform(0, 1, B) * out)
    return np.minimum(pos, limit).astype(np.int64)


def paged_decode_cases(dev, gen, info) -> dict:
    """Phase 3e: the paged decode kernel at PAGED_CASES against its plain
    version, timed beside its bound (the live keys' K and V, the query,
    the output and the live page-table entries, each read or written
    once, at 3.35 TB/s; its 4 flops a head, key and dim at the f32 FMA
    rate), the plain version and SDPA over the already-gathered
    contiguous K/V (a yardstick the port never calls).  Returns the
    chat-c64 row."""

    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import F32_FLOPS
    from repro_torch.kernels.paged_decode import (num_splits, paged_decode,
                                                  paged_decode_ref)
    from repro_torch.models.attn_core import gather_pool, pool_validity

    lines = info.ptxas.get("paged_decode.cu", [])
    usage = _build.ptxas_usage(lines)
    emit("kernel", name="paged_decode", case="ptxas", usage=usage,
         warnings=[ln for ln in lines
                   if "warning" in ln or "Performance" in ln])
    for entry, u in usage.items():
        check_no_spills(entry, u)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(0)
    rows = []
    for case, B, H, Hkv, hd, P, M, window, drawn in PAGED_CASES:
        ps = 16
        cur = (chat_positions(rng, B, M * ps - 1) if drawn == "chat"
               else rng.integers(drawn[0], drawn[1] + 1, B))
        first = (np.zeros(B, np.int64) if window is None
                 else np.maximum(cur - window + 1, 0))
        pages = cur // ps + 1
        perm = rng.permutation(P)
        table = np.full((B, M), -1, np.int32)
        starts = np.concatenate([[0], np.cumsum(pages)])
        if starts[-1] > P:
            raise AssertionError(f"{case}: {starts[-1]} pages of {P}")
        for b in range(B):
            table[b, :pages[b]] = perm[starts[b]:starts[b + 1]]
            table[b, :first[b] // ps] = -1
        k, v = (torch.randn(P, Hkv, ps, hd, generator=gen, device=dev
                            ).to(torch.bfloat16) for _ in range(2))
        q = torch.randn(B, H, 1, hd, generator=gen, device=dev
                        ).to(torch.bfloat16)
        table_t = torch.from_numpy(table).to(dev)
        cur_t = torch.from_numpy(cur).to(dev)
        run = lambda: paged_decode(q, k, v, table_t, cur_t, window=window)
        plain = lambda: paged_decode_ref(q, k, v, table_t, cur_t,
                                         window=window, scale=hd ** -0.5)
        got, want = run().float(), plain().float()
        diff = (got - want).abs()
        rel_l2 = float(diff.norm() / want.norm())
        if not bool((diff <= PAGED_TOL + PAGED_TOL * want.abs()).all()) \
                or not rel_l2 <= 1e-2:
            raise AssertionError(f"paged decode {case}: max err "
                                 f"{diff.max()}, rel L2 {rel_l2}")
        keys = int((cur + 1 - first).sum())
        read_pages = int((cur // ps - first // ps + 1).sum())
        nbytes = (keys * Hkv * hd * 2 * 2 + 2 * q.numel() * 2
                  + read_pages * 4 + B * 8)
        flops = 4 * H * hd * keys
        bb, by = bound_ms(nbytes, flops, F32_FLOPS)
        kc, vc = gather_pool(k, table_t), gather_pool(v, table_t)
        kp = torch.arange(M * ps, device=dev)[None, :]
        keep = ((kp <= cur_t[:, None]) & (kp >= torch.from_numpy(first).to(
            dev)[:, None]) & pool_validity(table_t, ps))[:, None, None, :]
        library = lambda: sdpa(q, kc, vc, attn_mask=keep,
                               enable_gqa=H != Hkv)
        ms = time_ms(run, 50)
        row = {"case": case, "B": B, "H": H, "Hkv": Hkv, "hd": hd, "M": M,
               "window": window, "pool_pages": P, "keys": keys,
               "splits": num_splits(B, Hkv, M),
               "max_abs_err": float(diff.max()), "rel_l2": rel_l2,
               "tol": [PAGED_TOL, PAGED_TOL, 1e-2], "ms": ms,
               "plain_ms": time_ms(plain, 5, warmup=1),
               "library_ms": time_ms(library, 20),
               "bound_ms": bb, "bound_by": by, "bytes": nbytes,
               "share_of_bound": bb / ms}
        emit("kernel", name="paged_decode", **row)
        rows.append(row)
        del k, v, q, kc, vc, keep, got, want, diff
    torch.cuda.empty_cache()
    return rows[0]


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
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import _embed
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
            local = flash_layers(cfg, params, _embed(params, toks), pos)
            emit("model", part="layers", S=FWD_S, attn_rel_l2=local,
                 max_attn_rel_l2=max(local))
            if not max(local) <= LAYER_ATTN_TOL:
                raise AssertionError(f"flash attention in the model: layer "
                                     f"rel error {max(local)} > "
                                     f"{LAYER_ATTN_TOL}")
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
            outs = [r.out for r in reqs]
            greedy = greedy_against_offline(api_cut, p_cut, prompts, outs,
                                            d, dev)
            emit("model", part="greedy_f32_cut", n_layers=DEPTH_CUT,
                 f32_flash_launches=flash.launches - before,
                 ticks=server.ticks, steps=MAX_NEW, server_out=outs,
                 **greedy)
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


def padded_logits(api, params, seqs, dev, extra=None):
    """Each sequence's next-token logits (one row a sequence, f32) from
    one forward over the batch padded right to a multiple of 128, so it
    takes the flash gate (causal masking keeps the padding inert).
    ``extra`` adds batch entries, one row a sequence (an enc-dec model's
    ``frames``)."""

    import torch
    L = max(len(q) for q in seqs)
    batch = torch.zeros((len(seqs), -(-L // 128) * 128), dtype=torch.int32,
                        device=dev)
    for i, q in enumerate(seqs):
        batch[i, :len(q)] = torch.tensor(q, dtype=torch.int32, device=dev)
    last = torch.tensor([len(q) - 1 for q in seqs], device=dev)
    logits = api.forward(params, {"tokens": batch, **(extra or {})})
    return logits[torch.arange(len(seqs), device=dev), last].float()


def greedy_against_offline(api, params, prompts, outs, d, dev,
                           extra=None) -> dict:
    """Phase 6(c)'s rule for a drain's tokens ``outs``: an offline loop
    through ``api.forward`` (padded right to a multiple of 128, the flash
    gate) fed the drain's own tokens, so a near tie never ends the
    comparison.  At a decisive step (offline top-2 gap >= 10 d) the
    drain's token must BE the offline argmax; at a near tie its logit
    must lie within 10 d of the offline maximum."""

    import torch
    n = len(prompts)
    seqs = [list(p) for p in prompts]
    decisive, equal, worst, min_gap = [0] * n, [0] * n, 0.0, math.inf
    for step in range(len(outs[0])):
        logits = padded_logits(api, params, seqs, dev, extra)
        nxt, gap = (t.tolist() for t in top2(logits))
        min_gap = min(min_gap, *gap)
        served = torch.tensor([o[step] for o in outs], device=dev)
        deficit = (logits.amax(dim=-1) - logits.gather(
            1, served[:, None])[:, 0]).tolist()
        del logits
        for r in range(n):
            tok = outs[r][step]
            if gap[r] >= GAP_MULT * d:
                decisive[r] += 1
                if nxt[r] != tok:
                    raise AssertionError(
                        f"request {r} step {step}: offline {nxt[r]} != "
                        f"served {tok} at top-2 gap {gap[r]} >= "
                        f"{GAP_MULT} d = {GAP_MULT * d}")
            elif deficit[r] > GAP_MULT * d:
                raise AssertionError(
                    f"request {r} step {step}: served token {tok} is "
                    f"{deficit[r]} below the offline max")
            equal[r] += nxt[r] == tok
            worst = max(worst, deficit[r])
            seqs[r].append(tok)
    if min(decisive) < 1:
        raise AssertionError(f"a request had no decisive step: {decisive}")
    return {"decisive_compared": decisive, "equal_to_offline_argmax": equal,
            "gap_threshold": GAP_MULT * d, "max_deficit": worst,
            "min_top2_gap": min_gap}


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
    """One engine tick under ``torch.profiler``, reduced by the
    benchmark's ``bench.trace.reduce``: host time around it (the tick
    ends in a sync), the device's busy time (the union of its kernel and
    copy intervals) and idle share over the tick, the kernel launches,
    and the three device ops that took the most time.  Device fields are
    None when the trace holds no device event."""

    import torch

    from bench.trace import Profiler

    prof = Profiler(torch.device("cuda"))
    prof.start()
    server.tick()
    prof.stop()
    sl = prof.reduce()
    host_ms = sl.window_s * 1e3
    device = sl.busy_s is not None
    busy_ms = sl.busy_s * 1e3 if device else None
    return {"profiled_host_ms": host_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / host_ms) if device else None,
            "kernels": sl.kernels if device else None,
            "copies": sl.copies if device else None,
            "top_device_ops": [[n[:100], t * 1e3] for n, t in sl.top_ops[:3]]}


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
            # kept for phase 11(e): the CLI replays it on the allocator
            monitor_trail = obs.monitor.trail()
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
                    or not monitor_trail["replayable"] \
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
    return {"launches": launches, "fitted": fitted,
            "monitor_trail": monitor_trail}


def run_cli(module: str, args: list, env: dict, launches_path: Path,
            timeout: int = 600) -> dict:
    """``python -m <module> <args>`` as a subprocess, through
    :data:`CLI_PRELUDE`, which writes the kernels' launch counts at exit
    to ``launches_path``.  Returns its exit code, output, seconds and
    launches."""

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_PRELUDE, module, *map(str, args)],
        capture_output=True, text=True, cwd=ROOT, timeout=timeout,
        env=dict(env, CHIP_SMOKE_LAUNCHES=str(launches_path)))
    seconds = time.perf_counter() - t0
    try:
        launches = json.loads(launches_path.read_text())
    except (OSError, ValueError):
        launches = None
    return {"rc": proc.returncode, "out": proc.stdout, "err": proc.stderr,
            "seconds": seconds, "launches": launches}


def fleet_and_verify(dev, gen, counters, model, observed) -> dict:
    """Phase 11: the fleet rollout and the verification gate, every CLI a
    subprocess (``python -m repro_torch.tune`` / ``repro_torch.verify``)
    with the tuning cache and the platform spec in a temporary directory.
    (a) the reference's ``examples/plans/fleet_warmup.json`` warmed whole
    with ``--workers 4`` (its ``[calibrate]`` line first), the platform
    job against the explorer on the same spec, the meta job's lattice
    searched for real; (b) a plan at the main path's full widths: the
    four kernel tunables at phase 4's shapes under ``measure`` and under
    ``grid`` (what ``@autotune`` looks up), the five serving tunables as
    phase 9 prices them, and a meta job over the 2^28 reduction; (c) the
    cache exported for ``cuda``, merged into a fresh node cache, listed,
    pruned, and a CPU bundle merged and pruned; (d) the node resolving
    the four kernels from its cache at (b)'s shapes, each held to its
    plain version at phase 3's tolerances, and both plans again against
    the node: all hits, no engine run; (e) ``verify`` on this tree:
    ``lint``, ``check``, ``mutants``, a mutant's trail and phase 10(f)'s
    monitor trail replayed.  ``check`` and ``mutants`` run in the
    background from the start; after the merge the CLIs that time
    nothing (listing, pruning, re-warm-up, lint, replays) run side by
    side.  The launches returned are the warm-ups' (read from each
    subprocess at its exit) and (d)'s."""

    import dataclasses
    import hashlib
    import os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.calibrate import (DEFAULT_SPEC, load_spec,
                                       set_platform_spec)
    from repro_torch.core import PlatformSpec, WaveParams
    from repro_torch.kernels.flash_attention.ops import (attention_ref,
                                                         flash_attention)
    from repro_torch.kernels.matmul_tuned.ops import matmul_ref, matmul_tuned
    from repro_torch.kernels.sweep_eval.ops import sweep_eval, sweep_ref
    from repro_torch.kernels.tuned_reduction.ops import (reduce_1d,
                                                         reduce_chunked)
    from repro_torch.runtime.speculate import spec_depth_tunable
    from repro_torch.runtime.tunables import (decode_batch_tunable,
                                              kv_page_tunable,
                                              prefill_chunk_tunable,
                                              scheduler_tunable)
    from repro_torch.tune import (PlatformTunable, TuningCache, build_tunable,
                                  set_default_cache, tune,
                                  tunable_fingerprint)

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    names = ("tuned_reduction", "sweep_eval", "matmul_tuned",
             "flash_attention")
    launches = dict.fromkeys(names, 0)
    cli_s: dict[str, float] = {}
    prev_env = {k: os.environ.get(k) for k in ("REPRO_TORCH_PLATFORM_SPEC",
                                                "REPRO_TORCH_TUNE_CACHE")}
    prev_spec = set_platform_spec(None)
    prev_cache = None
    background: dict[str, subprocess.Popen] = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            os.environ["REPRO_TORCH_PLATFORM_SPEC"] = str(
                tmp / "platform_spec.json")
            os.environ["REPRO_TORCH_TUNE_CACHE"] = str(tmp / "default.json")
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            warm, node = tmp / "warm.json", tmp / "node.json"
            lock = threading.Lock()

            def cli(tag, module, *args, want_rc=0):
                res = run_cli(module, list(args), env,
                              tmp / f"launches-{tag}.json")
                if res["launches"] is None:
                    raise AssertionError(f"{tag}: no launch counts "
                                         f"(rc {res['rc']}) {res['err']}")
                with lock:
                    cli_s[tag] = res["seconds"]
                    for k in names:
                        launches[k] += res["launches"][k]
                if res["rc"] != want_rc:
                    raise AssertionError(
                        f"{tag}: exit {res['rc']} (want {want_rc})\n"
                        f"{res['out'][-3000:]}\n{res['err'][-3000:]}")
                return res

            # (e)'s model checks, host Python on one CPU core, start first
            # and run beside everything else (the timed jobs time the
            # card with CUDA events)
            trails = tmp / "trails"
            t_background = time.perf_counter()
            for cmd in ("check", "mutants"):
                with open(tmp / f"{cmd}.json", "w") as out:
                    background[cmd] = subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.verify", cmd,
                         "--json", "--trail-dir", str(trails)],
                        stdout=out, stderr=subprocess.PIPE, text=True,
                        cwd=ROOT, env=env)

            def finish(cmd):
                proc = background.pop(cmd)
                _, err = proc.communicate(timeout=900)
                return (proc.returncode,
                        json.loads((tmp / f"{cmd}.json").read_text()), err,
                        time.perf_counter() - t_background)

            # (a) the reference's plan, whole
            spec_a = json.loads(FLEET_PLAN.read_text())
            res = cli("warmup_reference", "repro_torch.tune", "--cache",
                      warm, "warmup", FLEET_PLAN, "--workers", "4", "--json")
            rep = json.loads(res["out"])
            progress = [ln for ln in res["err"].splitlines()
                        if ln.startswith("[")]
            jobs = {j["label"]: j for j in rep["jobs"]}
            (pjob,) = [j for j in spec_a["jobs"] if j["tunable"] == "platform"]
            platform_tb = PlatformTunable(PlatformSpec(**pjob["params"]))
            explorer = tune(platform_tb, engine="explorer", cache=None)
            plat = jobs[pjob["label"]]
            (mjob,) = [j for j in spec_a["jobs"]
                       if j["tunable"] == "meta.engine"]
            meta_key = jobs[mjob["label"]]["key"]
            meta_entry = json.loads(warm.read_text())["entries"][meta_key]
            # the meta job once more in-process (no cache), for its trials
            meta = build_tunable("meta.engine", mjob["params"])
            meta_res = tune(meta, engine=mjob["engine"], cache=None)
            trials = {}
            for key, trial in sorted(meta.trials.items()):
                cfg = dict(key)
                trials[f"top_k={cfg['top_k']},repeats={cfg['repeats']}"] = {
                    "pick": trial.best_config, "t_min_us": trial.t_min,
                    "oracle_calls": trial.oracle_calls,
                    "provenance": trial.stats["provenance"],
                    "shortlist": trial.stats["shortlist"],
                    "repeats": trial.stats["repeats"],
                    "candidates": len(trial.stats["candidates"])}
            plan_fit = load_spec(
                os.environ["REPRO_TORCH_PLATFORM_SPEC"]).constants()
            space = mjob["params"]["space"]
            points = [(k, r) for k in space["top_k"]
                      for r in space["repeats"]]
            emit("fleet", part="reference_plan",
                 plan=str(FLEET_PLAN.relative_to(ROOT)), rc=res["rc"],
                 counts=rep["counts"], calibrate=progress[0],
                 jobs=[{k: j[k] for k in ("label", "status", "engine",
                                          "t_min", "best_config",
                                          "provenance", "elapsed_s")}
                       for j in rep["jobs"]],
                 platform={"plan_pick": plat["best_config"],
                           "plan_t_min": plat["t_min"],
                           "explorer_pick": explorer.best_config,
                           "explorer_t_min": explorer.t_min,
                           "explorer_states": explorer.stats.get("states")},
                 meta={"plan_pick": jobs[mjob["label"]]["best_config"],
                       "plan_points": meta_entry["oracle_calls"],
                       "in_process_pick": meta_res.best_config,
                       "trials": trials},
                 plan_fit=plan_fit, data_sheet=DEFAULT_SPEC.constants(),
                 seconds=res["seconds"], launches=res["launches"])
            # the plan's "calibrate" key fits the card's ladders, as phase
            # 10(a) does (the CPU's quick sizes fit launches, not roofs)
            shares = {key: plan_fit[key] / getattr(DEFAULT_SPEC, key)
                      for key in ("peak_flops", "hbm_bw")}
            if not all(0.5 <= share <= 1.05 for share in shares.values()):
                raise AssertionError(f"the plan's calibration: {shares} of "
                                     f"the data sheet (want 50-105 %)")
            if rep["counts"] != {"jobs": 12, "hits": 0, "tuned": 12,
                                 "forced": 0, "failed": 0} or \
                    len(spec_a["jobs"]) != 11 or \
                    not progress[0].startswith(f"[calibrate] probed cuda/"
                                               f"{name} "):
                raise AssertionError(f"reference plan: {rep['counts']} "
                                     f"{progress[:1]}")
            # at size 16 the Minimum is tied ((4, 4) and (16, 4) both take
            # 24): the explorer's witness may be the other optimum
            if plat["t_min"] != explorer.t_min or \
                    platform_tb.cost(plat["best_config"]) != explorer.t_min \
                    or platform_tb.cost(explorer.best_config) != \
                    explorer.t_min:
                raise AssertionError(f"platform job {plat} against the "
                                     f"explorer's {explorer.best_config} "
                                     f"{explorer.t_min}")
            searched = {(dict(key)["top_k"], dict(key)["repeats"]): t
                        for key, t in meta.trials.items()}
            if meta_entry["oracle_calls"] != len(points) or \
                    set(searched) != set(points) or any(
                        t.oracle_calls != k * r
                        or t.stats["provenance"] != "measured"
                        or len(t.stats["candidates"]) != k
                        or t.stats["repeats"] != r
                        for (k, r), t in searched.items()):
                raise AssertionError(f"meta job: {meta_entry} {trials}")
            if res["launches"]["tuned_reduction"] <= 0:
                raise AssertionError("the meta job's inner tunes never "
                                     "launched the reduction")

            # (b) the full-width plan
            api = model["api"]
            serving = {
                "serve.decode_batch": decode_batch_tunable(api, **TUNE_LOAD),
                "serve.prefill_chunk": prefill_chunk_tunable(
                    api, prompt_len=TUNE_PROMPT, batch=TUNE_SLOTS,
                    **TUNE_LOAD),
                "serve.kv_page": kv_page_tunable(
                    api, prompt_lens=[TUNE_PROMPT], batch=TUNE_SLOTS,
                    **TUNE_LOAD),
                "serve.spec_depth": spec_depth_tunable(
                    api, prompt_len=TUNE_PROMPT, batch=TUNE_SLOTS,
                    **TUNE_LOAD),
                "serve.scheduler": scheduler_tunable(api, **SCHED)}
            jobs_b = []
            for kname, params in FLEET_KERNELS:
                for engine in ("measure", "grid"):
                    jobs_b.append({"tunable": kname, "params": params,
                                   "engine": engine})
            for sname, tb in serving.items():
                params = json.loads(json.dumps(
                    {f.name: getattr(tb, f.name)
                     for f in dataclasses.fields(tb) if f.compare}))
                if build_tunable(sname, params).fingerprint() != \
                        tunable_fingerprint(tb):
                    raise AssertionError(f"{sname}: the plan's params do "
                                         f"not rebuild phase 9's tunable")
                jobs_b.append({"tunable": sname, "params": params,
                               "engine": "grid"})
            jobs_b.append({"tunable": "meta.engine", "label":
                           "meta.measure-reduction-2^28", "engine": "grid",
                           "params": {"engine": "measure", "inner": {
                               "tunable": "kernels.tuned_reduction",
                               "params": {"n": REDUCE_N}},
                               "space": FLEET_META_SPACE}})
            plan_b = tmp / "full_width_plan.json"
            plan_b.write_text(json.dumps({"name": "full-width",
                                          "jobs": jobs_b}, indent=1))
            res = cli("warmup_full_width", "repro_torch.tune", "--cache",
                      warm, "warmup", plan_b, "--json")
            rep_b = json.loads(res["out"])
            emit("fleet", part="full_width_plan", rc=res["rc"],
                 counts=rep_b["counts"],
                 jobs=[{k: j[k] for k in ("label", "status", "engine",
                                          "t_min", "best_config",
                                          "provenance", "elapsed_s")}
                       for j in rep_b["jobs"]],
                 seconds=res["seconds"], launches=res["launches"], card=smi)
            if rep_b["counts"] != {"jobs": len(jobs_b), "hits": 0,
                                   "tuned": len(jobs_b), "forced": 0,
                                   "failed": 0}:
                raise AssertionError(f"full-width plan: {rep_b['counts']}")
            idle = [k for k in names if res["launches"][k] <= 0]
            if idle:
                raise AssertionError(f"the full-width measure jobs never "
                                     f"launched {idle}")

            # (c) ship it: export and merge, then side by side (none of
            # them times anything) the node's listing, the prune chain,
            # both plans again against the node, the lint and the replays
            n_warm = len(TuningCache(warm))
            art = tmp / "artifact.json"
            shipped = {}
            res = cli("export", "repro_torch.tune", "--cache", warm,
                      "export", art, "--platform", "cuda")
            shipped["export"] = res["out"].strip()
            if not shipped["export"].startswith(
                    f"exported {n_warm} entries (1 platform(s)) -> "):
                raise AssertionError(f"export: {shipped['export']}")
            res = cli("merge", "repro_torch.tune", "--cache", node,
                      "merge", art, "--policy", "prefer_measured")
            shipped["merge"] = res["out"].strip().splitlines()
            if f"{n_warm} added, 0 replaced, 0 kept" not in \
                    shipped["merge"][0] or len(shipped["merge"]) != 2 or \
                    not shipped["merge"][1].startswith(
                        "  artifact provenance: repro_torch "):
                raise AssertionError(f"merge: {shipped['merge']}")
            # a bundle made on a CPU: two entries under the CPU platform
            cpu_cache = TuningCache(tmp / "cpu_node.json")
            cpu_pf = {"backend": "cpu", "device_kind": "cpu",
                      "capability": "", "torch": torch.__version__,
                      "calibration": "default"}
            for n in (4096, 8192):
                tb = build_tunable("kernels.tuned_reduction",
                                   {"n": n, "device": "cpu"})
                doc = {"schema": 1, "tunable": tunable_fingerprint(tb),
                       "platform": cpu_pf, "engine": "grid"}
                key = hashlib.sha256(json.dumps(
                    doc, sort_keys=True, default=str).encode()).hexdigest()
                r = tune(tb, engine="grid", cache=None)
                cpu_cache.put_entry(key, {
                    "best_config": r.best_config, "t_min": r.t_min,
                    "engine": "grid", "oracle_calls": r.oracle_calls,
                    "elapsed_s": r.elapsed_s, "stats": {}, "witness": None,
                    "created": time.time(), "provenance": "modeled",
                    "fingerprint": doc})
            cpu_cache.export_artifact(tmp / "cpu_bundle.json")
            drain = tmp / "drain_trail.json"
            drain.write_text(json.dumps(observed["monitor_trail"]))
            mutants = finish("mutants")
            if mutants[0] != 0 or not mutants[1]["mutants"]:
                raise AssertionError(f"mutants: rc {mutants[0]} "
                                     f"{mutants[2][-2000:]}")

            def prune_chain():
                return [cli("prune_none", "repro_torch.tune", "--cache",
                            node, "prune", "--backend", "cpu"),
                        cli("merge_cpu", "repro_torch.tune", "--cache", node,
                            "merge", tmp / "cpu_bundle.json"),
                        cli("prune_cpu", "repro_torch.tune", "--cache", node,
                            "prune", "--backend", "cpu")]

            side = {
                "ls": (cli, "ls", "repro_torch.tune", "--cache", node, "ls",
                       "--json"),
                "prune_chain": (prune_chain,),
                "rewarm_reference": (cli, "rewarm_reference",
                                     "repro_torch.tune", "--cache", node,
                                     "warmup", FLEET_PLAN, "--json"),
                "rewarm_full_width": (cli, "rewarm_full_width",
                                      "repro_torch.tune", "--cache", node,
                                      "warmup", plan_b, "--json"),
                "lint": (cli, "lint", "repro_torch.verify", "lint",
                         "--json"),
                "replay_drain": (cli, "replay_drain", "repro_torch.verify",
                                 "replay", "--trail", drain)}
            with ThreadPoolExecutor(max_workers=len(side) + 1) as pool:
                futures = {k: pool.submit(*v) for k, v in side.items()}
                futures["replay_mutant"] = pool.submit(
                    cli, "replay_mutant", "repro_torch.verify", "replay",
                    "--trail", mutants[1]["mutants"][0]["trail"], want_rc=1)
                done = {k: f.result() for k, f in futures.items()}
            rows = json.loads(done["ls"]["out"])
            if len(rows) != n_warm or any(
                    r["platform"] != f"cuda/{name}" or not r["origin"]
                    for r in rows):
                raise AssertionError(f"ls: {rows}")
            for key, res in zip(("prune_none", "merge_cpu", "prune_cpu"),
                                done["prune_chain"]):
                shipped[key] = res["out"].strip().splitlines()[0]
            emit("fleet", part="ship", entries=n_warm, lines=shipped,
                 ls_platforms=sorted({r["platform"] for r in rows}),
                 ls_origin_tools=sorted({r["origin"]["tool"] for r in rows}))
            if not shipped["prune_none"].startswith(
                    f"pruned 0 entries -> {n_warm} remain") or \
                    "2 added, 0 replaced, 0 kept" not in \
                    shipped["merge_cpu"] or not shipped["prune_cpu"] \
                    .startswith(f"pruned 2 entries -> {n_warm} remain"):
                raise AssertionError(f"prune/merge: {shipped}")

            # (d) the fleet node: the four kernels from the node's cache
            node_cache = TuningCache(node)
            prev_cache = set_default_cache(node_cache)
            x = torch.randint(-2**31, 2**31 - 1, (REDUCE_N,), generator=gen,
                              device=dev, dtype=torch.int32)
            axis = torch.arange(1, SWEEP_SIDE + 1, dtype=torch.int32,
                                device=dev)
            wg = axis.repeat_interleave(SWEEP_SIDE)
            ts = axis.repeat(SWEEP_SIDE)
            wave = WaveParams(size=SWEEP_CHECK_SIZE, NP=128, GMT=16, L=8,
                              kind="minimum", NU=132, warp=32)
            a, b = (torch.randn(*MM_BF16[:2], generator=gen, device=dev
                                ).to(torch.bfloat16) for _ in range(2))
            q, k, v = (torch.randn(1, 20, FWD_S, 128, generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(3))
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            outs = {"tuned_reduction": reduce_1d(x, op="min"),
                    "sweep_eval": sweep_eval(wg, ts, wave),
                    "matmul_tuned": matmul_tuned(a, b),
                    "flash_attention": flash_attention(q, k, v, causal=True)}
            torch.cuda.synchronize()
            node_launches = [c.launches for c in counters]   # path ends
            for kname, n in zip(names, node_launches):
                launches[kname] += n
            decisions = {
                "tuned_reduction": reduce_1d.tune(x, op="min"),
                "sweep_eval": sweep_eval.tune(wg, ts, wave),
                "matmul_tuned": matmul_tuned.tune(a, b),
                "flash_attention": flash_attention.tune(q, k, v,
                                                        causal=True)}
            cfg = decisions["tuned_reduction"].best_config
            want = reduce_chunked(x, "min", cfg["WG"], cfg["TS"])
            errs = {"tuned_reduction": abs(int(outs["tuned_reduction"])
                                           - int(want))}
            if not torch.equal(outs["tuned_reduction"].cpu(), want.cpu()):
                raise AssertionError("node reduction != plain")
            want = sweep_ref(wave, wg, ts)
            errs["sweep_eval"] = int((outs["sweep_eval"].long()
                                      - want.long()).abs().max())
            if not torch.equal(outs["sweep_eval"], want):
                raise AssertionError("node sweep != plain")
            got, want = outs["matmul_tuned"].float(), matmul_ref(a, b).float()
            diff = (got - want).abs()
            tol, K = MM_TOL["bfloat16"], MM_BF16[2]
            rel = {"matmul_tuned": float(diff.norm() / want.norm())}
            errs["matmul_tuned"] = float(diff.max())
            if not bool((diff <= tol * K ** 0.5 + tol * want.abs()).all()) \
                    or rel["matmul_tuned"] > MM_REL_L2:
                raise AssertionError(f"node matmul: {errs} {rel}")
            got = outs["flash_attention"].float()
            want = attention_ref(q, k, v, causal=True).float()
            diff = (got - want).abs()
            atol, rtol = FLASH_TOL["bfloat16"]
            rel["flash_attention"] = float(diff.norm() / want.norm())
            errs["flash_attention"] = float(diff.max())
            if not bool((diff <= atol + rtol * want.abs()).all()) \
                    or rel["flash_attention"] > FLASH_REL_L2:
                raise AssertionError(f"node flash: {errs} {rel}")
            emit("fleet", part="node", stats=node_cache.stats,
                 resolved={kname: {"config": d.best_config,
                                   "cache": d.stats["cache"]}
                           for kname, d in decisions.items()},
                 launches=dict(zip(names, node_launches)),
                 max_abs_err=errs, rel_l2=rel, tol={
                     "matmul_tuned": [tol, MM_REL_L2],
                     "flash_attention": [atol, rtol, FLASH_REL_L2]})
            if node_cache.misses != 0 or any(
                    d.stats["cache"] != "hit" for d in decisions.values()) \
                    or any(n != 1 for n in node_launches):
                raise AssertionError(f"node: {node_cache.stats} "
                                     f"{node_launches}")
            del x, axis, wg, ts, a, b, q, k, v, outs, got, want, diff
            torch.cuda.empty_cache()
            # both plans again against the node (run in (c)'s side by
            # side group): pure hits, no engine run
            rewarm = {}
            for tag in ("rewarm_reference", "rewarm_full_width"):
                res = done[tag]
                counts = json.loads(res["out"])["counts"]
                rewarm[tag] = {"counts": counts, "launches": res["launches"],
                               "seconds": res["seconds"]}
                if counts["hits"] != counts["jobs"] or \
                        any(res["launches"].values()):
                    raise AssertionError(f"{tag}: {rewarm[tag]}")
            emit("fleet", part="rewarm", **rewarm)

            # (e) verify on this tree
            res = done["lint"]
            lint = json.loads(res["out"])
            waived = [f"{w['path']}:{w['line']} [{w['rule']}]"
                      for w in lint["waived"]]
            emit("verify_cli", part="lint", rc=res["rc"], ok=lint["ok"],
                 findings=len(lint["findings"]), waived=len(waived),
                 waivers=waived, seconds=res["seconds"])
            if not lint["ok"] or not waived:
                raise AssertionError(f"lint: {lint}")
            rc, check, err, check_s = finish("check")
            emit("verify_cli", part="check", rc=rc, ok=check["ok"],
                 exhaustive=check["exhaustive"],
                 checks=[{k: c[k] for k in ("name", "status", "states",
                                            "transitions", "elapsed_s")}
                         for c in check["checks"]], seconds=check_s)
            if rc != 0 or not check["ok"] or not check["exhaustive"]:
                raise AssertionError(f"check: rc {rc} {err[-2000:]}")
            rc, out, err, mutants_s = mutants
            emit("verify_cli", part="mutants", rc=rc, ok=out["ok"],
                 mutants=[{k: m[k] for k in ("mutant", "caught",
                                             "reproduced", "ops", "states")}
                          for m in out["mutants"]], seconds=mutants_s)
            if len(out["mutants"]) != 6 or not all(
                    m["caught"] and m["reproduced"] and
                    Path(m["trail"]).exists() for m in out["mutants"]):
                raise AssertionError(f"mutants: {out}")
            reproduced = [ln for ln in done["replay_mutant"]["out"]
                          .splitlines() if ln.startswith("REPRODUCED")]
            emit("verify_cli", part="replay",
                 mutant=out["mutants"][0]["mutant"],
                 mutant_line=reproduced[:1],
                 drain_ops=len(observed["monitor_trail"]["ops"]),
                 drain_config=observed["monitor_trail"]["config"],
                 drain_last=done["replay_drain"]["out"].strip()
                 .splitlines()[-1])
            if not reproduced or "trail replays clean" not in \
                    done["replay_drain"]["out"]:
                raise AssertionError("replay: mutant not reproduced or the "
                                     "drain's trail diverged")
    finally:
        for proc in background.values():
            proc.kill()
            proc.wait()
        set_platform_spec(prev_spec)
        if prev_cache is not None:
            set_default_cache(prev_cache)
        for key, val in prev_env.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    phase_s = time.perf_counter() - t_phase
    emit("fleet", part="phase", seconds=phase_s, cli_seconds=cli_s,
         launches=launches, card=smi)
    return {"launches": [launches[k] for k in names]}


def flash_layers(cfg, params, x, pos, enc=None) -> list:
    """Phase 6(a)'s check over any stack: teacher-forced layer by layer
    in the plain chain, each self-attention layer's output through the
    flash kernel against the plain math on the same input (rel L2)."""

    from repro_torch.models.attention import attention
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import (_block_plan, block_params,
                                                layer_forward)

    plain = cfg.replace(use_flash=False)
    kinds, n_blocks = _block_plan(cfg)
    rels = []
    for i in range(n_blocks):
        bp = block_params(params["blocks"], i)
        for j, kind in enumerate(kinds):
            p = bp[f"{j}_{kind}"]
            if "attn" in p:
                hn = rms_norm(x, p["ln1"])
                got = attention(p["attn"], cfg, hn, pos, window=cfg.window,
                                use_flash=True).float()
                want = attention(p["attn"], cfg, hn, pos,
                                 window=cfg.window).float()
                rels.append(float((got - want).norm() / want.norm()))
            x = layer_forward(p, plain, kind, x, pos, enc_out=enc)
        if cfg.is_encdec:
            xp = block_params(params["xattn_blocks"], i)
            x = x + attention(xp["x"], cfg, rms_norm(x, xp["ln_x"]), pos,
                              x_kv=enc)
    return rels


def cut_params(params, n_layers, **stacks):
    """The first ``n_layers`` of every stacked tree (``blocks``,
    ``xattn_blocks``, and each of ``stacks`` at its own depth), the rest
    of the tree as it is; the dtype kept.  Slices are views."""

    from repro_torch.models.common import tree_map
    depth = {"blocks": n_layers, "xattn_blocks": n_layers, **stacks}
    return {k: (tree_map(lambda t, n=depth[k]: t[:n], v) if k in depth
                else v) for k, v in params.items()}


def families(dev, gen, counters) -> dict:
    """Phase 12: the other model families at full width on the card, each
    on its own path (counts set to 0 just before its forward and drain,
    read just after):

    (a) hymba-1.5b whole: each layer's attention through flash against
    the plain math (bf16, teacher-forced), the f32 cut flash against
    plain end to end, the forward at S = 4096 timed, a Server of 4 slots
    at context 2,048 draining 4 x (1,536 + 16) contiguous (the window
    ring wraps) and paged (pages that leave the window go back), n-gram
    speculation paged on prompts of one token repeated, a profiled
    decode tick; on the f32 cut the Server's greedy tokens against the
    offline flash forward, and n-gram and self-draft drains against the
    plain drain;
    (b) mamba2-2.7b whole: the forward (SSD chunk 128, h in f32) and a
    drain of 4 x (512 + 16); on the f32 cut the recurrence's logits
    against the chunked scan's and the Server against the offline
    forward;
    (c) whisper-medium whole: the encoder over 1,500 frames (plain: 1,500
    does not tile by 128), the decoder at S = 512 through flash, a
    Server with frames per request; on the f32 cut against the offline
    enc-dec greedy;
    (d) mixtral-8x22b, 2 of 56 layers: the forward at S = 4096, a drain
    of 2 x (512 + 16); on the f32 cut with capacity factor 16 the
    prefill and decode logits against the forward's;
    (e) llama-3.2-vision-90b, one block (5 of 100 layers): the forward
    with 1,024 image embeddings, a drain whose cross K/V starts at zero;
    (f) ``python -m repro_torch.launch.serve --arch hymba-1.5b --preset
    full`` as a subprocess.

    First the flash kernel at each family's attention shape against its
    plain version (not counted), for the kernel's share of a forward.
    Returns the launches of each kernel over the five paths."""

    import dataclasses
    import gc
    import os

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import BF16_FLOPS
    from repro_torch.kernels.flash_attention.ops import (
        FlashAttentionTunable, attention_ref, flash_attention, visible_pairs)
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import _embed, _sinusoid, encode
    from repro_torch.runtime import DraftModelDrafter, Server
    from repro_torch.tune import TuningCache, set_default_cache, tune

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    total = [0] * len(counters)
    fk = counters[-1]

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def start_path():
        for c in counters:
            c.launches = 0

    def end_path():
        for i, c in enumerate(counters):
            total[i] += c.launches
        return fk.launches

    def build(name, n_layers=None):
        cfg = get_config(name).replace(use_flash=True)
        if n_layers is not None:
            cfg = cfg.replace(n_layers=n_layers)
        api = build_model(cfg)
        t0 = time.perf_counter()
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = api.init(g, device=dev)
        torch.cuda.synchronize()
        return cfg, api, params, {
            "params": api.param_count(),
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in tree_leaves(params)),
            "init_s": time.perf_counter() - t0}

    def timed_forward(api, params, batch, n_flash):
        """The forward (after one call that lets @autotune resolve the
        blocks), three times, and the plain forward once: median ms,
        flash launches per forward."""

        api.forward(params, batch)
        ms, per = [], []
        for _ in range(3):
            before = fk.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = api.forward(params, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per.append(fk.launches - before)
            S = batch["tokens"].shape[1]
            if not bool(torch.isfinite(logits[0, -1]).all()) or \
                    logits.shape != (1, S, api.cfg.vocab):
                raise AssertionError(f"{api.cfg.name} forward: "
                                     f"{logits.shape}, non-finite logits")
            del logits
        if per != [n_flash] * 3:
            raise AssertionError(f"{api.cfg.name}: flash launches a forward "
                                 f"{per}, want {n_flash}")
        return sorted(ms)[1], ms, per[0]

    def plain_forward_ms(api, params, batch):
        plain = build_model(api.cfg.replace(use_flash=False))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.forward(params, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def drain(api, params, prompts, max_new, frames=None, prepare=None,
              **kw):
        server = Server(api, params, **kw)
        if prepare is not None:
            prepare(server)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [server.submit(q, max_new=max_new,
                              frames=None if frames is None else frames[i])
                for i, q in enumerate(prompts)]
        server.run_until_drained(max_ticks=100_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(r.done and len(r.out) == max_new for r in reqs):
            raise AssertionError(f"{api.cfg.name}: a request did not finish")
        n_tok = sum(len(r.out) for r in reqs)
        return server, [r.out for r in reqs], {
            "ticks": server.ticks, "wall_s": wall, "tokens": n_tok,
            "tok_per_s": n_tok / wall, "stats": server.stats()}

    def f32_cut(api, params, n_layers=FAMILY_CUT, **kw):
        """The model cut to ``n_layers`` (``kw`` replaces more config
        fields), with flash and plain, and its weights in f32."""

        cfg = api.cfg.replace(n_layers=n_layers, **kw)
        p = tree_map(lambda t: t.float(), cut_params(
            params, n_layers, **({"enc_blocks": kw["encoder_layers"]}
                                 if "encoder_layers" in kw else {})))
        return build_model(cfg), build_model(
            cfg.replace(use_flash=False)), p

    def last_logits(a_api, b_api, p, batch):
        got = a_api.forward(p, batch)[:, -1].float()
        want = b_api.forward(p, batch)[:, -1].float()
        idx, gap = top2(want)
        return {"max_abs_diff": float((got - want).abs().max()),
                "rel_l2": rel(got, want), "min_top2_gap": float(gap.min()),
                "argmax_equal": bool((got.argmax(-1) == idx).all())}

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the flash kernel at each family's shape, bf16, against its plain
    # version (phase 3d's tolerances); library: SDPA, a boolean window
    # mask where there is a window; the bound counts the (q, k) pairs
    # inside the mask
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash = {}
    for name, (B, H, S, D, causal, window) in FAMILY_FLASH.items():
        q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
        tiles = tune(FlashAttentionTunable(
            S=S, D=D, BH=B * H, causal=causal, window=window,
            dtype_bytes=2), engine="grid", cache=None).best_config
        run = lambda: flash_attention(q, k, v, causal=causal, window=window,
                                      **tiles)
        plain = lambda: attention_ref(q, k, v, causal=causal, window=window)
        got, want = run().float(), plain().float()
        atol, rtol = FLASH_TOL["bfloat16"]
        diff = (got - want).abs()
        rel_l2 = float(diff.norm() / want.norm())
        if not bool((diff <= atol + rtol * want.abs()).all()) \
                or not rel_l2 <= FLASH_REL_L2:
            raise AssertionError(f"flash at {name}'s shape: max err "
                                 f"{diff.max()}, rel L2 {rel_l2}")
        if window is None:
            library = lambda: sdpa(q, k, v, is_causal=causal)
        else:
            i = torch.arange(S, device=dev)
            keep = (i[None, :] <= i[:, None]) & \
                (i[None, :] >= i[:, None] - window + 1)
            library = lambda: sdpa(q, k, v, attn_mask=keep)
        pairs = visible_pairs(S, causal, window)
        bb, by = bound_ms(4 * B * H * S * D * 2, 4 * B * H * pairs * D,
                          BF16_FLOPS)
        flash[name] = {
            "case": f"{name}-bfloat16-{B}x{H}x{S}x{D}-causal={causal}-"
                    f"window={window}",
            "config": tiles, "max_abs_err": float(diff.max()),
            "rel_l2": rel_l2, "tol": [atol, rtol, FLASH_REL_L2],
            "ms": time_ms(run, 10), "plain_ms": time_ms(plain, 3, warmup=1),
            "library_ms": time_ms(library, 10), "bound_ms": bb,
            "bound_by": by, "pairs": pairs}
        flash[name]["tflops"] = 4 * B * H * pairs * D / \
            flash[name]["ms"] / 1e9
        emit("kernel", name="flash_attention", **flash[name])
        del q, k, v, got, want, diff
    release()

    rng = np.random.default_rng(12)
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        prev = set_default_cache(TuningCache(Path(tmp) / "tune_cache.json"))
        try:
            # (a) hymba-1.5b -------------------------------------------------
            name = "hymba-1.5b"
            fam = FAMILIES[name]
            cfg, api, params, init = build(name)
            S = fam["fwd_s"]
            toks = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                 device=dev)
            pos = torch.arange(S, device=dev)[None]
            local = flash_layers(cfg, params, _embed(params, toks), pos)
            if not max(local) <= LAYER_ATTN_TOL:
                raise AssertionError(f"{name}: flash in the model, layer "
                                     f"rel error {max(local)}")
            api_cut, plain_cut, p_cut = f32_cut(api, params)
            cmp = last_logits(api_cut, plain_cut, p_cut, {"tokens": toks})
            d = cmp["max_abs_diff"]
            if not cmp["rel_l2"] <= FWD_REL_TOL:
                raise AssertionError(f"{name} f32 cut: flash vs plain rel "
                                     f"{cmp['rel_l2']} > {FWD_REL_TOL}")
            emit("families", part="hymba_checks", arch=name,
                 attn_rel_l2=local, max_attn_rel_l2=max(local),
                 f32_cut_layers=FAMILY_CUT, f32_cut_forward=cmp)
            prompts = [rng.integers(0, cfg.vocab, fam["prompt_len"]).tolist()
                       for _ in range(fam["requests"])]
            rep = [[p_[0]] * fam["prompt_len"] for p_ in prompts]
            serve = fam["serve"]
            paged_kw = dict(serve, paged=True, page_size=16)

            start_path()
            fwd_ms, fwd_all, n_flash = timed_forward(api, params,
                                                     {"tokens": toks},
                                                     cfg.n_layers)
            srv, out_c, contiguous = drain(api, params, prompts, MAX_NEW,
                                           **serve)
            # a decode tick of 4 reused slots (their SSM state reset)
            reqs = [srv.submit(q[:64], max_new=4) for q in prompts]
            while not all(r.out for r in reqs):
                srv.tick()
            prof = tick_profile(srv)
            srv.run_until_drained()
            del srv
            srv, out_p, paged = drain(api, params, prompts, MAX_NEW,
                                      **paged_kw)
            peak, full = srv.peak_used_pages, fam["requests"] * -(-(
                fam["prompt_len"] + MAX_NEW) // 16)
            del srv
            srv, _, ngram = drain(api, params, rep, MAX_NEW,
                                  speculate="ngram", spec_depth=SPEC_DEPTH,
                                  **paged_kw)
            del srv
            launched = end_path()
            plain_ms = plain_forward_ms(api, params, {"tokens": toks})
            if peak >= full:
                raise AssertionError(f"{name} paged: peak {peak} pages, no "
                                     f"fewer than {full} for whole streams")
            if ngram["stats"]["spec_proposed"] <= 0:
                raise AssertionError(f"{name}: n-gram drafted nothing")
            equal = sum(x == y for a, b in zip(out_c, out_p)
                        for x, y in zip(a, b))
            line = dict(
                arch=name, reduced=None, params=init["params"],
                weight_bytes=init["weight_bytes"], init_s=init["init_s"],
                S=S, forward_ms=fwd_ms, forward_ms_all=fwd_all,
                plain_forward_ms=plain_ms, flash_launches_per_forward=n_flash,
                flash_share=n_flash * flash[name]["ms"] / fwd_ms,
                flash_launches=launched, serve=serve,
                requests=fam["requests"], prompt_len=fam["prompt_len"],
                max_new=MAX_NEW, contiguous=contiguous, paged=paged,
                paged_peak_pages=peak, pages_for_whole_streams=full,
                paged_tokens_equal_to_contiguous=equal,
                ngram_paged=dict(ngram, prompts="one token repeated"),
                decode_tick_profile=prof)
            emit("families", part="hymba", **line)
            del params
            release()

            # the f32 cut: the Server against the offline flash forward,
            # paged against contiguous (the window ring wraps), the
            # speculative drains (prompts of one token repeated, as in
            # (a)'s n-gram drain) against the plain drain
            _, base, _ = drain(api_cut, p_cut, prompts, MAX_NEW, **serve)
            greedy = greedy_against_offline(api_cut, p_cut, prompts, base, d,
                                            dev)
            _, out_p, _ = drain(api_cut, p_cut, prompts, MAX_NEW, **paged_kw)
            rep = [q[:fam["spec_prompt_len"]] for q in rep]
            _, rep_base, _ = drain(api_cut, p_cut, rep, MAX_NEW, **serve)
            _, out_ng, ng = drain(api_cut, p_cut, rep, MAX_NEW,
                                  speculate="ngram", spec_depth=SPEC_DEPTH,
                                  **paged_kw)
            _, out_sd, sd = drain(api_cut, p_cut, rep, MAX_NEW,
                                  speculate=DraftModelDrafter(
                                      api_cut, p_cut, bucket=128),
                                  spec_depth=SPEC_DEPTH, **serve)
            emit("families", part="hymba_f32_cut", n_layers=FAMILY_CUT,
                 greedy=greedy, paged=first_divergence(
                     api_cut, p_cut, prompts, out_p, base, d, dev),
                 ngram_paged=dict(first_divergence(
                     api_cut, p_cut, rep, out_ng, rep_base, d, dev),
                     **ng["stats"]),
                 self_draft=dict(first_divergence(
                     api_cut, p_cut, rep, out_sd, rep_base, d, dev),
                     **sd["stats"]))
            if ng["stats"]["spec_proposed"] <= 0 or \
                    sd["stats"]["spec_accepted"] <= 0:
                raise AssertionError(f"{name} f32 cut: speculation idle")
            del api_cut, plain_cut, p_cut
            release()

            # (b) mamba2-2.7b ------------------------------------------------
            name = "mamba2-2.7b"
            fam = FAMILIES[name]
            cfg, api, params, init = build(name)
            S = fam["fwd_s"]
            toks = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                 device=dev)
            prompts = [rng.integers(0, cfg.vocab, fam["prompt_len"]).tolist()
                       for _ in range(fam["requests"])]
            start_path()
            fwd_ms, fwd_all, n_flash = timed_forward(api, params,
                                                     {"tokens": toks}, 0)
            _, _, contiguous = drain(api, params, prompts, MAX_NEW,
                                     **fam["serve"])
            launched = end_path()
            line = dict(
                arch=name, reduced=None, params=init["params"],
                weight_bytes=init["weight_bytes"], init_s=init["init_s"],
                S=S, ssd_chunk=cfg.ssm.chunk, forward_ms=fwd_ms,
                forward_ms_all=fwd_all, flash_launches_per_forward=n_flash,
                flash_share=0.0, flash_launches=launched,
                serve=fam["serve"], requests=fam["requests"],
                prompt_len=fam["prompt_len"], max_new=MAX_NEW,
                contiguous=contiguous)
            emit("families", part="mamba2", **line)
            # the f32 cut: the recurrence (prefill chunks, then decode
            # steps, teacher-forced) against the chunked scan
            api_cut, _, p_cut = f32_cut(api, params)
            del params
            release()
            seq = torch.tensor([prompts[0] + prompts[1][:MAX_NEW]],
                               device=dev)
            want = api_cut.forward(p_cut, {"tokens": seq})[0].float()
            st = api_cut.init_decode_state(1, 1024, dtype=torch.float32,
                                           device=dev)
            P, T = fam["prompt_len"], fam["serve"]["prefill_chunk"]
            got = []
            for c0 in range(0, P, T):
                chunk = seq[:, c0:min(c0 + T, P)]
                lg, _ = api_cut.verify_step(p_cut, st, chunk, c0)
                api_cut.prefill_step(p_cut, st, chunk, c0)
                got.append(lg[0])
            for t in range(P, seq.shape[1]):
                lg, _ = api_cut.decode_step(p_cut, st, seq[:, t:t + 1], t)
                got.append(lg)
            got = torch.cat(got).float()
            rels = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
            d = float((got - want).abs().max())
            if not max(rels) <= SCAN_REL_TOL:
                raise AssertionError(f"{name} f32 cut: recurrence vs scan "
                                     f"rel {max(rels)} > {SCAN_REL_TOL}")
            _, out, _ = drain(api_cut, p_cut, prompts, MAX_NEW,
                              **fam["serve"])
            emit("families", part="mamba2_f32_cut", n_layers=FAMILY_CUT,
                 positions=len(rels), max_rel_l2=max(rels),
                 rel_tol=SCAN_REL_TOL, max_abs_diff=d,
                 greedy=greedy_against_offline(api_cut, p_cut, prompts, out,
                                               d, dev))
            del api_cut, p_cut, st
            release()

            # (c) whisper-medium ---------------------------------------------
            name = "whisper-medium"
            fam = FAMILIES[name]
            cfg, api, params, init = build(name)
            S = fam["fwd_s"]
            toks = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                 device=dev)
            frames = (torch.randn(fam["requests"], cfg.enc_seq, cfg.d_model,
                                  generator=gen, device=dev) * 0.3
                      ).to(torch.bfloat16)
            batch = {"tokens": toks, "frames": frames[:1]}
            enc = encode(params, cfg, frames[:1])
            x = _embed(params, toks) + _sinusoid(S, cfg.d_model,
                                                 torch.bfloat16, dev)
            local = flash_layers(cfg, params, x,
                                 torch.arange(S, device=dev)[None], enc)
            if not max(local) <= LAYER_ATTN_TOL:
                raise AssertionError(f"{name}: flash in the decoder, layer "
                                     f"rel error {max(local)}")
            del enc, x
            prompts = [rng.integers(0, cfg.vocab, fam["prompt_len"]).tolist()
                       for _ in range(fam["requests"])]
            start_path()
            fwd_ms, fwd_all, n_flash = timed_forward(api, params, batch,
                                                     cfg.n_layers)
            _, _, served = drain(api, params, prompts, MAX_NEW,
                                 frames=frames, **fam["serve"])
            launched = end_path()
            line = dict(
                arch=name, reduced=None, params=init["params"],
                weight_bytes=init["weight_bytes"], init_s=init["init_s"],
                S=S, enc_seq=cfg.enc_seq, forward_ms=fwd_ms,
                forward_ms_all=fwd_all,
                plain_forward_ms=plain_forward_ms(api, params, batch),
                flash_launches_per_forward=n_flash,
                flash_share=n_flash * flash[name]["ms"] / fwd_ms,
                flash_launches=launched, attn_rel_l2=local,
                serve=fam["serve"], requests=fam["requests"],
                prompt_len=fam["prompt_len"], max_new=MAX_NEW,
                frames_per_request=True, contiguous=served)
            emit("families", part="whisper", **line)
            api_cut, plain_cut, p_cut = f32_cut(
                api, params, encoder_layers=FAMILY_CUT)
            del params
            release()
            fr32 = frames.float()
            cmp = last_logits(api_cut, plain_cut, p_cut,
                              {"tokens": toks, "frames": fr32[:1]})
            if not cmp["rel_l2"] <= FWD_REL_TOL:
                raise AssertionError(f"{name} f32 cut: flash vs plain rel "
                                     f"{cmp['rel_l2']} > {FWD_REL_TOL}")
            # the decode state keeps the cross K/V in bf16 whatever the
            # params' dtype, as the reference's does; its rounding moves
            # the logits by more than most top-2 gaps of this random
            # model.  So the f32 cut's Server gets f32 buffers of the same
            # shape, and the bf16 state's difference is read beside: the
            # prefill logits at the prompts' last token against the
            # forward's, with each state
            def f32_cross(srv_state):
                srv_state["xattn"] = {k_: torch.zeros_like(
                    v, dtype=torch.float32)
                    for k_, v in srv_state["xattn"].items()}

            toks_p = torch.tensor(prompts, device=dev)
            want = api_cut.forward(p_cut, {"tokens": toks_p,
                                           "frames": fr32})[:, -1].float()
            kv = api_cut.encode_cross_kv(p_cut, fr32)
            d_serve = {}
            for kind in ("bfloat16", "float32"):
                st = api_cut.init_decode_state(
                    len(prompts), fam["serve"]["context"],
                    dtype=torch.float32, device=dev)
                if kind == "float32":
                    f32_cross(st)
                for k_, buf in st["xattn"].items():
                    buf.copy_(kv[k_].to(buf.dtype))
                lg, _ = api_cut.prefill_step(p_cut, st, toks_p, 0)
                d_serve[kind] = float((lg.float() - want).abs().max())
            d = max(cmp["max_abs_diff"], d_serve["float32"])
            del st, kv, lg, want
            _, out, _ = drain(api_cut, p_cut, prompts, MAX_NEW, frames=fr32,
                              prepare=lambda srv: f32_cross(srv.state),
                              **fam["serve"])
            emit("families", part="whisper_f32_cut", n_layers=FAMILY_CUT,
                 encoder_layers=FAMILY_CUT, forward=cmp,
                 serving_max_abs_diff_by_cross_kv_dtype=d_serve,
                 greedy=greedy_against_offline(api_cut, p_cut, prompts, out,
                                               d, dev, {"frames": fr32}))
            del api_cut, plain_cut, p_cut, frames, fr32
            release()

            # (d) mixtral-8x22b, 2 of 56 layers -------------------------------
            name = "mixtral-8x22b"
            fam = FAMILIES[name]
            cfg, api, params, init = build(name, fam["n_layers"])
            S = fam["fwd_s"]
            toks = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                 device=dev)
            local = flash_layers(cfg, params, _embed(params, toks),
                                 torch.arange(S, device=dev)[None])
            if not max(local) <= LAYER_ATTN_TOL:
                raise AssertionError(f"{name}: flash in the model, layer "
                                     f"rel error {max(local)}")
            prompts = [rng.integers(0, cfg.vocab, fam["prompt_len"]).tolist()
                       for _ in range(fam["requests"])]
            start_path()
            fwd_ms, fwd_all, n_flash = timed_forward(api, params,
                                                     {"tokens": toks},
                                                     cfg.n_layers)
            _, _, served = drain(api, params, prompts, MAX_NEW,
                                 **fam["serve"])
            launched = end_path()
            line = dict(
                arch=name, reduced={"n_layers": [56, fam["n_layers"]]},
                params=init["params"], weight_bytes=init["weight_bytes"],
                init_s=init["init_s"], S=S, forward_ms=fwd_ms,
                forward_ms_all=fwd_all,
                plain_forward_ms=plain_forward_ms(api, params,
                                                  {"tokens": toks}),
                flash_launches_per_forward=n_flash,
                flash_share=n_flash * flash[name]["ms"] / fwd_ms,
                flash_launches=launched, attn_rel_l2=local,
                serve=fam["serve"], requests=fam["requests"],
                prompt_len=fam["prompt_len"], max_new=MAX_NEW,
                contiguous=served)
            emit("families", part="mixtral", **line)
            # the f32 cut (the same 2 layers) with no drops: prefill
            # chunks and decode steps against the forward, position by
            # position
            nodrop = dataclasses.replace(cfg.moe,
                                         capacity_factor=MOE_CAPACITY)
            api_cut, _, p_cut = f32_cut(api, params, fam["n_layers"],
                                           moe=nodrop)
            del params
            release()
            seq = torch.tensor([prompts[0][:128]], device=dev)
            L = seq.shape[1]
            want = api_cut.forward(p_cut, {"tokens": seq})[0].float()
            st = api_cut.init_decode_state(1, 256, dtype=torch.float32,
                                           device=dev)
            lg_pre, _ = api_cut.prefill_step(p_cut, st, seq[:, :L - 32], 0)
            got = [lg_pre[0]]
            for t in range(L - 32, L):
                lg, _ = api_cut.decode_step(p_cut, st, seq[:, t:t + 1], t)
                got.append(lg[0])
            got = torch.stack(got).float()
            ref = want[L - 33:]
            rels = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
            if not max(rels) <= MOE_REL_TOL:
                raise AssertionError(f"{name} f32 cut: prefill/decode vs "
                                     f"forward rel {max(rels)}")
            emit("families", part="mixtral_f32_cut",
                 n_layers=fam["n_layers"], capacity_factor=MOE_CAPACITY,
                 positions=len(rels), prefill_rel_l2=rels[0],
                 max_decode_rel_l2=max(rels[1:]), rel_tol=MOE_REL_TOL)
            del api_cut, p_cut, st
            release()

            # (e) llama-3.2-vision-90b, one block -----------------------------
            name = "llama-3.2-vision-90b"
            fam = FAMILIES[name]
            cfg, api, params, init = build(name, fam["n_layers"])
            # a non-zero cross gate, so the cross layer adds to the stream
            params["blocks"]["4_cross"]["gate"].fill_(0.5)
            S = fam["fwd_s"]
            toks = torch.randint(0, cfg.vocab, (1, S), generator=gen,
                                 device=dev)
            img = (torch.randn(1, cfg.n_img_tokens, cfg.d_model,
                               generator=gen, device=dev) * 0.3
                   ).to(torch.bfloat16)
            local = flash_layers(cfg, params, _embed(params, toks),
                                 torch.arange(S, device=dev)[None], img)
            if not max(local) <= LAYER_ATTN_TOL:
                raise AssertionError(f"{name}: flash in the model, layer "
                                     f"rel error {max(local)}")
            prompts = [rng.integers(0, cfg.vocab, fam["prompt_len"]).tolist()
                       for _ in range(fam["requests"])]
            batch = {"tokens": toks, "img_embeds": img}
            start_path()
            fwd_ms, fwd_all, n_flash = timed_forward(api, params, batch, 4)
            _, _, served = drain(api, params, prompts, MAX_NEW,
                                 **fam["serve"])
            launched = end_path()
            line = dict(
                arch=name, reduced={"n_layers": [100, fam["n_layers"]]},
                params=init["params"], weight_bytes=init["weight_bytes"],
                init_s=init["init_s"], S=S, n_img_tokens=cfg.n_img_tokens,
                cross_gate=0.5, forward_ms=fwd_ms, forward_ms_all=fwd_all,
                plain_forward_ms=plain_forward_ms(api, params, batch),
                flash_launches_per_forward=n_flash,
                flash_share=n_flash * flash[name]["ms"] / fwd_ms,
                flash_launches=launched, attn_rel_l2=local,
                serve=fam["serve"], requests=fam["requests"],
                prompt_len=fam["prompt_len"], max_new=MAX_NEW,
                cross_kv="zero (the Server fills no image K/V)",
                contiguous=served)
            emit("families", part="vision", **line)
            del params, img
            release()

            # (f) the serving driver, hymba-1.5b at full width --------------
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       REPRO_TORCH_TUNE_CACHE=str(Path(tmp) / "driver.json"))
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m",
                                   "repro_torch.launch.serve",
                                   *FAMILY_DRIVER], capture_output=True,
                                  text=True, env=env, timeout=600)
            out = proc.stdout.splitlines()
            emit("families", part="driver", argv=FAMILY_DRIVER,
                 rc=proc.returncode, seconds=time.perf_counter() - t0,
                 output=out[-6:], stderr=proc.stderr[-2000:])
            if proc.returncode != 0 or not any(
                    "served 4 requests / 64 tokens" in ln for ln in out):
                raise AssertionError(f"the serving driver on hymba: rc "
                                     f"{proc.returncode}")
        finally:
            set_default_cache(prev)
    torch.cuda.synchronize()
    emit("families", part="phase", seconds=time.perf_counter() - t_phase,
         peak_allocated_bytes=torch.cuda.max_memory_allocated())
    return {"launches": total}


def _train_state_to(state, dev):
    """A train state's tensors on ``dev`` (a copy)."""

    from repro_torch.models.common import tree_map
    to = lambda t: t.to(dev)
    opt = state.opt
    return type(state)(tree_map(to, state.params), type(opt)(
        to(opt.step), tree_map(to, opt.m), tree_map(to, opt.v)),
        None if state.ef_residual is None
        else tree_map(to, state.ef_residual))


def _param_errors(got, want) -> dict:
    """Max abs error over the params, and the share of elements beyond
    ``TRAIN_CUT_TOL``'s atol + rtol."""

    from repro_torch.models.common import tree_leaves
    err_max, n_out, n = 0.0, 0, 0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = w.detach().cpu().float()
        err = (g.detach().cpu().float() - w).abs()
        err_max = max(err_max, float(err.max()))
        n += err.numel()
        n_out += int((err > TRAIN_CUT_TOL["atol"]
                      + TRAIN_CUT_TOL["rtol"] * w.abs()).sum())
    return {"max_abs_err": err_max, "outliers": n_out, "elements": n}


def train(dev, gen, counters, peak_flops: float) -> dict:
    """Phase 13: smollm-135m trained at full width on the card, bf16,
    B = 8, S = 2048 (counts set to 0 just before each path, read just
    after):

    (a) one ``build_train_step`` step of an f32 cut (2 layers) on the card
    against the plain CPU step from the same state, then at full width
    ``microbatches=4`` against ``microbatches=1``;
    (b) the paper's method on training: the (microbatches, remat) points
    of the machine model's one-card lattice (``TRAIN_MB``), 1 warm and 3
    timed steps
    each, measured ms beside ``step_time``'s modeled ms under the active
    spec, their ratio and peak memory (a point that runs out of memory is
    recorded as ``oom``); then the modeled pick, the measured best and
    the pick's rank;
    (c) ``python -m repro_torch.launch.train ... --steps 60 --ckpt-every
    20 --inject-failure 30`` as a subprocess: one restart, the loss
    falls, the last checkpoint read back; tokens/s and 6·N·tokens over
    time over phase 10's measured peak;
    (d) the same with ``--tune --steps 20``: its ``[tune] config:`` line
    is (b)'s modeled pick, which must have fit;
    (e) flash attention under a gradient at smollm's attention shape: the
    kernel launches once, ``backward`` raises.

    Returns the launches of each kernel over (b)-(e)."""

    import gc
    import os
    import re

    import torch
    from repro_torch.calibrate import get_platform_spec
    from repro_torch.checkpoint import available_steps, load_checkpoint
    from repro_torch.checkpoint.store import _flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.tpu_machine import (TPUConfig, TPUWorkload,
                                              hbm_fits, step_time,
                                              tune_distributed)
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime import (TrainConfig, build_train_step,
                                     init_train_state)

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    total = [0] * len(counters)
    fk = counters[-1]

    def start_path():
        for c in counters:
            c.launches = 0

    def end_path():
        for i, c in enumerate(counters):
            total[i] += c.launches

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def finite(tree) -> bool:
        return all(bool(torch.isfinite(t.float()).all())
                   for t in tree_leaves(tree))

    tcfg = dict(lr=TRAIN_LR, warmup=3, total_steps=60)

    # (a) the f32 cut on the card against the plain CPU step ------------
    t0 = time.perf_counter()
    cfg_cut = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_CUT,
                                             logits_dtype="float32")
    api_cut = build_model(cfg_cut)
    tc = TrainConfig(**tcfg)
    host = init_train_state(api_cut, 0, tc, device="cpu")
    host = host._replace(params=tree_map(lambda p: p.float(), host.params))
    card = _train_state_to(host, dev)
    B, S = TRAIN_CUT_SHAPE
    shape = ShapeSpec("cut", S, B, "train")
    step = build_train_step(api_cut, tc)
    got, gm = step(card, SyntheticLM(cfg_cut, shape, device=dev).batch(0))
    want, wm = step(host, SyntheticLM(cfg_cut, shape,
                                      device="cpu").batch(0))
    loss_rel = abs(float(gm["loss"]) - float(wm["loss"])) / \
        abs(float(wm["loss"]))
    errs = _param_errors(got.params, want.params)
    lr1 = float(wm["lr"])
    emit("train", part="step_f32_cut", arch=TRAIN_ARCH,
         reduced={"n_layers": [30, TRAIN_CUT]}, batch=B, seq=S,
         loss_card=float(gm["loss"]), loss_cpu=float(wm["loss"]),
         loss_rel=loss_rel, lr=lr1, tol=TRAIN_CUT_TOL,
         seconds=time.perf_counter() - t0, **errs)
    if loss_rel > TRAIN_CUT_TOL["loss_rel"] or \
            errs["max_abs_err"] > 4 * lr1 or \
            errs["outliers"] > TRAIN_CUT_TOL["outlier_share"] * \
            errs["elements"]:
        raise AssertionError(f"the card's step against the CPU's: loss "
                             f"rel {loss_rel}, {errs}")
    del host, card, got, want, api_cut
    release()

    # full width, bf16: microbatches 4 against 1 -------------------------
    cfg = get_config(TRAIN_ARCH)
    api = build_model(cfg)
    n_params = api.param_count()
    t0 = time.perf_counter()
    state = init_train_state(api, gen, TrainConfig(**tcfg), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = SyntheticLM(cfg, shape, device=dev).batch(0)
    outs = {}
    for m in (1, 4):
        new, met = build_train_step(api, TrainConfig(microbatches=m, **tcfg))(
            state, batch)
        outs[m] = (new.params, float(met["loss"]))
        del new, met
    d_max = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_leaves(outs[1][0]), tree_leaves(outs[4][0])))
    mb_rel = abs(outs[4][1] - outs[1][1]) / abs(outs[1][1])
    emit("train", part="microbatches", arch=TRAIN_ARCH, params=n_params,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype="bfloat16",
         remat=cfg.remat, init_s=init_s, loss_mb1=outs[1][1],
         loss_mb4=outs[4][1], loss_rel=mb_rel, params_max_abs_diff=d_max,
         tol=TRAIN_MB_TOL)
    if mb_rel > TRAIN_MB_TOL["loss_rel"] or \
            d_max >= TRAIN_MB_TOL["params_abs"] or not finite(outs[4][0]):
        raise AssertionError(f"microbatches 4 against 1: loss rel {mb_rel}, "
                             f"params {d_max}")
    del outs
    release()

    # (b) the lattice, measured beside the machine model -----------------
    hbm = float(torch.cuda.get_device_properties(dev).total_memory)
    chips = torch.cuda.device_count()
    w = TPUWorkload(params=n_params, active_params=n_params,
                    layers=cfg.n_layers, d_model=cfg.d_model, seq=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, vocab=cfg.vocab)
    spec = get_platform_spec()
    rows = []
    start_path()
    for remat in TRAIN_REMAT:
        api_r = build_model(cfg.replace(remat=remat))
        for m in TRAIN_MB:
            c = TPUConfig(dp=1, tp=1, microbatches=m, remat=remat)
            row = {"microbatches": m, "remat": remat,
                   "modeled_ms": step_time(w, c)["total"] * 1e3,
                   "modeled_fits": hbm_fits(w, c, hbm_bytes=hbm)}
            step = build_train_step(api_r, TrainConfig(microbatches=m,
                                                       **tcfg))
            release()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            try:
                for _ in range(1 + TRAIN_TIMED):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    new, met = step(state, batch)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    loss = float(met["loss"])
                    del new, met
            except torch.cuda.OutOfMemoryError:
                row["status"] = "oom"
            else:
                row.update(status="ok", warm_ms=ms[0],
                           measured_ms=sorted(ms[1:])[TRAIN_TIMED // 2],
                           timed_ms=ms[1:], loss=loss)
                row["ratio"] = row["measured_ms"] / row["modeled_ms"]
                if not math.isfinite(loss):
                    raise AssertionError(f"train lattice {row}: loss {loss}")
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            release()
            emit("train", part="lattice", card=smi, **row)
            rows.append(row)
    end_path()
    best_cfg, best_dec, _ = tune_distributed(w, chips_per_pod=chips,
                                             hbm_bytes=hbm)
    pick = next(r for r in rows if (r["microbatches"], r["remat"]) ==
                (best_cfg.microbatches, best_cfg.remat))
    ran = sorted((r for r in rows if r["status"] == "ok"),
                 key=lambda r: r["measured_ms"])
    rank = next((i + 1 for i, r in enumerate(ran) if r is pick), None)
    emit("train", part="lattice_pick", card=smi, spec=spec.source,
         chips=chips, hbm_bytes=hbm,
         modeled_pick={"microbatches": best_cfg.microbatches,
                       "remat": best_cfg.remat, "fsdp": best_cfg.fsdp,
                       "modeled_ms": best_dec["total"] * 1e3},
         pick_status=pick["status"],
         measured_best={k: ran[0][k] for k in ("microbatches", "remat",
                                               "measured_ms")},
         pick_rank=rank, of=len(ran),
         ooms=[(r["microbatches"], r["remat"]) for r in rows
               if r["status"] == "oom"],
         ratio_range=[min(r["ratio"] for r in ran),
                      max(r["ratio"] for r in ran)])
    del state, batch
    release()

    # (c) the driver: 60 steps, checkpoints, an injected failure --------
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_TORCH_TUNE_CACHE=str(Path(tmp) / "cache.json"))
        ckpt = str(Path(tmp) / "ckpt")
        argv = TRAIN_DRIVER + ["--steps", "60", "--ckpt-dir", ckpt,
                               "--ckpt-every", "20", "--inject-failure",
                               "30"]
        start_path()
        res = run_cli("repro_torch.launch.train", argv, env,
                      Path(tmp) / "launches.json", timeout=600)
        out = res["out"]
        stats = re.search(r"^steps=(\d+) wall=([\d.]+)s mean_step=([\d.]+)ms"
                          r" restarts=(\d+) stragglers=(\d+)$", out, re.M)
        losses = re.search(r"^loss: first=([\d.]+) last=([\d.]+) "
                           r"min=([\d.]+)$", out, re.M)
        if res["rc"] != 0 or stats is None or losses is None:
            raise AssertionError(f"the training driver: rc {res['rc']}\n"
                                 f"{out[-2000:]}\n{res['err'][-3000:]}")
        for i, n in enumerate(res["launches"].values()):
            total[i] += n
        mean_s = float(stats.group(3)) / 1e3
        first, last = float(losses.group(1)), float(losses.group(2))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        steps = available_steps(ckpt)
        template = init_train_state(api, 0, TrainConfig(), device=dev)
        restored, manifest = load_checkpoint(ckpt, template)
        keys = [k for k, _ in _flatten_with_paths(template)]
        emit("train", part="driver", argv=argv, card=smi,
             seconds=res["seconds"], output=out.splitlines()[-4:],
             restarts=int(stats.group(4)), stragglers=int(stats.group(5)),
             steps_run=int(stats.group(1)), wall_s=float(stats.group(2)),
             mean_step_ms=mean_s * 1e3, loss_first=first, loss_last=last,
             tokens_per_s=tokens / mean_s,
             model_flops_share=6 * n_params * tokens / mean_s / peak_flops,
             peak_flops=peak_flops, checkpoints=steps,
             ckpt_step=manifest["step"], ckpt_keys=len(manifest["keys"]),
             launches=res["launches"])
        if int(stats.group(4)) != 1 or not last < first or \
                manifest["step"] != 60 or steps[-1] != 60 or \
                [e["key"] for e in manifest["keys"]] != keys or \
                int(restored.opt.step) != 60 or not finite(restored.params):
            raise AssertionError(f"the training driver's run: restarts "
                                 f"{stats.group(4)}, loss {first} -> {last},"
                                 f" checkpoints {steps}, step "
                                 f"{manifest['step']}")
        del template, restored
        release()

        # (d) the same with --tune -----------------------------------------
        argv = TRAIN_DRIVER + ["--steps", "20", "--tune"]
        res = run_cli("repro_torch.launch.train", argv, env,
                      Path(tmp) / "launches.json", timeout=600)
        tuned = re.search(r"^\[tune\] config: microbatches=(\d+) "
                          r"remat=(\w+) fsdp=(\w+) modeled step=([\d.]+) "
                          r"ms", res["out"], re.M)
        stats = re.search(r"^steps=20 wall=([\d.]+)s mean_step=([\d.]+)ms",
                          res["out"], re.M)
        if res["rc"] != 0 or tuned is None or stats is None:
            raise AssertionError(f"the driver with --tune: rc {res['rc']}\n"
                                 f"{res['out'][-2000:]}\n"
                                 f"{res['err'][-3000:]}")
        for i, n in enumerate(res["launches"].values()):
            total[i] += n
        end_path()
        picked = (int(tuned.group(1)), tuned.group(2))
        emit("train", part="driver_tune", argv=argv, card=smi,
             seconds=res["seconds"], config_line=tuned.group(0),
             mean_step_ms=float(stats.group(2)),
             measured_in_lattice_ms=pick.get("measured_ms"))
        if picked != (best_cfg.microbatches, best_cfg.remat) or \
                pick["status"] != "ok":
            raise AssertionError(f"--tune picked {picked}; the lattice's "
                                 f"modeled pick {best_cfg} ran "
                                 f"{pick['status']}")

    # (e) flash under a gradient -------------------------------------------
    start_path()
    q, k, v = (torch.randn(FLASH_GRAD_SHAPE, generator=gen, device=dev
                           ).to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    o = flash_attention(q, k, v, causal=True, block_q=128, block_k=64)
    launched = fk.launches
    try:
        o.float().sum().backward()
    except RuntimeError as e:
        raised = str(e)
    else:
        raise AssertionError("backward through the flash kernel did not "
                             "raise")
    end_path()
    emit("train", part="flash_under_grad", shape=FLASH_GRAD_SHAPE,
         launches=launched, requires_grad=o.requires_grad, raised=raised)
    if launched != 1 or "no backward" not in raised:
        raise AssertionError(f"flash under grad: {launched} launches, "
                             f"{raised!r}")
    del q, k, v, o
    release()
    emit("train", part="phase", seconds=time.perf_counter() - t_phase)
    return {"launches": total, "lattice": rows}


def _dryrun_jobs(tmp: Path) -> list:
    """Phase 14(c)'s dry-run cells, longest first: every arch's shapes on
    the single-pod mesh and qwen3-32b's train_4k on the multi-pod mesh
    (the other families' multi-pod cells, 337 s of the host's work,
    would add ~50 s to the phase: the whole matrix runs through
    ``tools/dryrun_matrix.py`` instead)."""

    from repro_torch.configs import SHAPES
    jobs = []
    for arch in DIST_DENSE + DIST_OTHERS:
        for shape in SHAPES:
            jobs.append((arch, shape, "--single-pod"))
    jobs.append((*DIST_MULTI, "--multi-pod"))
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    big = {a: i for i, a in enumerate(reversed(DIST_DENSE))}
    jobs.sort(key=lambda j: (order[j[1]], j[2] != "--multi-pod",
                             big.get(j[0], len(big))))
    return [(a, sh, mp, tmp / f"{a}-{sh}{mp}.json") for a, sh, mp in jobs]


def _start_dryrun(jobs: list, workers: int) -> dict:
    """Run ``python -m repro_torch.launch.dryrun`` for each job, at most
    ``workers`` at a time, in the background; :func:`_finish_dryrun`
    waits for them."""

    import os
    import threading
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    state = {"walls": {}, "errors": {}}

    def run(job):
        arch, shape, mesh, out = job
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, mesh, "--no-blocks", "--microbatches",
             str(DIST_MICROBATCHES), "--out", str(out)],
            capture_output=True, text=True, cwd=ROOT, env=env, timeout=900)
        state["walls"][job[:3]] = time.perf_counter() - t0
        if not out.exists():
            state["errors"][job[:3]] = proc.stderr[-2000:]

    pending = list(jobs)
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                if not pending:
                    return
                job = pending.pop(0)
            run(job)

    state["threads"] = [threading.Thread(target=worker, daemon=True)
                        for _ in range(workers)]
    for t in state["threads"]:
        t.start()
    return state


def _finish_dryrun(state: dict, jobs: list, smi: str) -> dict:
    from repro_torch.calibrate.spec import DEFAULT_SPEC
    from repro_torch.configs import SHAPES, get_config, supports
    from repro_torch.launch.roofline import analyze

    for t in state["threads"]:
        t.join()
    if state["errors"]:
        raise AssertionError(f"dry-run processes wrote no record: "
                             f"{state['errors']}")
    rows, failed = [], []
    for arch, shape, mesh, out in jobs:
        [rec] = json.loads(out.read_text())
        r = analyze(rec, spec=DEFAULT_SPEC)
        row = {"arch": arch, "shape": shape, "mesh": rec["mesh"],
               "status": rec["status"], "reason": rec["reason"][:300],
               "wall_s": state["walls"][(arch, shape, mesh)],
               "run_s": rec["lower_s"]}
        if rec["status"] == "ok":
            row.update(compute_ms=r.compute_s * 1e3,
                       memory_ms=r.memory_s * 1e3,
                       collective_ms=r.collective_s * 1e3,
                       dominant=r.dominant, useful=r.useful_ratio,
                       mfu=r.mfu, peak_gib=r.peak_hbm_gib,
                       flops_per_dev=rec["cost"]["flops"],
                       bytes_per_dev=rec["cost"]["bytes_accessed"],
                       coll_bytes_per_dev=rec["collectives"]["total_bytes"],
                       microbatches=rec["settings"]["microbatches"])
        emit("distributed", part="dryrun", spec="H100 data sheet",
             card=smi, **row)
        rows.append(row)
        # a cell fails the phase unless it ran, or was skipped where
        # configs.supports says it is
        ok, _ = supports(get_config(arch), SHAPES[shape])
        if rec["status"] != ("ok" if ok else "skipped"):
            failed.append((arch, shape, mesh, rec["status"], rec["reason"]))
    if failed:
        raise AssertionError(f"dry-run cells failed: {failed}")
    return {"rows": rows}


def _mesh_inputs(cfg, B: int, S: int, gen, dev) -> dict:
    """Tokens (B, S), plus bf16 frames (enc-dec) or image embeddings
    (vlm) at scale 0.3, from ``gen``."""

    import torch
    out = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                   device=dev)}
    if cfg.is_encdec:
        out["frames"] = (torch.randn(B, cfg.enc_seq, cfg.d_model,
                                     generator=gen, device=dev) * 0.3
                         ).to(torch.bfloat16)
    if cfg.family == "vlm":
        out["img_embeds"] = (torch.randn(B, cfg.n_img_tokens, cfg.d_model,
                                         generator=gen, device=dev) * 0.3
                             ).to(torch.bfloat16)
    return out


def on_mesh(api, params, mesh, counters, total, gen, dev, *, fwd_s: int,
            batch: int, context: int, n_flash: int, smi: str) -> dict:
    """One model's ``forward`` and ``decode_step`` on ``mesh`` against
    the unsharded ones from the same params (phase 14(a) for any family):
    the forward at S = ``fwd_s`` (flash launches counted, ``n_flash``
    wanted), its last-token logits within DIST_LOGITS_REL; a decode step
    of ``batch`` slots over ``context`` (8 rows of history; whisper's
    cross K/V from ``encode_cross_kv``), the logits within the same bound
    and every leaf of the written state equal; each timed beside the
    unsharded.  Adds each kernel's launches to ``total``."""

    import torch
    from repro_torch.distribute.sharding import place, shard_like, use_mesh
    from repro_torch.launch.cells import batch_axes, rules_for_arch
    from repro_torch.models.common import axes_tree, tree_leaves, tree_map

    cfg = api.cfg
    rules = rules_for_arch(cfg)
    flash = counters[-1]
    axes = batch_axes(cfg, None)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    rel = lambda a, b: float((a.float() - b.float()).norm()
                             / b.float().norm())

    def placed(tree, ax):
        return place(tree, shard_like(tree, ax, mesh, rules))

    inp = _mesh_inputs(cfg, 1, fwd_s, gen, dev)
    out: dict = {"arch": cfg.name, "S": fwd_s}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        fwd = lambda: api.forward(params, inp)
        want = fwd()[0, -1].float()
        out["plain_ms"] = time_ms(fwd, 3, warmup=1)
        out["plain_peak_bytes"] = torch.cuda.max_memory_allocated()
        before = torch.cuda.memory_allocated()
        with use_mesh(mesh, rules):
            pm = placed(params, api.axes())
            out["placed_bytes"] = torch.cuda.memory_allocated() - before
            im = placed(inp, {k: axes[k] for k in inp})
            mfwd = lambda: api.forward(pm, im)
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            got = mfwd()
            launched = flash.launches
            for i, c in enumerate(counters):
                total[i] += c.launches
            got = full(got)[0, -1].float()
            out["mesh_ms"] = time_ms(mfwd, 3, warmup=1)
            out["mesh_peak_bytes"] = torch.cuda.max_memory_allocated()
        out.update(flash_launches=launched, rel_l2=rel(got, want),
                   bit_equal=bool(torch.equal(got, want)),
                   max_abs_diff=float((got - want).abs().max()))
        if launched != n_flash or not out["rel_l2"] <= DIST_LOGITS_REL:
            raise AssertionError(f"{cfg.name} forward on the mesh: "
                                 f"{launched} flash launches (want "
                                 f"{n_flash}), rel L2 {out['rel_l2']}")
        del got, want, im

        # decode: every slot at position 8 after 8 rows of history
        B, C = batch, context
        state = api.init_decode_state(B, C, device=dev)
        toks = _mesh_inputs(cfg, B, 9, gen, dev)
        if cfg.is_encdec:
            xkv = api.encode_cross_kv(params, toks["frames"])
            for n in ("k", "v"):
                state["xattn"][n].copy_(xkv[n])
            del xkv
        for t in range(8):
            api.decode_step(params, state, toks["tokens"][:, t:t + 1], t)
        cur = torch.full((B,), 8, device=dev)
        tok1 = toks["tokens"][:, 8:9].contiguous()
        st_mesh = tree_map(lambda t: t.clone(), state)
        want, _ = api.decode_step(params, state, tok1, cur)
        after = tree_leaves(tree_map(lambda t: t.clone(), state))
        out["decode_plain_ms"] = time_ms(
            lambda: api.decode_step(params, state, tok1, cur), 10)
        dspecs = api.decode_state_specs(B, C)
        with use_mesh(mesh, rules):
            sd = placed(st_mesh, axes_tree(dspecs))
            t1 = placed(tok1, ("batch", None))
            c1 = placed(cur, ("batch",))
            got, _ = api.decode_step(pm, sd, t1, c1)
            got = full(got).float()
            diffs = [float((full(a).float() - b.float()).abs().max())
                     if a.numel() else 0.0
                     for a, b in zip(tree_leaves(sd), after)]
            state_equal = all(bool(torch.equal(full(a), b))
                              for a, b in zip(tree_leaves(sd), after))
            out["decode_mesh_ms"] = time_ms(
                lambda: api.decode_step(pm, sd, t1, c1), 10)
        out.update(batch=B, context=C, decode_rel_l2=rel(got, want),
                   decode_bit_equal=bool(torch.equal(got, want.float())),
                   state_bit_equal=state_equal,
                   state_max_abs_diff=max(diffs), card=smi,
                   tol=DIST_LOGITS_REL)
        if not out["decode_rel_l2"] <= DIST_LOGITS_REL or not state_equal:
            raise AssertionError(f"{cfg.name} decode on the mesh: rel L2 "
                                 f"{out['decode_rel_l2']}, state equal "
                                 f"{state_equal} (max diff {max(diffs)})")
        del pm, sd, st_mesh, state, after, got, want
    return out


def distributed(dev, counters, trained: dict) -> dict:
    """Phase 14: the sharded paths on the card and the dry run on its
    host (counts set to 0 just before each main path, read just after):

    (a) a 1x1 NCCL mesh (``init_process_group("nccl")``, world size 1)
    and qwen1.5-4b at full width and depth in bf16 from seed 0, its
    params placed by ``shard_like`` under ``use_mesh``: a ``forward`` at
    S = 4096 through the flash kernel under ``local_map`` (40 launches,
    counted), its last-token logits held to the unsharded ``forward``'s,
    and a ``decode_step`` at B = 4 over a 1,024 context against the
    unsharded one, each timed beside the unsharded;
    (b) smollm-135m at full width, B = 8, S = 2048, remat full: state,
    optimizer and batch as DTensors on the mesh, 3 steps against 3
    unsharded steps from the same state (step ms and peak memory beside
    phase 13's lattice point), then ``save_checkpoint`` from the mesh and
    ``load_checkpoint`` onto it, bit-equal;
    (c) ``python -m repro_torch.launch.dryrun`` as subprocesses, run in
    the background from the phase's start: all ten archs × the four
    shapes on the 16 × 16 mesh, qwen3-32b's train_4k on 2 × 16 × 16,
    train cells at one microbatch; each record
    priced by ``analyze`` on the H100 data sheet; a cell that fails, or
    is skipped where ``configs.supports`` does not say so, fails the
    phase;
    (d) ``lower_cell`` on a fake 1 × 1 group at (b)'s shape: its
    ``peak_hbm_bytes`` within 25 % of (b)'s measured peak;
    (e) hymba-1.5b, mamba2-2.7b and whisper-medium whole, mixtral-8x22b
    at 2 layers and llama-3.2-vision-90b at one block, bf16 from seed 0
    on the mesh (:func:`on_mesh`): the forward at phase 12's S, flash
    under ``local_map`` (32, 0, 24, 2 and 4 launches), and a decode step
    at phase 12's serve batch over a 1,024 context, against the
    unsharded ones;
    (f) llama4-maverick at one block (a dense and a 128-expert MoE
    layer, ~37 GB of bf16 weights drawn in slices): each layer's
    attention through flash at (1, 40, 4096, 128) causal against the
    plain math, the forward's logits against the plain forward's, then
    :func:`on_mesh` at S = 4096 and B = 2, with its peak memory.

    Returns the launches of each kernel over the main paths of (a), (b),
    (e) and (f)."""

    import gc
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLM
    from repro_torch.distribute.sharding import place, shard_like, use_mesh
    from repro_torch.launch.cells import lower_cell, rules_for_arch
    from repro_torch.launch.mesh import fake_world, make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import axes_tree, tree_leaves, tree_map
    from repro_torch.models.transformer import _embed
    from repro_torch.optim.adamw import OptState
    from repro_torch.runtime import (TrainConfig, TrainState,
                                     build_train_step, init_train_state)
    from repro_torch.tune import TuningCache, set_default_cache

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    total = [0] * len(counters)
    flash = counters[-1]
    tmp = Path(tempfile.mkdtemp(prefix="phase14-"))
    jobs = _dryrun_jobs(tmp)
    workers = max(1, (os.cpu_count() or 2) - 1)
    pool = _start_dryrun(jobs, workers)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            rank=0, world_size=1)
    prev = set_default_cache(TuningCache(tmp / "tune_cache.json"))
    try:
        mesh = make_smoke_mesh()
        emit("distributed", part="mesh", backend=dist.get_backend(),
             mesh=dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
             device_type=mesh.device_type, workers=workers, cells=len(jobs))

        # (a) serving on the mesh --------------------------------------
        cfg = get_config(MODEL)
        api = build_model(cfg)
        rules = rules_for_arch(cfg)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        params = api.init(g, device=dev)
        toks = torch.randint(0, cfg.vocab, (1, FWD_S), generator=g,
                             device=dev)
        with torch.no_grad():
            fwd = lambda: api.forward(params, {"tokens": toks})
            want = fwd()[0, -1].float()
            plain_ms = time_ms(fwd, 3, warmup=1)
            with use_mesh(mesh, rules):
                pm = place(params, shard_like(params, api.axes(), mesh,
                                              rules))
                tk = place(toks, shard_like(toks, ("batch", "seq"), mesh,
                                            rules))
                mfwd = lambda: api.forward(pm, {"tokens": tk})
                for c in counters:
                    c.launches = 0
                got = mfwd()
                launched = flash.launches
                for i, c in enumerate(counters):
                    total[i] += c.launches
                got = full(got)[0, -1].float()
                mesh_ms = time_ms(mfwd, 3, warmup=1)
            r_fwd = rel(got, want)
            emit("distributed", part="forward", arch=MODEL, S=FWD_S,
                 placements=str(pm["blocks"]["0_dense"]["attn"]["wq"]
                                .placements),
                 flash_launches=launched, rel_l2=r_fwd,
                 bit_equal=bool(torch.equal(got, want)),
                 max_abs_diff=float((got - want).abs().max()),
                 mesh_ms=mesh_ms, plain_ms=plain_ms, card=smi,
                 tol=DIST_LOGITS_REL)
            if launched != cfg.n_layers or not r_fwd <= DIST_LOGITS_REL:
                raise AssertionError(f"forward on the mesh: {launched} flash "
                                     f"launches, rel L2 {r_fwd}")
            del got, want, tk
            release()

            # decode: B slots at per-slot positions over a 1,024 context
            B, C = SERVE["batch"], SERVE["context"]
            state = api.init_decode_state(B, C, device=dev)
            for t in range(8):      # a few rows of history in every ring
                api.decode_step(params, state, toks[:, t:t + 1].expand(
                    B, 1), t)
            cur = torch.tensor([8, 8, 8, 8], device=dev)
            tok1 = toks[:, 8:9].expand(B, 1).contiguous()
            st_mesh = tree_map(lambda t: t.clone(), state)
            want, _ = api.decode_step(params, state, tok1, cur)
            dplain_ms = time_ms(lambda: api.decode_step(params, state, tok1,
                                                        cur), 10)
            dspecs = api.decode_state_specs(B, C)
            with use_mesh(mesh, rules):
                sd = place(st_mesh, shard_like(st_mesh, axes_tree(dspecs),
                                               mesh, rules))
                t1 = place(tok1, shard_like(tok1, ("batch", None), mesh,
                                            rules))
                c1 = place(cur, shard_like(cur, ("batch",), mesh, rules))
                got, _ = api.decode_step(pm, sd, t1, c1)
                got = full(got).float()
                kv_equal = all(bool(torch.equal(
                    full(sd["blocks"]["0_dense"]["kv"][n]),
                    state["blocks"]["0_dense"]["kv"][n])) for n in ("k", "v"))
                dmesh_ms = time_ms(lambda: api.decode_step(pm, sd, t1, c1),
                                   10)
            r_dec = rel(got, want.float())
            emit("distributed", part="decode", arch=MODEL, batch=B,
                 context=C, rel_l2=r_dec,
                 bit_equal=bool(torch.equal(got, want.float())),
                 kv_bit_equal=kv_equal, mesh_ms=dmesh_ms,
                 plain_ms=dplain_ms, card=smi, tol=DIST_LOGITS_REL)
            if not r_dec <= DIST_LOGITS_REL or not kv_equal:
                raise AssertionError(f"decode on the mesh: rel L2 {r_dec}, "
                                     f"K/V equal {kv_equal}")
        del params, pm, state, st_mesh, sd, got, want, api
        release()

        # (b) training on the mesh -------------------------------------
        tcfg = TrainConfig(lr=TRAIN_LR, warmup=3, total_steps=60)
        cfg = get_config(TRAIN_ARCH)
        api = build_model(cfg)
        rules = rules_for_arch(cfg)
        g.manual_seed(0)
        state = init_train_state(api, g, tcfg, device=dev)
        shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        data = SyntheticLM(cfg, shape, device=dev)
        batches = [data.batch(i) for i in range(DIST_STEPS)]
        step = build_train_step(api, tcfg)

        def run_steps(st, bs):
            release()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = [], []
            for b in bs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, met = step(st, b)
                losses.append(float(met["loss"]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return st, losses, ms, torch.cuda.max_memory_allocated()

        ax = api.axes()
        st_ax = TrainState(params=ax, opt=OptState(step=(), m=ax, v=ax),
                           ef_residual=None)
        with use_mesh(mesh, rules):
            st0 = place(state, shard_like(state, st_ax, mesh, rules))
            bm = [place(b, shard_like(b, {"tokens": ("batch", "seq"),
                                          "labels": ("batch", "seq")},
                                      mesh, rules)) for b in batches]
        _, plain_losses, plain_ms, plain_peak = run_steps(state, batches)
        del state
        with use_mesh(mesh, rules):
            for c in counters:
                c.launches = 0
            st, losses, ms, peak = run_steps(st0, bm)
            for i, c in enumerate(counters):
                total[i] += c.launches
            del st0
            ckpt = tmp / "ckpt"
            save_checkpoint(str(ckpt), DIST_STEPS, st)
            back, manifest = load_checkpoint(str(ckpt), st)
            equal = all(bool(torch.equal(full(a), full(b))) for a, b in zip(
                tree_leaves(st.params) + tree_leaves(st.opt.m),
                tree_leaves(back.params) + tree_leaves(back.opt.m))) and \
                int(full(back.opt.step)) == DIST_STEPS
            placed = str(back.params["embed"].placements)
        p13 = next((r for r in trained["lattice"] if r["remat"] == "full"
                    and r["microbatches"] == 1), {})
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           plain_losses))
        emit("distributed", part="train", arch=TRAIN_ARCH,
             batch=TRAIN_BATCH, seq=TRAIN_SEQ, remat=cfg.remat,
             losses=losses, plain_losses=plain_losses, loss_rel=loss_rel,
             step_ms=ms, plain_step_ms=plain_ms, peak_bytes=peak,
             plain_peak_bytes=plain_peak,
             phase13_ms=p13.get("measured_ms"),
             phase13_peak_bytes=p13.get("peak_bytes"),
             ckpt_bit_equal=equal, ckpt_step=manifest["step"],
             restored_placements=placed, card=smi, tol=DIST_LOSS_REL)
        if not loss_rel <= DIST_LOSS_REL or not equal:
            raise AssertionError(f"training on the mesh: loss rel "
                                 f"{loss_rel}, checkpoint equal {equal}")
        del st, back, bm, batches, api
        release()

        # (e) the other families on the mesh ---------------------------
        for name, n_flash in DIST_FAMILY_FLASH.items():
            fam = FAMILIES[name]
            cfg = get_config(name).replace(use_flash=True)
            if "n_layers" in fam:
                cfg = cfg.replace(n_layers=fam["n_layers"])
            api = build_model(cfg)
            g.manual_seed(0)
            params = api.init(g, device=dev)
            row = on_mesh(api, params, mesh, counters, total, g, dev,
                          fwd_s=fam["fwd_s"], batch=fam["serve"]["batch"],
                          context=fam["serve"]["context"], n_flash=n_flash,
                          smi=smi)
            emit("distributed", part="family", reduced={
                "n_layers": [get_config(name).n_layers, cfg.n_layers]},
                **row)
            del params, api
            release()

        # (f) llama4-maverick at one block -----------------------------
        mv = MAVERICK_BLOCK
        cfg = get_config(MAVERICK).replace(use_flash=True,
                                           n_layers=mv["n_layers"])
        api = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g.manual_seed(0)
        params = api.init(g, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
        init_peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            toks = torch.randint(0, cfg.vocab, (1, mv["fwd_s"]),
                                 generator=g, device=dev)
            pos = torch.arange(mv["fwd_s"], device=dev)[None]
            layers = flash_layers(cfg, params, _embed(params, toks), pos)
            plain = build_model(cfg.replace(use_flash=False))
            got = api.forward(params, {"tokens": toks})[0, -1].float()
            want = plain.forward(params, {"tokens": toks})[0, -1].float()
            e2e = rel(got, want)
            del got, want, plain
        if not max(layers) <= LAYER_ATTN_TOL or not e2e <= FWD_REL_TOL:
            raise AssertionError(f"{MAVERICK}: flash against plain, layer "
                                 f"rel {layers}, logits rel {e2e}")
        release()
        row = on_mesh(api, params, mesh, counters, total, g, dev,
                      fwd_s=mv["fwd_s"], batch=mv["batch"],
                      context=mv["context"], n_flash=mv["n_layers"],
                      smi=smi)
        emit("distributed", part="maverick", reduced={
            "n_layers": [get_config(MAVERICK).n_layers, cfg.n_layers]},
            params=api.param_count(), weight_bytes=weights, init_s=init_s,
            init_peak_bytes=init_peak, attn_rel_l2=layers,
            flash_vs_plain_logits_rel_l2=e2e,
            flash_tol=[LAYER_ATTN_TOL, FWD_REL_TOL], **row)
        del params, api
        release()
    finally:
        set_default_cache(prev)
        dist.destroy_process_group()

    # (d) the dry run's memory at (b)'s shape on a fake 1 x 1 group ------
    SHAPES["phase14_train"] = ShapeSpec("phase14_train", TRAIN_SEQ,
                                        TRAIN_BATCH, "train")
    try:
        with fake_world(1):
            rec = lower_cell(TRAIN_ARCH, "phase14_train",
                             mesh=make_smoke_mesh((1, 1)), tcfg=tcfg,
                             remat="full")
    finally:
        del SHAPES["phase14_train"]
    if rec.status != "ok":
        raise AssertionError(f"the dry run at (b)'s shape: {rec.reason}")
    dry_peak = rec.memory["peak_hbm_bytes"]
    peak_rel = abs(dry_peak - peak) / peak
    emit("distributed", part="dryrun_memory", arch=TRAIN_ARCH,
         dry_peak_bytes=dry_peak, measured_peak_bytes=peak,
         rel=peak_rel, memory=rec.memory, run_s=rec.lower_s,
         tol=DIST_PEAK_REL, card=smi)
    if not peak_rel <= DIST_PEAK_REL:
        raise AssertionError(f"dry-run peak {dry_peak} against measured "
                             f"{peak}: {peak_rel}")

    # (c) the dry run ---------------------------------------------------
    t0 = time.perf_counter()
    cells = _finish_dryrun(pool, jobs, smi)
    emit("distributed", part="phase", seconds=time.perf_counter() - t_phase,
         dryrun_wait_s=time.perf_counter() - t0)
    return {"launches": total, "cells": cells["rows"]}


def _load_example(name: str):
    """``examples/torch_<name>.py`` as a module (importing runs nothing)."""

    import importlib.util
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _one_line(out: str, pattern: str) -> "re.Match":
    import re
    found = re.findall(pattern, out, re.M)
    if len(found) != 1:
        raise AssertionError(f"want one line matching {pattern!r}: "
                             f"{len(found)} in\n{out[-3000:]}")
    return re.search(pattern, out, re.M)


def examples(dev, counters, fitted) -> dict:
    """Phase 15: the six torch twins of ``examples/*.py``, each with a
    tuning cache and a platform spec of its own in a temporary directory
    (the fleet's spec is phase 10's fitted artifact, so its
    ``[calibrate]`` loads).  (a) each twin's ``main`` in-process at the
    reference example's arguments, its output checked as the CPU tests
    check it: the model checker's counts and picks, the abstract
    platform's pick and the swarm check, the reduction's pick against
    its cost model and its result against its plain version, the
    fleet's 12 jobs, 12 shipped, the node's matmul from its cache and 12
    hits, the serving driver's 10 requests / 60 tokens in 18 ticks
    contiguous and paged, the training driver's 220 steps with one
    restart, the distributed picks against ``tune_distributed``; (b)
    ``python examples/torch_autotune_minimum.py`` as a subprocess, as a
    user runs it, loading no ``jax`` and no ``repro`` module (``-X
    importtime``); (c) the serving twin with ``--preset full``
    (qwen3-32b whole, contiguous then paged: the memory allocated before
    each driver run, its peak, ticks and tokens/s) and the training twin
    with ``--preset full`` (smollm-135m at full width).  The launches
    returned are (a)'s and (c)'s."""

    import contextlib
    import dataclasses
    import gc
    import io
    import os
    import re

    import torch
    from repro_torch.calibrate import DEFAULT_SPEC, set_platform_spec
    from repro_torch.core.tpu_machine import (tune_distributed,
                                              workload_from_arch)
    from repro_torch.kernels.tuned_reduction.ops import (cost_model,
                                                         tuning_space)
    from repro_torch.tune import set_default_cache

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    total = [0] * len(counters)
    ri, mi = 0, 2                      # the reduction's and matmul's rows
    prev_env = {k: os.environ.get(k) for k in ("REPRO_TORCH_PLATFORM_SPEC",
                                                "REPRO_TORCH_TUNE_CACHE")}

    def run(twin, argv, tmp, tag, wrap=None):
        """``main(argv)`` of a twin on its own cache and spec, its output
        captured; returns (output, seconds, launches, main's value)."""

        os.environ["REPRO_TORCH_TUNE_CACHE"] = str(tmp / f"{tag}.json")
        os.environ["REPRO_TORCH_PLATFORM_SPEC"] = str(tmp / f"{tag}.spec.json")
        if twin == "fleet_rollout":
            fitted.save(tmp / f"{tag}.spec.json")
        prev_cache = set_default_cache(None)
        prev_spec = set_platform_spec(None)
        module = _load_example(twin)
        if wrap is not None:
            wrap(module)
        for c in counters:
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                value = module.main(argv)
            torch.cuda.synchronize()
        finally:
            set_default_cache(prev_cache)
            set_platform_spec(prev_spec)
        seconds = time.perf_counter() - t0
        launches = [c.launches for c in counters]
        for i, n in enumerate(launches):
            total[i] += n
        return buf.getvalue(), seconds, launches, value

    def line(part, twin, argv, out, seconds, launches, **extra):
        emit("examples", part=part, twin=f"examples/torch_{twin}.py",
             argv=argv, seconds=seconds,
             launches=dict(zip(("tuned_reduction", "sweep_eval",
                                "matmul_tuned", "flash_attention"),
                               launches)),
             output=out.splitlines()[-24:], card=smi, **extra)

    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            # (a) each twin at the reference example's arguments --------
            outs = {}
            for twin in EXAMPLE_TWINS:
                out, seconds, launches, value = run(twin, [], tmp, twin)
                outs[twin] = (out, value)
                line("a", twin, [], out, seconds, launches)

            out = outs["quickstart"][0]
            for want in ("terminates at time 69 (explored 98 states)",
                         "engine=explorer  T_min=  24 config={'WG': 16, "
                         "'TS': 4}",
                         "engine=swarm     T_min=  24 config={'WG': 16, "
                         "'TS': 4}",
                         "engine=sweep     T_min=  24 config={'WG': 4, "
                         "'TS': 4}",
                         "(trail of 131 transitions replays OK)",
                         "(hit, stats={'hits': 1, 'misses': 1, "
                         "'entries': 1})"):
                if want not in out:
                    raise AssertionError(f"quickstart: no {want!r}\n{out}")

            out = outs["autotune_minimum"][0]
            _one_line(out, r"^abstract platform: optimal WG=128 TS=8192 "
                           r"model_time=131224 ")
            _one_line(out, r"^swarm sanity \(size=64\): swarm t=276 vs "
                           r"exhaustive t=276$")
            m = _one_line(out, r"^reduction kernel: WG=(\d+) TS=(\d+) ")
            pick = {"WG": int(m.group(1)), "TS": int(m.group(2))}
            n = 1 << 20
            if cost_model(pick, n=n) != min(cost_model(c, n=n)
                                            for c in tuning_space(n)):
                raise AssertionError(f"reduction pick {pick} is not the "
                                     f"cost model's argmin")
            _one_line(out, rf"^tuned kernel result (-?\d+) == plain \1  ✓ "
                           rf"\(WG={pick['WG']} TS={pick['TS']} from "
                           rf"cache\)$")

            out = outs["fleet_rollout"][0]
            if not out.startswith(f"[calibrate] loaded cuda/{name} ") or \
                    sorted(map(int, re.findall(r"\[(\d+)/12\] ", out))) != \
                    list(range(1, 13)):
                raise AssertionError(f"fleet warm-up:\n{out}")
            for pat in (r"12 jobs — 0 hits, 12 tuned, 0 forced, 0 failed$",
                        r"^shipped 12 entries; node merged 12 added / 0 "
                        r"kept ",
                        r"from cache with 0 engine runs "
                        r"\(result\[0,0\]=128\.0\)$",
                        r"^re-warmup on node: .* 12 jobs — 12 hits, 0 "
                        r"tuned, 0 forced, 0 failed$"):
                _one_line(out, pat)

            out = outs["serve_batch"][0]
            served = re.findall(r"^served 10 requests / 60 tokens in 18 "
                                r"engine ticks, ", out, re.M)
            if len(served) != 2:
                raise AssertionError(f"serve_batch:\n{out}")
            _one_line(out, r"^  paged kv: page=8 pool=32 pages peak_used=8 "
                           r"peak_active=4 deferrals=0$")

            out = outs["train_smollm"][0]
            _one_line(out, r"^\[tune\] config: microbatches=\d+ remat=\w+ ")
            _one_line(out, r"^\[inject\] simulated pod failure at step 120$")
            _one_line(out, r"^steps=220 wall=[\d.]+s mean_step=[\d.]+ms "
                           r"restarts=1 ")

            # the twin priced the data sheet (its spec path holds no
            # calibration)
            cells = outs["tune_distributed"][1]
            prev_spec = set_platform_spec(DEFAULT_SPEC)
            try:
                for cell in cells:
                    best, _, _ = tune_distributed(
                        workload_from_arch(cell["arch"], "train_4k"),
                        chips_per_pod=256, pods=cell["pods"])
                    if cell["config"] != best:
                        raise AssertionError(
                            f"tune_distributed {cell['arch']}: "
                            f"{cell['config']} against {best}")
            finally:
                set_platform_spec(prev_spec)
            emit("examples", part="a_checks", twins=len(EXAMPLE_TWINS),
                 reduction_pick=pick,
                 distributed={c["arch"]: dataclasses.asdict(c["config"])
                              for c in cells})
            if total[ri] <= 0 or total[mi] <= 0:
                raise AssertionError(f"(a) launched the reduction "
                                     f"{total[ri]} and the matmul "
                                     f"{total[mi]} times")

            # (b) one twin as a user runs it ----------------------------
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       REPRO_TORCH_TUNE_CACHE=str(tmp / "user.json"),
                       REPRO_TORCH_PLATFORM_SPEC=str(tmp / "user.spec.json"))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-X", "importtime",
                 "examples/torch_autotune_minimum.py"],
                capture_output=True, text=True, cwd=ROOT, env=env,
                timeout=600)
            imported = [ln.rsplit("|", 1)[-1].strip()
                        for ln in proc.stderr.splitlines()
                        if ln.startswith("import time:")]
            bad = [m for m in imported
                   if m.split(".")[0] in ("jax", "ml_dtypes", "repro")]
            emit("examples", part="b", rc=proc.returncode,
                 seconds=time.perf_counter() - t0,
                 argv=["python", "examples/torch_autotune_minimum.py"],
                 modules_imported=len(imported), jax_or_repro=bad,
                 output=proc.stdout.splitlines()[-8:], card=smi)
            if proc.returncode != 0 or bad or not imported or \
                    "from cache)" not in proc.stdout:
                raise AssertionError(f"the twin as a subprocess: rc "
                                     f"{proc.returncode}, {bad}\n"
                                     f"{proc.stderr[-3000:]}")

            # (c) the two driver twins at full width --------------------
            gc.collect()
            torch.cuda.empty_cache()
            runs = []

            def wrap_serve(module):
                inner = module.serve_main

                def serve_main(argv):
                    gc.collect()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    before = torch.cuda.memory_allocated()
                    inner(argv)
                    torch.cuda.synchronize()
                    runs.append({"paged": "--paged" in argv,
                                 "allocated_before_bytes": before,
                                 "peak_bytes":
                                     torch.cuda.max_memory_allocated()})
                module.serve_main = serve_main

            out, seconds, launches, _ = run("serve_batch", FULL, tmp,
                                            "serve_full", wrap_serve)
            models = re.findall(r"^model (\S+) \(full\): ([\d,]+) "
                                r"parameters on cuda\S*, set up in "
                                r"([\d.]+)s$", out, re.M)
            drains = re.findall(r"^served (\d+) requests / (\d+) tokens in "
                                r"(\d+) engine ticks, ([\d.]+)s "
                                r"\(([\d.]+) tok/s\)$", out, re.M)
            for r, (arch, params, init_s), (reqs, toks, ticks, wall, rate) \
                    in zip(runs, models, drains):
                r.update(arch=arch, params=int(params.replace(",", "")),
                         init_s=float(init_s), requests=int(reqs),
                         tokens=int(toks), ticks=int(ticks),
                         wall_s=float(wall), tokens_per_s=float(rate))
            line("c", "serve_batch", FULL, out, seconds, launches, runs=runs)
            if len(runs) != 2 or len(models) != 2 or len(drains) != 2 or \
                    any(r["arch"] != "qwen3-32b" or r["requests"] != 10
                        or r["tokens"] != 60 for r in runs):
                raise AssertionError(f"serve_batch --preset full:\n{out}")
            # the first run's weights were released before the second drew
            # its own
            if runs[1]["allocated_before_bytes"] > 0.05 * runs[0][
                    "peak_bytes"]:
                raise AssertionError(f"serve_batch --preset full: {runs}")

            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out, seconds, launches, _ = run("train_smollm", FULL, tmp,
                                            "train_full")
            steps = _one_line(out, r"^steps=(\d+) wall=([\d.]+)s "
                                   r"mean_step=([\d.]+)ms restarts=(\d+) ")
            loss = _one_line(out, r"^loss: first=([\d.]+) last=([\d.]+) "
                                  r"min=([\d.]+)$")
            first, last = float(loss.group(1)), float(loss.group(2))
            line("c", "train_smollm", FULL, out, seconds, launches,
                 steps=int(steps.group(1)), wall_s=float(steps.group(2)),
                 mean_step_ms=float(steps.group(3)),
                 restarts=int(steps.group(4)), loss_first=first,
                 loss_last=last, peak_bytes=torch.cuda.max_memory_allocated())
            if int(steps.group(1)) != 220 or int(steps.group(4)) != 1 or \
                    not last < first:
                raise AssertionError(f"train_smollm --preset full:\n{out}")
    finally:
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    emit("examples", part="phase", seconds=time.perf_counter() - t_phase)
    return {"launches": total}


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
    from repro_torch.kernels.paged_decode import paged_decode_kernel
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

    # 3e. paged decode at the serving shapes (library: SDPA over the
    # gathered K/V, timed only as a yardstick); its launches from here on
    # are the main path's
    summary["paged_decode"] = paged_decode_cases(dev, gen, info)
    paged_decode_kernel.launches = 0

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
    paged_before = paged_decode_kernel.launches
    model = model_path(dev, gen, counters, summary["flash_attention"]["ms"])
    emit("kernels", phase_of="model", launches=dict(zip(names,
                                                        model["launches"])))
    if model["launches"][names.index("flash_attention")] <= 0:
        raise AssertionError("flash attention never launched on the model "
                             "path")
    emit("kernels", phase_of="paged", launches=dict(zip(
        names, model["paged_launches"])))
    # the paged path decodes through the paged decode kernel; the
    # self-draft's forwards go through the flash kernel
    if model["paged_launches"][names.index("flash_attention")] <= 0:
        raise AssertionError("flash attention never launched on the paged "
                             "path")
    emit("kernels", phase_of="model+paged",
         paged_decode=paged_decode_kernel.launches - paged_before)
    if paged_decode_kernel.launches <= paged_before:
        raise AssertionError("paged decode never launched on the paged "
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
    # 11. the fleet rollout and the verification gate, through the CLIs --
    fleet = fleet_and_verify(dev, gen, counters, model, observed)
    emit("kernels", phase_of="fleet", launches=dict(zip(
        names, fleet["launches"])))
    idle = [k for k, n in zip(names, fleet["launches"]) if n <= 0]
    if idle:
        raise AssertionError(f"never launched in phase 11: {idle}")
    for kernel, *counts in zip(names, model["launches"],
                               model["paged_launches"], checked["launches"],
                               served["launches"], observed["launches"],
                               fleet["launches"]):
        launches[kernel] += sum(counts)
    # 12. the other families, the earlier phases' weights released first --
    fitted = observed["fitted"]
    peak_flops = fitted.peak_flops
    del model, checked, served, observed, fleet
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    emit("families", part="start",
         allocated_bytes=torch.cuda.memory_allocated())
    fams = families(dev, gen, counters)
    emit("kernels", phase_of="families", launches=dict(zip(
        names, fams["launches"])))
    if fams["launches"][names.index("flash_attention")] <= 0:
        raise AssertionError("flash attention never launched on the "
                             "families' paths")
    for kernel, n in zip(names, fams["launches"]):
        launches[kernel] += n
    # 13. training at full width, the families' weights released ---------
    gc.collect()
    torch.cuda.empty_cache()
    trained = train(dev, gen, counters, peak_flops)
    emit("kernels", phase_of="train", launches=dict(zip(
        names, trained["launches"])))
    if trained["launches"][names.index("flash_attention")] <= 0:
        raise AssertionError("flash attention never launched on the "
                             "training path")
    for kernel, n in zip(names, trained["launches"]):
        launches[kernel] += n
    # 14. the sharded paths on a 1x1 mesh, the dry run on the host -------
    gc.collect()
    torch.cuda.empty_cache()
    sharded = distributed(dev, counters, trained)
    emit("kernels", phase_of="distributed", launches=dict(zip(
        names, sharded["launches"])))
    if sharded["launches"][names.index("flash_attention")] <= 0:
        raise AssertionError("flash attention never launched on the "
                             "sharded path")
    for kernel, n in zip(names, sharded["launches"]):
        launches[kernel] += n
    # 15. the examples' torch twins, phase 14's weights released ----------
    del trained, sharded
    gc.collect()
    torch.cuda.empty_cache()
    emit("examples", part="start",
         allocated_bytes=torch.cuda.memory_allocated())
    twins = examples(dev, counters, fitted)
    emit("kernels", phase_of="examples", launches=dict(zip(
        names, twins["launches"])))
    idle = [k for k in ("tuned_reduction", "matmul_tuned")
            if twins["launches"][names.index(k)] <= 0]
    if idle:
        raise AssertionError(f"never launched in phase 15: {idle}")
    for kernel, n in zip(names, twins["launches"]):
        launches[kernel] += n

    sources = {"tuned_reduction": ("src/repro_torch/csrc/tuned_reduction.cu",
                                   "src/repro/kernels/tuned_reduction/kernel.py:76"),
               "sweep_eval": ("src/repro_torch/csrc/sweep_eval.cu",
                              "src/repro/kernels/sweep_eval/kernel.py:82"),
               "matmul_tuned": ("src/repro_torch/csrc/matmul_tuned.cu",
                                "src/repro/kernels/matmul_tuned/kernel.py:46"),
               "flash_attention": (
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:107"),
               "paged_decode": (
                   "src/repro_torch/csrc/paged_decode.cu",
                   "none: src/repro/models/attention.py decode_attention_paged "
                   "is plain jnp")}
    launches["paged_decode"] = paged_decode_kernel.launches
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
