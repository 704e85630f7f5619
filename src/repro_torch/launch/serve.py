"""Batched serving driver on the card: continuous batching over decode
slots with contiguous KV rings, or a paged pool (``--paged``) with
copy-on-write prefix sharing (``--share-prefix``), and speculative
decoding (``--speculate ngram|draft``).

Example (qwen1.5-4b at full width, random weights from ``--seed``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --preset full --requests 4 --batch 4 --context 1024 \\
      --prompt-len 512 --max-new 16 --paged --kv-pages 112

``--arch`` takes every registered config (dense, SSM, MoE, hybrid, vlm,
enc-dec); as in the reference, no frames or image embeddings are fed,
so an enc-dec or vlm request decodes against zero cross K/V.  ``--preset
smoke`` runs the architecture's reduced variant; ``--device cpu`` runs
the plain PyTorch versions on the host.

``--scheduler fcfs|priority|prefix`` picks the serving policy;
``--trace OUT.json``, ``--metrics`` and ``--profile`` attach a
:class:`~repro_torch.obs.Observability` bundle (with ``--paged``, its
conformance monitor checks the allocator's ops) and print its trace,
monitor, phase-profile and Prometheus lines after the drain.

``--tune-batch``, ``--tune-prefill``, ``--tune-page``, ``--tune-spec`` and
``--tune-scheduler`` pick the slot count, the prefill chunk, the KV page
size, the speculation policy and the scheduling policy through a
:class:`~repro_torch.tune.TuningPlan` before the drain, each printing a
``[tune]`` line; ``--tune-engine measure`` times real drains of the
shortlisted points.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import build_model
from ..runtime.scheduler import SCHEDULER_KINDS
from ..runtime.serve import Server
from ..runtime.speculate import DRAFTER_KINDS, spec_depth_tunable
from ..runtime.tunables import (decode_batch_tunable, kv_page_tunable,
                                prefill_chunk_tunable, scheduler_tunable)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=6)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens per chunked-prefill tick")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: slots share a page pool instead "
                         "of reserving a full context-length ring each")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (with --paged)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="pool size in pages (default: full per-slot "
                         "backing, batch * ceil(context/page))")
    ap.add_argument("--scheduler", choices=list(SCHEDULER_KINDS),
                    default=None,
                    help="serving policy: fcfs (default), priority "
                         "(SLO classes, preemptive), or prefix "
                         "(prefix-affinity admission)")
    ap.add_argument("--share-prefix", action="store_true",
                    help="copy-on-write KV prefix sharing across slots "
                         "(implies --paged)")
    ap.add_argument("--speculate", choices=list(DRAFTER_KINDS), default=None,
                    help="speculative decoding drafter: 'ngram' "
                         "(prompt lookup) or 'draft' (self-draft model "
                         "rollout)")
    ap.add_argument("--spec-depth", type=int, default=4,
                    help="draft tokens verified per speculative tick")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record lifecycle/tick spans and write the "
                         "repro.obs/trace document (Perfetto-loadable) "
                         "here; with --paged the online conformance "
                         "monitor validates the allocator op stream")
    ap.add_argument("--metrics", action="store_true",
                    help="print the drain's metrics registry as "
                         "Prometheus text exposition")
    ap.add_argument("--profile", action="store_true",
                    help="per-tick phase breakdown (prefill vs decode "
                         "vs speculate vs COW vs host); synchronizes "
                         "the device after each phase, so the drain "
                         "itself runs slower")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu")
    ap.add_argument("--tune-batch", action="store_true",
                    help="pick the slot count via repro_torch.tune")
    ap.add_argument("--tune-prefill", action="store_true",
                    help="pick the prefill chunk size via repro_torch.tune")
    ap.add_argument("--tune-page", action="store_true",
                    help="pick the KV page size via repro_torch.tune "
                         "(implies --paged)")
    ap.add_argument("--tune-spec", action="store_true",
                    help="pick the speculation policy (depth x drafter) "
                         "via repro_torch.tune (implies speculation)")
    ap.add_argument("--tune-scheduler", action="store_true",
                    help="pick the scheduling policy (policy x age_limit) "
                         "via repro_torch.tune over a seeded traffic trace "
                         "(implies --paged)")
    ap.add_argument("--tune-engine", default="grid",
                    help="tuning engine for the --tune-* flags; 'measure' "
                         "refines the modeled pick with timed server "
                         "drains")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(args.seed, device=args.device)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"model {cfg.name} ({args.preset}): {api.param_count():,} "
          f"parameters on {device}, set up in "
          f"{time.perf_counter() - t0:.2f}s")

    def run_job(tunable, label, key):
        from ..tune import TuningPlan
        plan = TuningPlan(name=f"serve.{args.arch}")
        plan.add(tunable, engine=args.tune_engine, label=label)
        job = plan.run(progress=None).results[0]
        if job.status == "failed":
            raise RuntimeError(f"--tune-{label} failed: {job.error}")
        picked = dict(job.best_config)
        shown = ",".join(f"{k}={v}" for k, v in sorted(picked.items()))
        print(f"[tune] {shown} "
              f"{job.provenance or 'modeled'} drain="
              f"{job.t_min / 1e3:.1f} ms (engine={job.engine}, "
              f"cache {job.status})")
        return picked if key is None else int(picked[key])

    batch = args.batch
    prefill_chunk = args.prefill_chunk
    page_size = args.page_size
    paged = (args.paged or args.tune_page or args.share_prefix
             or args.tune_scheduler)
    if args.tune_batch:
        tb = decode_batch_tunable(api, context=args.context,
                                  requests=args.requests,
                                  max_new=args.max_new, params=params)
        batch = run_job(tb, "batch", "batch")
    if args.tune_prefill:
        # after --tune-batch so the chunk is tuned (and cached) for the
        # slot count the server will actually run
        tp = prefill_chunk_tunable(api, context=args.context,
                                   prompt_len=args.prompt_len,
                                   requests=args.requests,
                                   max_new=args.max_new,
                                   batch=batch, params=params)
        prefill_chunk = run_job(tp, "prefill", "chunk")
    if args.tune_page:
        tk = kv_page_tunable(api, context=args.context,
                             prompt_lens=[args.prompt_len],
                             requests=args.requests, max_new=args.max_new,
                             batch=batch, params=params)
        page_size = run_job(tk, "page", "page")
    speculate = args.speculate
    spec_depth = args.spec_depth
    if args.tune_spec:
        ts = spec_depth_tunable(api, context=args.context,
                                prompt_len=args.prompt_len,
                                requests=args.requests,
                                max_new=args.max_new, batch=batch,
                                params=params)
        picked = run_job(ts, "spec", None)
        spec_depth = int(picked["depth"])
        speculate = str(picked["drafter"])
    scheduler = args.scheduler
    share_prefix = args.share_prefix
    if args.tune_scheduler:
        # policy differences are what the modeled cost can only rank,
        # not settle — this tunable measures real trace drains
        tsc = scheduler_tunable(api, context=args.context, batch=batch,
                                requests=args.requests,
                                page_size=page_size,
                                prefill_chunk=prefill_chunk,
                                prompt_len=(max(2, args.prompt_len // 2),
                                            args.prompt_len),
                                max_new=(max(1, args.max_new // 2),
                                         args.max_new), params=params)
        picked = run_job(tsc, "scheduler", None)
        scheduler = str(picked["policy"])
        share_prefix = share_prefix or scheduler == "prefix"

    obs = None
    if args.trace or args.metrics or args.profile:
        from ..obs import Observability
        obs = Observability(trace=args.trace is not None or args.profile,
                            metrics=True, profile=args.profile,
                            monitor=paged)
    server = Server(api, params, batch=batch, context=args.context,
                    prefill_chunk=prefill_chunk, paged=paged,
                    page_size=page_size, kv_pages=args.kv_pages,
                    scheduler=scheduler, share_prefix=share_prefix,
                    speculate=speculate, spec_depth=spec_depth, obs=obs)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, args.prompt_len).tolist()
        server.submit(prompt, max_new=args.max_new)

    t0 = time.perf_counter()
    with torch.inference_mode():
        server.run_until_drained(max_ticks=100_000)
    wall = time.perf_counter() - t0

    done = server.completed
    total_tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {total_tokens} tokens in "
          f"{server.ticks} engine ticks, {wall:.2f}s "
          f"({total_tokens / max(wall, 1e-9):.1f} tok/s)")
    if paged:
        st = server.kv_stats()
        print(f"  paged kv: page={page_size} pool={st['n_pages']:.0f} pages "
              f"peak_used={st['peak_used_pages']:.0f} "
              f"peak_active={st['peak_active']:.0f} "
              f"deferrals={st['deferrals']:.0f}")
    if scheduler is not None or share_prefix:
        st = server.stats()
        print(f"  scheduler: policy={scheduler or 'fcfs'} "
              f"preemptions={st['preemptions']:.0f} "
              f"share_hits={st['share_hits']:.0f} "
              f"shared_tokens={st['shared_tokens']:.0f} "
              f"cow_copies={st['cow_copies']:.0f}")
    if speculate is not None:
        st = server.stats()
        print(f"  speculation: drafter={speculate} depth={spec_depth} "
              f"proposed={st['spec_proposed']:.0f} "
              f"accepted={st['spec_accepted']:.0f} "
              f"(accept_rate={st['accept_rate']:.2f}) "
              f"ticks/token={st['ticks_per_token']:.2f}")
    for r in done[:3]:
        print(f"  req{r.rid}: prompt={r.prompt[:4]}... out={r.out}")
    if obs is not None:
        doc = obs.export(args.trace)
        if args.trace:
            print(f"  trace: {len(doc['traceEvents'])} events -> "
                  f"{args.trace} (open in https://ui.perfetto.dev)")
        if obs.monitor is not None:
            mon = doc["monitor"]
            print(f"  conformance monitor: {mon['status']} "
                  f"({mon['ops_checked']} allocator ops checked)")
        if args.profile and obs.profiler is not None:
            print(obs.profiler.format())
        if args.metrics and obs.registry is not None:
            print(obs.registry.to_prometheus(), end="")


if __name__ == "__main__":
    main()
