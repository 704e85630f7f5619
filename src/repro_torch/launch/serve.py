"""Batched serving driver on the card: continuous batching over decode
slots with contiguous KV rings.

Example (qwen1.5-4b at full width, random weights from ``--seed``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --preset full --requests 4 --batch 4 --context 1024 \\
      --prompt-len 512 --max-new 16

``--preset smoke`` runs the architecture's reduced variant; ``--device
cpu`` runs the plain PyTorch versions on the host.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import build_model
from ..runtime.serve import Server


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:0 (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    api = build_model(cfg)
    t0 = time.perf_counter()
    params = api.init(args.seed, device=args.device)
    server = Server(api, params, batch=args.batch, context=args.context,
                    prefill_chunk=args.prefill_chunk)
    if server.device.type == "cuda":
        torch.cuda.synchronize(server.device)
    print(f"model {cfg.name} ({args.preset}): {api.param_count():,} "
          f"parameters on {server.device}, set up in "
          f"{time.perf_counter() - t0:.2f}s")

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
    for r in done[:3]:
        print(f"  req{r.rid}: prompt={r.prompt[:4]}... out={r.out}")


if __name__ == "__main__":
    main()
