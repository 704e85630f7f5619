"""Batched serving on the port (continuous batching over decode slots),
contiguous rings first, then the same load through the paged KV cache
(shared page pool, admission by free pages) — the twin of
``examples/serve_batch.py``.

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu] [--preset full]

The arguments given are appended to both driver runs (argparse takes the
last value): ``--device cpu`` runs the plain PyTorch versions on the
host, ``--preset full`` serves qwen3-32b at full width (about 65.5 GB of
bf16 weights, one H100).  Without a card and without ``--device cpu``
it fails with "no CUDA device".
"""

import sys

from repro_torch.launch.serve import main as serve_main

ARGS = ["--arch", "qwen3-32b", "--preset", "smoke", "--requests", "10",
        "--batch", "4", "--context", "64", "--max-new", "6"]
PAGED = ["--paged", "--page-size", "8"]


def main(argv=None) -> None:
    extra = sys.argv[1:] if argv is None else list(argv)
    serve_main(ARGS + extra)
    serve_main(ARGS + PAGED + extra)


if __name__ == "__main__":
    main()
