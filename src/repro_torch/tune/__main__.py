"""Entry point: ``python -m repro_torch.tune <warmup|export|merge|ls|prune>``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
