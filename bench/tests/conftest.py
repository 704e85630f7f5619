"""The benchmark's own tests: the harness, its arithmetic and the plain
reference on the CPU at small sizes; ``gpu``-marked ones need the card.

``PYTHONPATH=src python -m pytest bench/tests`` from the repo root."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda_device():
    """``cuda:0``, or a skip where this machine has no card."""

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
