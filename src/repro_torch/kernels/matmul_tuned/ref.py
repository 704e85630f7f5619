"""Plain PyTorch version of the tiled matmul: the product in f32 (the
kernel's accumulator type), cast to the inputs' dtype."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


__all__ = ["matmul_ref"]
