"""The plain training step the benchmark holds the program's first steps
to: next-token cross entropy averaged over every predicted position of
the batch, gradients by autograd in float32 (TF32 off), one global-norm
clip, AdamW with decoupled weight decay on every leaf and the cosine
schedule with linear warm-up, as the configuration file states them.

The batch's rows are taken in blocks (``ROWS_PER_BLOCK`` rows) whose
gradients are summed, so that one block's activations live at a time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .decoder import exact_f32, loss

# one row of 2,048 tokens of a 30-layer f32 model keeps the reference's
# activations well under the card's memory
ROWS_PER_BLOCK = 1


def cosine_lr(step: int, base: float, warmup: int, total: int) -> float:
    """Learning rate of optimizer step ``step`` (1 for the first)."""

    if step < warmup:
        return base * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base * 0.5 * (1.0 + math.cos(math.pi * frac))


@dataclass
class Steps:
    losses: list[float]              # each step's mean loss
    first_grad: dict[str, float]     # per leaf: norm of step 1's clipped grad
    change: dict[str, float]         # per leaf: norm of params after - before
    first_grads: dict | None = None  # step 1's clipped grads, when kept


def train_steps(weights: dict[str, torch.Tensor], dims, batches, knobs: dict,
                *, rows_per_block: int = ROWS_PER_BLOCK, fp8: bool = False,
                keep_first: bool = False) -> Steps:
    """``len(batches)`` AdamW steps from ``weights`` (read, upcast to
    float32, never written) on token batches (B, S); ``keep_first`` keeps
    step 1's clipped gradients."""

    b1, b2, eps = knobs["beta1"], knobs["beta2"], knobs["eps"]
    wd, clip = knobs["weight_decay"], knobs["clip_norm"]
    with exact_f32():
        p = {k: v.detach().float().clone() for k, v in weights.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, first, kept = [], {}, {}
        for step, tokens in enumerate(batches, start=1):
            B, S = tokens.shape
            n = B * (S - 1)
            g = {k: torch.zeros_like(v) for k, v in p.items()}
            total = 0.0
            for r in range(0, B, rows_per_block):
                live = {k: v.requires_grad_() for k, v in p.items()}
                part = loss(live, dims, tokens[r:r + rows_per_block],
                            fp8=fp8) / n
                grads = torch.autograd.grad(part, list(live.values()))
                for k, gk in zip(live, grads):
                    g[k].add_(gk)
                total += float(part.detach())
                for t in live.values():
                    t.requires_grad_(False)
            gnorm = torch.sqrt(sum(torch.sum(t * t) for t in g.values()))
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
            lr = cosine_lr(step, knobs["lr"], knobs["warmup"],
                           knobs["total_steps"])
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for k in p:
                gk = g[k] * scale
                if step == 1:
                    first[k] = float(torch.linalg.vector_norm(gk))
                    if keep_first:
                        kept[k] = gk
                m[k].mul_(b1).add_(gk, alpha=1 - b1)
                v2[k].mul_(b2).add_(gk * gk, alpha=1 - b2)
                delta = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps) \
                    + wd * p[k]
                p[k].sub_(lr * delta)
            losses.append(total)
        change = {k: float(torch.linalg.vector_norm(p[k] - weights[k].float()))
                  for k in p}
    return Steps(losses, first, change, kept if keep_first else None)


__all__ = ["ROWS_PER_BLOCK", "Steps", "cosine_lr", "train_steps"]
