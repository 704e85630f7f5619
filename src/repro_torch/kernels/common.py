"""Shared kernel-wrapper helpers.

:func:`resolve_device` is the port's dispatch rule: an entry point runs
on ``cuda:0`` unless the caller asks for the CPU, and raises when there
is no card rather than quietly running on the host.  A wrapper then
dispatches on its tensor's device: a CPU tensor takes the kernel's plain
PyTorch version, a CUDA tensor the hand-written kernel.

:func:`time_fn` is the one timing discipline every Tunable's
``measure(cfg)`` uses: warmup calls absorb the build and the caches,
each timed call is bracketed by CUDA events, and the median survives
noise.
"""

from __future__ import annotations

import time

import torch

# The card the cost models and bounds price against: NVIDIA H100 SXM data
# sheet (dense rates, no sparsity, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12          # tensor cores
F32_FLOPS = 67e12            # FMA units, no TF32
# instruction issue: each SM's four schedulers issue one 32-lane warp
# instruction a cycle (132 SMs at 1.98 GHz), the FMA rate above counted
# in instructions; the ceiling for integer code such as the sweep
ISSUE_RATE = F32_FLOPS / 2   # lane-instructions per second
SMS = 132
THREADS_PER_SM = 2048
# modeling assumption, not a data-sheet number: host cost of one launch
LAUNCH_US = 3.0


def median(samples) -> float:
    """True median: mean of the middle pair for even counts.  The one
    median every measurement path (``time_fn``, the measure engine)
    shares."""

    s = sorted(samples)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``; a CUDA device without a card raises."""

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass CPU tensors or device='cpu' to run the "
            "plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_device_tensor(x, device=None) -> torch.Tensor:
    """``x`` on the device an entry point runs on: a tensor stays where
    it is unless ``device`` is given; anything else goes to
    :func:`resolve_device`'s device."""

    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def time_fn(fn, *, device, warmup: int = 1, iters: int = 3) -> float:
    """Median microseconds of ``fn()`` on ``device``.

    On a CUDA device each call is bracketed by a pair of
    ``torch.cuda.Event(enable_timing=True)`` and synchronized; the host
    clock is used only for ``device="cpu"``.  ``warmup`` untimed calls
    run first."""

    dev = resolve_device(device)
    for _ in range(max(0, warmup)):
        fn()
    samples = []
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            for _ in range(max(1, iters)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e6)
    return median(samples)


def generator(device, seed: int = 0) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (inputs of ``measure``)."""

    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    return g


def tunable_device(x, device=None) -> str | None:
    """The ``device`` field of a Tunable built from a call's arguments:
    ``None`` (the card, the default) unless the call runs on the CPU."""

    if device is not None:
        return None if torch.device(device).type == "cuda" else "cpu"
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        return "cpu"
    return None


__all__ = ["median", "resolve_device", "as_device_tensor", "time_fn",
           "generator", "tunable_device", "HBM_BYTES_PER_S", "BF16_FLOPS",
           "F32_FLOPS", "ISSUE_RATE", "SMS", "THREADS_PER_SM", "LAUNCH_US"]
