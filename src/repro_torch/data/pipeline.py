"""Deterministic synthetic token pipeline with per-host sharding and
background prefetch (the port's copy of ``repro.data.pipeline``).

* determinism: batch ``i`` depends only on (seed, i, host), drawn from
  the same ``np.random.default_rng((seed, i, host))`` stream as the
  reference, so its int32 tokens are equal to the reference's and a
  restart resumes from the checkpointed step with identical data;
* per-host sharding: each host materializes only its slice of the global
  batch;
* prefetch: a daemon thread keeps ``prefetch`` batches ahead.

Batches are tensors on the pipeline's ``device`` (``cuda:0`` by
default): int32 tokens and labels, bf16 ``img_embeds`` (vlm) and
``frames`` (enc-dec).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..kernels.common import resolve_device


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 50_000
    # markov-ish synthetic stream so the loss actually decreases
    structure: float = 0.7


class SyntheticLM:
    """Deterministic synthetic LM batches: batch(i) is a pure function."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, data: DataConfig
                 = DataConfig(), host_index: int = 0, host_count: int = 1,
                 device=None):
        if shape.global_batch % host_count:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg, self.shape, self.data = cfg, shape, data
        self.host_index, self.host_count = host_index, host_count
        self.local_batch = shape.global_batch // host_count
        self.device = resolve_device(device)

    def batch(self, i: int) -> dict:
        rng = np.random.default_rng((self.data.seed, i, self.host_index))
        B, S = self.local_batch, self.shape.seq_len
        V = self.cfg.vocab
        # learnable stream: a per-sequence cyclic pattern of distinct
        # tokens (next-token is a function of the previous one), with
        # (1-structure) random corruptions; the cycle is fixed per dataset
        # (seed only), the corruption positions vary per batch
        k = min(32, V)
        pat = np.random.default_rng(self.data.seed).permutation(V)[:k]
        phase = rng.integers(0, k, (B, 1))
        base = pat[(phase + np.arange(S)) % k]           # (B, S)
        mask = rng.random((B, S)) < self.data.structure
        noise = rng.integers(0, V, (B, S))
        toks = torch.from_numpy(np.where(mask, base, noise).astype(np.int32)
                                ).to(self.device)
        out = {"tokens": toks, "labels": toks}
        if self.cfg.family == "vlm":
            out["img_embeds"] = self._bf16(rng.standard_normal(
                (B, self.cfg.n_img_tokens, self.cfg.d_model)) * 0.1)
        if self.cfg.is_encdec:
            out["frames"] = self._bf16(rng.standard_normal(
                (B, self.cfg.enc_seq, self.cfg.d_model)) * 0.1)
        return out

    def _bf16(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device, torch.bfloat16)

    def iterate(self, start: int = 0, prefetch: int = 2) -> Iterator[dict]:
        """Prefetching iterator starting at batch ``start`` (the restart
        cursor)."""

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            i = start
            while not stop.is_set():
                q.put(self.batch(i))
                i += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta tensors of a global batch (the dry-run input contract), in
    the reference's dtypes."""

    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt=torch.int32: torch.empty(shp, dtype=dt,
                                                   device="meta")
    out = {"tokens": meta((B, S)), "labels": meta((B, S))}
    if cfg.family == "vlm":
        out["img_embeds"] = meta((B, cfg.n_img_tokens, cfg.d_model),
                                 torch.bfloat16)
    if cfg.is_encdec:
        out["frames"] = meta((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return out


__all__ = ["DataConfig", "SyntheticLM", "make_batch_specs"]
