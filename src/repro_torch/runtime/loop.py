"""Fault-tolerant training supervisor (the port's copy of
``repro.runtime.loop``).

The loop is a supervised state machine designed for preemptible fleets:

* **checkpoint/restart** — resumes from the latest committed checkpoint
  (params, optimizer, step cursor); the data pipeline is deterministic in
  the step index, so a restart replays no data and skips none;
* **failure handling** — an injected :class:`SimulatedFailure` (the
  stand-in for a lost node) triggers restore-from-checkpoint and replay;
  ``max_restarts`` bounds crash loops;
* **straggler mitigation** — per-step wall time is tracked with an EWMA;
  a step slower than ``straggler_factor ×`` EWMA is flagged and
  *re-dispatched* (the step function is pure, so re-execution is safe).
  Mitigation events are recorded in the history;
* **elastic restart** — checkpoints hold whole arrays, so a restart may
  pass a ``place_fn`` that puts the restored state elsewhere.

A step is timed to the end of its work on the device: the host clock
stops after a synchronize of the state's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..checkpoint.store import _flatten_with_paths


class SimulatedFailure(RuntimeError):
    """Injected node/pod failure."""


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    redispatch_stragglers: bool = True


@dataclass
class History:
    losses: list[float] = field(default_factory=list)
    step_times: list[float] = field(default_factory=list)
    restarts: int = 0
    straggler_events: list[int] = field(default_factory=list)
    redispatched: int = 0
    resumed_from: list[int] = field(default_factory=list)


def _block_until_ready(state) -> None:
    """Wait for the device that holds the state's first leaf."""

    leaf = _flatten_with_paths(state)[0][1]
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def run_training(
    *,
    step_fn: Callable[[Any, dict], tuple[Any, dict]],
    init_state: Any,
    batch_fn: Callable[[int], dict],
    cfg: LoopConfig,
    ckpt_dir: str | None = None,
    place_fn: Callable[[Any], Any] | None = None,
    inject: Callable[[int], None] | None = None,
) -> tuple[Any, History]:
    """Run ``total_steps`` of ``step_fn`` under supervision.

    ``inject(step)`` may raise SimulatedFailure or sleep (straggler) —
    the test hook for fault drills.  ``place_fn`` re-places a restored
    state (by default it stays on the devices of ``init_state``'s
    leaves)."""

    hist = History()
    mgr = (CheckpointManager(ckpt_dir, keep=cfg.keep,
                             save_interval=cfg.ckpt_every)
           if ckpt_dir else None)

    state = init_state
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        restored, manifest = mgr.restore(state)
        state = place_fn(restored) if place_fn else restored
        start = manifest["step"]
        hist.resumed_from.append(start)

    step = start
    ewma = None
    warmed = False
    restarts = 0
    while step < cfg.total_steps:
        try:
            t0 = time.perf_counter()
            if inject is not None:
                inject(step)      # failures/stalls manifest inside the step
            batch = batch_fn(step)
            new_state, metrics = step_fn(state, batch)
            _block_until_ready(new_state)
            dt = time.perf_counter() - t0

            # straggler detection + re-dispatch (the first measured step
            # includes the kernels' build and tuning and must not seed the
            # EWMA)
            if ewma is not None and dt > cfg.straggler_factor * ewma:
                hist.straggler_events.append(step)
                if cfg.redispatch_stragglers:
                    t1 = time.perf_counter()
                    new_state, metrics = step_fn(state, batch)
                    _block_until_ready(new_state)
                    dt2 = time.perf_counter() - t1
                    hist.redispatched += 1
                    dt = min(dt, dt2)
            if warmed:
                ewma = dt if ewma is None else \
                    (1 - cfg.ewma_alpha) * ewma + cfg.ewma_alpha * dt
            warmed = True

            state = new_state
            step += 1
            hist.losses.append(float(metrics.get("loss", np.nan)))
            hist.step_times.append(dt)

            if mgr is not None and mgr.should_save(step):
                mgr.save(step, state)     # async
        except SimulatedFailure:
            restarts += 1
            hist.restarts = restarts
            if restarts > cfg.max_restarts:
                raise
            if mgr is None:
                # no checkpointing: restart from the initial state
                state, step = init_state, 0
                continue
            mgr.wait()
            latest = mgr.latest_step()
            if latest is None:
                state, step = init_state, 0
                continue
            restored, manifest = mgr.restore(state)
            state = place_fn(restored) if place_fn else restored
            step = manifest["step"]
            hist.resumed_from.append(step)

    if mgr is not None:
        mgr.save(cfg.total_steps, state, blocking=True)
    return state, hist


__all__ = ["run_training", "LoopConfig", "History", "SimulatedFailure"]
