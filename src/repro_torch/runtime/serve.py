"""Batched serving runtime (the port's copy of ``repro.runtime.serve``,
contiguous caches): fixed-slot continuous batching with chunked prefill.

``Server`` keeps ``batch`` decode slots alive; requests are admitted
into free slots by a :class:`~repro_torch.runtime.scheduler.Scheduler`
(FCFS by default), finished requests retire and free their slot.  Each
slot has a *phase*: **prefill** (stream tokens still unconsumed) or
**decode** (generating).  An engine tick advances prefilling slots by
one ``prefill_chunk``-token ``prefill_step`` and decoding slots by the
one-token ``decode_step``: a long prompt costs ``ceil(len/chunk)``
ticks instead of ``len``.

Greedy sampling; per-slot absolute positions drive RoPE and the ring
caches, so mixed-progress (and mixed-phase) slots coexist in one batch.
Each slot owns a contiguous KV ring of ``context`` positions (the
window for SWA models) in one state tree that the model steps update IN
PLACE.  Both steps gate their writes per slot — ``decode_step`` by the
``active`` mask of decoding slots, ``prefill_step`` by per-slot chunk
lengths (0 for every slot not prefilling) — so a prefill tick cannot
scatter a token into a decoding neighbour's ring, nor a decode tick
into an idle or prefilling slot's ring.

Not ported yet: ``paged=`` and ``share_prefix=`` (ROADMAP queue 1,
item 17), ``speculate=`` (item 18) and ``obs=`` (item 20) raise
``ValueError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..models.api import ModelAPI
from ..models.common import tree_leaves
from .scheduler import Scheduler, make_scheduler


def _snapshot(a: np.ndarray, device) -> torch.Tensor:
    """A device tensor holding a COPY of a host array the engine keeps
    mutating (``slot_pos``).

    ``torch.from_numpy`` aliases the numpy buffer, and a non-blocking
    copy from pinned memory runs after the host has moved on, so a step
    handed the live buffer could read increments the host makes a few
    lines later (the race the reference root-caused in its speculation
    commit).  The host copy is taken first, then moved with a blocking
    copy."""

    return torch.from_numpy(np.array(a)).to(device)


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)
    done: bool = False
    slo: str = "interactive"    # SLO class (scheduler.PriorityScheduler)
    deadline: float | None = None   # absolute driver-clock deadline
    skips: int = 0              # admissions that bypassed this request
    preempted: int = 0          # times evicted mid-flight (progress kept)


class Server:
    def __init__(self, api: ModelAPI, params, *, batch: int, context: int,
                 prefill_chunk: int = 32, scheduler: str | Scheduler | None = None,
                 paged: bool = False, speculate: Any = None,
                 share_prefix: bool = False, obs: Any = None):
        for flag, on, item in (("paged", paged, 17),
                               ("share_prefix", share_prefix, 17),
                               ("speculate", speculate is not None, 18),
                               ("obs", obs is not None, 20)):
            if on:
                raise ValueError(f"{flag}= is not ported yet (ROADMAP "
                                 f"queue 1, item {item})")
        self.api = api
        self.params = params
        self.batch = batch
        self.context = context
        self.prefill_chunk = max(1, min(prefill_chunk, context))
        self.paged = False
        self.scheduler = make_scheduler(scheduler)
        # KV rings follow the params' dtype and device: a float32 model
        # keeps a float32 cache (greedy parity needs the real logit gaps)
        leaf = next(t for t in tree_leaves(params)
                    if isinstance(t, torch.Tensor) and t.is_floating_point())
        self.device = leaf.device
        self.state = api.init_decode_state(batch, context, dtype=leaf.dtype,
                                           device=self.device)
        self.slot_req: list[Request | None] = [None] * batch
        self.slot_pos = np.zeros(batch, np.int32)   # per-slot token count
        self._slot_seq = np.zeros(batch, np.int64)  # admission order
        self._seq = 0
        self.preemptions = 0        # policy-initiated evictions (SLO)
        self.peak_active = 0
        # per-drain counters behind stats()
        self.ticks = 0
        self.slot_ticks = 0         # sum of active slots over ticks
        self.tokens_generated = 0
        self.prefill_chunks = 0
        self.queue: list[Request] = []
        self.completed: list[Request] = []

    # -- API ----------------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int, *,
               slo: str = "interactive",
               deadline: float | None = None) -> Request:
        """Queue a request.  ``slo`` names its service class and
        ``deadline`` its absolute driver-clock deadline: policy inputs
        for the scheduler, never read by the engine itself."""

        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt: a request needs at least one "
                             "prompt token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        limit = self.context - max_new
        if len(prompt) > limit:
            raise ValueError(
                f"prompt of {len(prompt)} tokens + max_new={max_new} "
                f"exceeds context={self.context}; prompts may be at most "
                f"context - max_new = {limit} tokens")
        req = Request(rid=len(self.completed) + len(self.queue) +
                      sum(r is not None for r in self.slot_req),
                      prompt=prompt, max_new=max_new, slo=slo,
                      deadline=deadline)
        self.queue.append(req)
        return req

    # -- scheduler-facing queries (the policy contract) ---------------------

    def live_slots(self) -> list[int]:
        return [s for s in range(self.batch)
                if self.slot_req[s] is not None]

    def has_free_slot(self) -> bool:
        return any(r is None for r in self.slot_req)

    def slot_seq(self, slot: int) -> int:
        """Admission order of the slot's occupant (higher = younger)."""

        return int(self._slot_seq[slot])

    def slot_request(self, slot: int) -> Request | None:
        return self.slot_req[slot]

    def admit_fits(self, req: Request) -> bool:
        """Contiguous rings: a free slot always has its full ring."""

        return True

    def shared_prefix_len(self, req: Request) -> int:
        return 0

    def is_share_source(self, slot: int) -> bool:
        return False

    # -- admission / placement / preemption ---------------------------------

    def _admit(self) -> None:
        # proactive SLO preemption first (bounded by batch: each eviction
        # frees a slot, and a policy only volunteers strictly-lower-class
        # victims)
        for _ in range(self.batch):
            if not self.queue:
                break
            victim = self.scheduler.preempt_for(self)
            if victim is None:
                break
            self._preempt(victim)
            self.preemptions += 1
        for slot in range(self.batch):
            if self.slot_req[slot] is None and self.queue:
                idx = self.scheduler.pick(self)
                if idx is None:
                    return
                self._place(slot, self.queue.pop(idx))

    def _place(self, slot: int, req: Request) -> None:
        """Bind ``req`` to ``slot``; its prefill target is
        ``len(prompt) + len(out)``, so a preempted request re-prefills its
        generated tokens too and resumes where it left off.  The slot's
        ring keeps the previous occupant's K/V: positions at or past the
        new request's own count are masked until overwritten."""

        self.slot_req[slot] = req
        self._slot_seq[slot] = self._seq
        self._seq += 1
        req._prefill_target = (len(req.prompt)  # type: ignore[attr-defined]
                               + len(req.out))
        self.slot_pos[slot] = 0
        req._cursor = 0  # type: ignore[attr-defined]

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` mid-flight: the request goes back to the FRONT
        of the queue with prompt and generated tokens intact."""

        req = self.slot_req[slot]
        req._cursor = 0  # type: ignore[attr-defined]
        req.preempted += 1
        self.queue.insert(0, req)
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0

    def _phase(self, slot: int) -> str:
        req = self.slot_req[slot]
        cur = req._cursor  # type: ignore[attr-defined]
        return "prefill" if cur < req._prefill_target else "decode"

    def _retire_if_done(self, slot: int) -> None:
        req = self.slot_req[slot]
        if len(req.out) >= req.max_new or \
                self.slot_pos[slot] >= self.context - 1:
            req.done = True
            self.completed.append(req)
            self.slot_req[slot] = None

    def stats(self) -> dict[str, float]:
        """Per-drain engine counters: ticks, tokens, batch occupancy,
        prefill chunks and policy preemptions."""

        g = self.tokens_generated
        return {
            "ticks": float(self.ticks),
            "tokens_generated": float(g),
            "ticks_per_token": (self.ticks / g) if g else 0.0,
            "mean_active": (self.slot_ticks / self.ticks
                            if self.ticks else 0.0),
            "prefill_chunks": float(self.prefill_chunks),
            "preemptions": float(self.preemptions),
            "peak_active": float(self.peak_active),
        }

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        # a per-tick temporary, never written after the step is issued
        return torch.from_numpy(a).to(self.device)

    def tick(self) -> int:
        """One engine iteration; returns number of active slots.

        Decoding slots advance one token through ``decode_step``;
        prefilling slots advance up to ``prefill_chunk`` stream tokens
        through ``prefill_step``: the chunk that consumes a stream's
        last token also yields the request's next generated token,
        exactly as the tokenwise tick that fed that token would have."""

        self._admit()
        active = [s for s in range(self.batch) if self.slot_req[s] is not None]
        self.peak_active = max(self.peak_active, len(active))
        if not active:
            return 0
        self.ticks += 1
        self.slot_ticks += len(active)
        decode = [s for s in active if self._phase(s) == "decode"]
        prefill = [s for s in active if self._phase(s) == "prefill"]

        if decode:
            tokens = np.zeros((self.batch, 1), np.int32)
            mask = np.zeros(self.batch, bool)
            for s in decode:
                tokens[s, 0] = self.slot_req[s].out[-1]
                mask[s] = True
            logits, self.state = self.api.decode_step(
                self.params, self.state, self._tensor(tokens),
                _snapshot(self.slot_pos, self.device),
                active=self._tensor(mask))
            nxt = logits.argmax(dim=-1).cpu().numpy()
            for s in decode:
                req = self.slot_req[s]
                req._cursor += 1  # type: ignore[attr-defined]
                self.slot_pos[s] += 1
                req.out.append(int(nxt[s]))
                self.tokens_generated += 1
                self._retire_if_done(s)

        if prefill:
            T = self.prefill_chunk
            tokens = np.zeros((self.batch, T), np.int32)
            lengths = np.zeros(self.batch, np.int32)
            for s in prefill:
                req = self.slot_req[s]
                cur = req._cursor  # type: ignore[attr-defined]
                # the stream includes generated tokens: a preempted
                # request re-prefills prompt + out and resumes exactly
                stream = req.prompt + req.out
                n = min(T, req._prefill_target - cur)
                tokens[s, :n] = stream[cur:cur + n]
                lengths[s] = n
            logits, self.state = self.api.prefill_step(
                self.params, self.state, self._tensor(tokens),
                _snapshot(self.slot_pos, self.device),
                self._tensor(lengths))
            nxt = logits.argmax(dim=-1).cpu().numpy()
            self.prefill_chunks += len(prefill)
            for s in prefill:
                req = self.slot_req[s]
                n = int(lengths[s])
                req._cursor += n  # type: ignore[attr-defined]
                self.slot_pos[s] += n
                if req._cursor >= req._prefill_target:
                    req.out.append(int(nxt[s]))
                    self.tokens_generated += 1
                    self._retire_if_done(s)
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self.queue:
                return
        raise RuntimeError("serving did not drain")


__all__ = ["Server", "Request", "Scheduler", "make_scheduler"]
