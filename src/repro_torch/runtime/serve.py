"""Batched serving runtime (the port's copy of ``repro.runtime.serve``):
fixed-slot continuous batching with chunked prefill.

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
into an idle or prefilling slot's ring.  An SSM layer's recurrent state
is per slot, gated the same way, and zeroed in place when a retired or
preempted slot takes a new request; an enc-dec request's frames
(``submit(frames=)``) are encoded at admission into its slot's cross
K/V.

``paged=True`` swaps the per-slot rings for a shared pool of
``page_size``-token pages (:mod:`repro_torch.runtime.kv`): a request is
admitted when its pages fit the free pool, pages are allocated as
prefill chunks and decode steps advance, and a tick that runs out of
pages **preempts** a policy-chosen victim (its pages released, the
request requeued with prompt AND generated tokens, re-prefilled on
resume).  A sliding-window model hands back pages that fell out of the
window.  ``share_prefix=True`` (paged only) maps the pages of a live
slot's written prefix into a new request's table (copy on write: the
first write into a still-shared page copies it first), so N requests
with one system prompt prefill it once.  Where the paged state holds
nothing per slot (attention pools alone: no SSM, cross or enc-dec
state), the prefill step is handed only the prefilling slots' rows and
page-table rows instead of every slot padded to length 0.

``speculate=`` (a drafter, :mod:`repro_torch.runtime.speculate`) adds a
third per-tick population: decoding slots with a draft verify
``depth+1`` tokens in one ``verify_step`` chunk, accept the longest
greedy-matching prefix plus the verifier's bonus token, and commit
exactly the accepted tokens with a length-gated ``prefill_step``; in
paged mode the pages taken for rejected drafts are rewound, so the page
table matches a drain that never speculated.  Output is the baseline
greedy stream, up to floating-point argmax ties (the commit chunk
reduces in another order than one-token decodes; float32 params keep
the real logit gaps).

``obs=`` takes a :class:`~repro_torch.obs.Observability` bundle: the
engine calls its lifecycle, tick and phase hooks at the reference's
sites, each behind ``if self.obs is not None``.  The hooks record host
state only, so an observed drain gives the unobserved drain's tokens;
``profile=True`` synchronizes the cache tensors' devices after each
phase (:mod:`repro_torch.obs.profile`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..kernels.paged_decode import paged_decode_kernel
from ..models.api import ModelAPI
from ..models.common import tree_leaves
from ..obs.profile import span
from .kv import NO_PAGE, PagedKVAllocator, PagedKVSpec
from .scheduler import Scheduler, make_scheduler
from .speculate import make_drafter


def _snapshot(a: np.ndarray, device) -> torch.Tensor:
    """A device tensor holding a COPY of a host array the engine keeps
    mutating (``slot_pos``, the page table).

    ``torch.from_numpy`` aliases the numpy buffer, and a non-blocking
    copy from pinned memory runs after the host has moved on, so a step
    handed the live buffer could read increments the host makes a few
    lines later (the race the reference root-caused in its speculation
    commit).  The host copy is taken first, then moved with a blocking
    copy."""

    return torch.from_numpy(np.array(a)).to(device)


def _prefill_counts(pos: np.ndarray, n: np.ndarray, positions: int) -> dict:
    """A prefill step's counters: the keys its slots read (a slot at
    ``pos`` with ``n`` chunk tokens reads ``pos + n``), their real
    query-key pairs (its token ``i`` attends ``pos + i + 1`` keys), the
    chunk tokens, and the positions the step computes (its rows times
    the chunk)."""

    pos, n = pos.astype(np.int64), n.astype(np.int64)
    return {"kv_tokens": int((pos + n).sum()),
            "qk_pairs": int((n * pos + n * (n + 1) // 2).sum()),
            "tokens": int(n.sum()), "positions": positions}


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
    shared_prefix: int = 0      # tokens admitted via COW page sharing
    spec_proposed: int = 0      # draft tokens verified for this request
    spec_accepted: int = 0      # of those, accepted into the output


class Server:
    def __init__(self, api: ModelAPI, params, *, batch: int, context: int,
                 prefill_chunk: int = 32, paged: bool = False,
                 page_size: int = 16, kv_pages: int | None = None,
                 speculate: Any = None, spec_depth: int = 4,
                 scheduler: str | Scheduler | None = None,
                 share_prefix: bool = False, obs: Any = None):
        self.share_prefix = bool(share_prefix)
        if self.share_prefix and not paged:
            raise ValueError(
                "share_prefix=True needs paged=True: prefix sharing maps "
                "KV pages between slot page tables, contiguous rings have "
                "none")
        if self.share_prefix and api.cfg.is_encdec:
            raise ValueError(
                "share_prefix=True is unsupported for encoder-decoder "
                "models: per-slot cross-K/V is not positionally sharable")
        self.api = api
        self.params = params
        self.batch = batch
        self.context = context
        self.prefill_chunk = max(1, min(prefill_chunk, context))
        self.paged = paged
        self.scheduler = make_scheduler(scheduler)
        self.drafter = None
        self.spec_depth = max(1, min(spec_depth, context - 1))
        if speculate is not None:
            self.drafter = make_drafter(speculate, api=api, params=params)
        self.alloc: PagedKVAllocator | None = None
        if paged:
            spec = PagedKVSpec.for_server(context=context,
                                          page_size=page_size,
                                          n_pages=kv_pages, batch=batch)
            self.alloc = PagedKVAllocator(spec, batch)
        # KV caches follow the params' dtype and device: a float32 model
        # keeps a float32 cache (greedy parity needs the real logit gaps)
        leaf = next(t for t in tree_leaves(params)
                    if isinstance(t, torch.Tensor) and t.is_floating_point())
        self.device = leaf.device
        self.state = api.init_decode_state(
            batch, context, self.alloc.spec if paged else None,
            dtype=leaf.dtype, device=self.device)
        if self.share_prefix and any(
                "ssm" in entry or "enc_kv" in entry
                for entry in self.state["blocks"].values()):
            raise ValueError(
                "share_prefix=True needs pure-attention decode state: "
                "SSM/recurrent state at the share point is per-slot and "
                "has no position index to share through")
        # a state of shared page pools alone holds nothing per slot: the
        # prefill step then takes only the prefilling slots' rows (their
        # page-table rows address the pool), not every slot padded to
        # length 0
        self._prefill_rows_only = paged and set(self.state) == {"blocks"} \
            and all(set(entry) == {"kv"}
                    for entry in self.state["blocks"].values())
        self.slot_req: list[Request | None] = [None] * batch
        self.slot_pos = np.zeros(batch, np.int32)   # per-slot token count
        self._slot_dirty = np.zeros(batch, bool)    # retired -> stale state
        self._slot_seq = np.zeros(batch, np.int64)  # admission order
        self._seq = 0
        self.deferrals = 0          # paged: evictions forced by page OOM
        self.preemptions = 0        # policy-initiated evictions (SLO)
        self.peak_active = 0
        self.peak_used_pages = 0
        # per-drain counters behind stats()
        self.ticks = 0
        self.slot_ticks = 0         # sum of active slots over ticks
        self.tokens_generated = 0
        self.prefill_chunks = 0
        self.spec_ticks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.share_hits = 0         # placements that mapped a prefix
        self.shared_tokens = 0      # prompt tokens admitted without prefill
        self.cow_copies = 0         # pages copied by write-triggered COW
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        # observability is strictly additive: every hook below is guarded
        # by `if self.obs is not None` and records host state the engine
        # already holds, so obs=None drains are untouched and observed
        # drains give the same tokens
        self.obs = obs
        if obs is not None:
            obs.attach(self)

    # -- API ----------------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int, frames: Any = None,
               *, slo: str = "interactive",
               deadline: float | None = None) -> Request:
        """Queue a request.  ``frames``: an enc-dec model's frame
        embeddings (enc_seq, d_model) for this request (numpy or a
        tensor); the encoder runs at admission and its cross K/V fills
        the request's slot.  ``slo`` names its service class and
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
        req._frames = frames  # type: ignore[attr-defined]
        self.queue.append(req)
        if self.obs is not None:
            self.obs.on_submit(self, req)
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
        """Would ``req``'s pages fit right now?  Contiguous mode always
        fits (a free slot has a full ring reserved); paged mode needs
        the full stream's pages minus any full pages a live shared
        prefix would map in for free."""

        if not self.paged:
            return True
        need = self.alloc.pages_needed(len(req.prompt) + len(req.out))
        if self.share_prefix:
            _, shared = self._find_share_source(req)
            need -= shared // self.alloc.spec.page_size
        return (need <= self.alloc.spec.pages_per_slot
                and need <= self.alloc.free_pages)

    def shared_prefix_len(self, req: Request) -> int:
        """Tokens a placement of ``req`` would map in via COW sharing
        right now (0 when sharing is off or nothing matches)."""

        if not self.share_prefix:
            return 0
        return self._find_share_source(req)[1]

    def is_share_source(self, slot: int) -> bool:
        """Does ``slot`` map at least one refcount>1 page?"""

        if self.alloc is None:
            return False
        return any(int(self.alloc.refcount[p]) > 1
                   for p in self.alloc.slot_pages(slot))

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
        """Bind ``req`` to ``slot``: recurrent-state hygiene, the COW
        prefix share (paged + ``share_prefix``), the prefill target,
        ``len(prompt) + len(out)`` (so a preempted request re-prefills
        its generated tokens too and resumes where it left off), and an
        enc-dec request's cross K/V.  A reused ring or page keeps the
        previous occupant's K/V: positions at or past the new request's
        own count are masked until overwritten."""

        self.slot_req[slot] = req
        self._slot_seq[slot] = self._seq
        self._seq += 1
        if self._slot_dirty[slot]:
            self._reset_recurrent_state(slot)
            self._slot_dirty[slot] = False
        req._prefill_target = (len(req.prompt)  # type: ignore[attr-defined]
                               + len(req.out))
        start = 0
        if self.share_prefix:
            src, shared = self._find_share_source(req)
            if src is not None and self.alloc.share(src, slot, shared):
                start = shared
                req.shared_prefix = max(req.shared_prefix, shared)
                self.share_hits += 1
                self.shared_tokens += shared
        self.slot_pos[slot] = start
        req._cursor = start  # type: ignore[attr-defined]
        frames = getattr(req, "_frames", None)
        if self.api.cfg.is_encdec and frames is not None:
            self._encode(slot, frames)
        if self.obs is not None:
            self.obs.on_admit(self, req, slot, start)

    def _encode(self, slot: int, frames: Any) -> None:
        """Run the encoder over one request's frames and write every
        decoder layer's cross K/V into ``slot``, in place (the slot is
        this request's alone)."""

        leaf = self.params["embed"]
        if isinstance(frames, torch.Tensor):
            frames = frames.to(device=leaf.device, dtype=leaf.dtype)
        else:
            frames = torch.tensor(np.asarray(frames), dtype=leaf.dtype,
                                  device=leaf.device)
        kv = self.api.encode_cross_kv(self.params, frames[None])
        for name, buf in self.state["xattn"].items():
            buf[:, slot] = kv[name][:, 0].to(buf.dtype)

    def _reset_recurrent_state(self, slot: int) -> None:
        """Zero a reused slot's SSM state (h and the conv ring), in place:
        position masking hides a reused ring's stale K/V, but the
        recurrence has no position, so a new request must not start from
        the previous one's state.  Only the recurrent leaves of ``slot``
        are touched (dense models pay nothing)."""

        for entry in self.state["blocks"].values():
            for buf in entry.get("ssm", {}).values():
                buf[:, slot] = 0

    def _backed_prefix(self, slot: int) -> int:
        """Tokens from position 0 whose pages ``slot`` still maps (the SWA
        trim can have freed low pages: those positions cannot be shared
        from)."""

        n = 0
        for p in self.alloc.page_table[slot]:
            if p == NO_PAGE:
                break
            n += 1
        return n * self.alloc.spec.page_size

    def _find_share_source(self, req: Request) -> tuple[int | None, int]:
        """The live slot with the longest written, still-backed common
        prefix against ``req``'s stream, capped one short of the stream
        (at least one token must prefill to emit the next).  Sub-page
        matches return (None, 0): they would save no whole page and
        immediately pay a COW copy."""

        stream = req.prompt + req.out
        cap = len(stream) - 1
        best, best_len = None, 0
        for s in range(self.batch):
            src = self.slot_req[s]
            if src is None:
                continue
            written = (src.prompt + src.out)[:int(self.slot_pos[s])]
            m = min(len(written), cap, self._backed_prefix(s))
            n = 0
            while n < m and stream[n] == written[n]:
                n += 1
            if n > best_len:
                best, best_len = s, n
        if best_len < self.alloc.spec.page_size:
            return None, 0
        return best, best_len

    def _preempt(self, slot: int, reason: str = "slo-preempt") -> None:
        """Evict ``slot`` mid-flight: its pages released (refcounts
        decremented; pages shared with other slots survive), the request
        back at the FRONT of the queue with prompt and generated tokens
        intact.  ``reason`` (policy preemption or page-OOM defer) is for
        observability only."""

        req = self.slot_req[slot]
        req._cursor = 0  # type: ignore[attr-defined]
        req.preempted += 1
        self.queue.insert(0, req)
        if self.paged:
            self.alloc.release(slot)
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        self._slot_dirty[slot] = True
        if self.obs is not None:
            self.obs.on_preempt(self, req, slot, reason)

    def _evict_for(self, slot: int) -> int | None:
        """Page-OOM backpressure: the policy names a victim, the engine
        preempts it.  Returns the victim (None = nothing live)."""

        victim = self.scheduler.victim(self)
        if victim is not None:
            self._preempt(victim, reason="oom-defer")
            self.deferrals += 1
        return victim

    def _ensure_pages(self, slot: int, n_tokens: int) -> bool:
        """Back ``slot`` through ``n_tokens`` positions, evicting
        policy-chosen victims until the allocation fits; False when
        ``slot`` itself was evicted (skip it this tick)."""

        while not self.alloc.ensure(slot, n_tokens):
            victim = self._evict_for(slot)
            if victim is None or victim == slot:
                return False
        return True

    def _cow_range(self, slot: int, start: int,
                   end: int) -> list[tuple[int, int]]:
        """Break page sharing before ``slot`` writes positions
        ``[start, end)``, with the eviction backpressure of
        :meth:`_ensure_pages` when the copy needs pages the free list
        lacks.  Returns the (src, dst) pairs for :meth:`_copy_pages`
        (empty when nothing was shared or ``slot`` itself was
        evicted)."""

        while True:
            pairs = self.alloc.cow_pages(slot, start, end)
            if pairs is not None:
                return pairs
            victim = self._evict_for(slot)
            if victim is None or victim == slot:
                return []

    def _copy_pages(self, pairs: list[tuple[int, int]]) -> None:
        """Device half of COW: clone the src pages' K/V into the fresh dst
        pages of every block's pool (page dim = axis 1 of the stacked
        leaves), in place.  The table already points at dst; positions
        beyond the writer's own count hold the source's K/V, which the
        position mask keeps unattended until overwritten."""

        src = torch.tensor([p[0] for p in pairs], device=self.device)
        dst = torch.tensor([p[1] for p in pairs], device=self.device)
        for entry in self.state["blocks"].values():
            for buf in entry["kv"].values():
                # verify: waive(pool-write) -- the write touches only the
                # dst pages, which cow_pages just took off the free list
                # for this writer alone (refcount 1, in no other table);
                # the shared src pages are only read
                buf[:, dst] = buf[:, src]
        self.cow_copies += len(pairs)

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
            self._slot_dirty[slot] = True
            if self.paged:
                self.alloc.release(slot)
            if self.obs is not None:
                self.obs.on_retire(self, req, slot)

    def kv_stats(self) -> dict[str, float]:
        """Cache occupancy snapshot: live tokens against reserved
        capacity (plus the allocator's fragmentation and sharing, and the
        eviction counters, in paged mode)."""

        live = sum(int(self.slot_pos[s]) for s in range(self.batch)
                   if self.slot_req[s] is not None)
        if not self.paged:
            cap = self.batch * self.context
            return {"live_tokens": float(live), "capacity_tokens": float(cap),
                    "occupancy": live / cap if cap else 0.0,
                    "deferrals": 0.0, "peak_active": float(self.peak_active)}
        st = self.alloc.stats(live_tokens=live)
        st["capacity_tokens"] = float(self.alloc.spec.pool_tokens)
        st["deferrals"] = float(self.deferrals)
        st["peak_active"] = float(self.peak_active)
        st["peak_used_pages"] = float(self.peak_used_pages)
        return st

    def stats(self) -> dict[str, float]:
        """Per-drain engine counters: ticks, tokens, batch occupancy,
        prefill chunks, what the policy did (evictions, COW sharing) and
        how speculation performed."""

        g = self.tokens_generated
        return {
            "ticks": float(self.ticks),
            "tokens_generated": float(g),
            "ticks_per_token": (self.ticks / g) if g else 0.0,
            "mean_active": (self.slot_ticks / self.ticks
                            if self.ticks else 0.0),
            "prefill_chunks": float(self.prefill_chunks),
            "deferrals": float(self.deferrals),
            "preemptions": float(self.preemptions),
            "peak_active": float(self.peak_active),
            "peak_used_pages": float(self.peak_used_pages),
            "share_hits": float(self.share_hits),
            "shared_tokens": float(self.shared_tokens),
            "cow_copies": float(self.cow_copies),
            "spec_ticks": float(self.spec_ticks),
            "spec_proposed": float(self.spec_proposed),
            "spec_accepted": float(self.spec_accepted),
            "accept_rate": (self.spec_accepted / self.spec_proposed
                            if self.spec_proposed else 0.0),
        }

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        # verify: waive(alias-dispatch) -- every caller passes a buffer
        # it built with np.zeros this tick and never writes after the
        # step is issued (the lint checks each _tensor(...) call site)
        return torch.from_numpy(a).to(self.device)

    def _propose_drafts(self) -> dict[int, list[int]]:
        """Host-side draft proposals for this tick's decoding slots.
        Depth is capped so emission never overshoots ``max_new`` or the
        context (cap ``d``: up to ``d+1`` tokens emitted, and the verify
        chunk covers positions ``pos..pos+d``), so the spec path retires
        at exactly the baseline stopping point."""

        drafts: dict[int, list[int]] = {}
        if self.drafter is None:
            return drafts
        for s in range(self.batch):
            req = self.slot_req[s]
            if req is None or self._phase(s) != "decode":
                continue
            pos = int(self.slot_pos[s])
            cap = min(self.spec_depth,
                      req.max_new - len(req.out) - 1,
                      self.context - 2 - pos)
            if cap < 1:
                continue
            d = self.drafter.propose(req.prompt + req.out, cap)[:cap]
            if d:
                drafts[s] = [int(t) for t in d]
        return drafts

    def _back_pages(self, drafts: dict[int, list[int]]) -> None:
        """Paged mode: back every live slot's positions for this tick, in
        admission order, and break COW sharing for every position about
        to be written.  A slot the allocator cannot cover, even after
        evicting every policy-offered victim, is itself evicted and sits
        the tick out.  A draft is backed opportunistically: it shrinks to
        what the free list covers and never evicts a neighbour that a
        plain decode would not."""

        cow_pairs: list[tuple[int, int]] = []
        order = sorted((s for s in range(self.batch)
                        if self.slot_req[s] is not None),
                       key=lambda s: self._slot_seq[s])
        for s in order:
            req = self.slot_req[s]
            if req is None:          # evicted as an earlier victim
                continue
            pos = int(self.slot_pos[s])
            if self._phase(s) == "decode":
                end = pos + 1
                if s in drafts:
                    dr = drafts.pop(s)
                    for dd in range(len(dr), 0, -1):
                        if self.alloc.ensure(s, pos + dd + 1):
                            drafts[s] = dr[:dd]
                            end = pos + dd + 1
                            break
                if s not in drafts and not self._ensure_pages(s, pos + 1):
                    continue
            else:
                cur = req._cursor  # type: ignore[attr-defined]
                end = pos + min(self.prefill_chunk,
                                req._prefill_target - cur)
                if not self._ensure_pages(s, end):
                    continue
            if self.share_prefix and self.slot_req[s] is req:
                cow_pairs.extend(self._cow_range(s, pos, end))
        if cow_pairs:
            ob = self.obs
            t0 = (ob.phase_begin("cow_copy", self.ticks)
                  if ob is not None else 0.0)
            self._copy_pages(cow_pairs)
            if ob is not None:
                ob.phase_end("cow_copy", self.ticks, t0, sync=self.state,
                             pages=len(cow_pairs))
        self.peak_used_pages = max(self.peak_used_pages,
                                   self.alloc.used_pages)

    def tick(self) -> int:
        """One engine iteration; returns number of active slots.

        Decoding slots advance one token through ``decode_step``, or,
        with a draft, verify it and commit the accepted tokens;
        prefilling slots advance up to ``prefill_chunk`` stream tokens
        through ``prefill_step``: the chunk that consumes a stream's last
        token also yields the request's next generated token, exactly as
        the tokenwise tick that fed that token would have."""

        with span("serve.tick", clock=None):
            return self._tick()

    def _tick(self) -> int:
        ob = self.obs
        if ob is not None:
            ob.on_tick_open(self)
        with span("serve.admit", clock="host"):
            self._admit()
        drafts = self._propose_drafts()
        if self.paged:
            with span("serve.back_pages", clock="host"):
                self._back_pages(drafts)
        active = [s for s in range(self.batch) if self.slot_req[s] is not None]
        self.peak_active = max(self.peak_active, len(active))
        if not active:
            if ob is not None:
                ob.on_tick_cancel(self)
            return 0
        self.ticks += 1
        self.slot_ticks += len(active)
        if ob is not None:
            ob.on_tick_begin(self, self.ticks)
        decode = [s for s in active if self._phase(s) == "decode"]
        spec = [s for s in decode if s in drafts]
        decode = [s for s in decode if s not in drafts]
        prefill = [s for s in active if self._phase(s) == "prefill"]
        extra = ((_snapshot(self.alloc.page_table, self.device),)
                 if self.paged else ())

        if decode:
            with span("serve.decode", clock=None):
                if ob is not None:
                    t0 = ob.phase_begin("decode", self.ticks)
                    # each slot's query reads its slot_pos + 1 keys
                    keys = int(self.slot_pos[decode].sum()) + len(decode)
                    called = paged_decode_kernel.calls
                tokens = np.zeros((self.batch, 1), np.int32)
                mask = np.zeros(self.batch, bool)
                for s in decode:
                    tokens[s, 0] = self.slot_req[s].out[-1]
                    mask[s] = True
                with span("serve.dispatch", clock="host"):
                    logits, self.state = self.api.decode_step(
                        self.params, self.state, self._tensor(tokens),
                        _snapshot(self.slot_pos, self.device), *extra,
                        active=self._tensor(mask))
                with span("serve.readback", clock="host"):
                    nxt = logits.argmax(dim=-1).cpu().numpy()
                    for s in decode:
                        req = self.slot_req[s]
                        req._cursor += 1  # type: ignore[attr-defined]
                        self.slot_pos[s] += 1
                        req.out.append(int(nxt[s]))
                        self.tokens_generated += 1
                        self._retire_if_done(s)
                if ob is not None:
                    # the paged decode kernel's calls in the step, a layer
                    ob.phase_end("decode", self.ticks, t0, sync=self.state,
                                 counts={"kv_tokens": keys, "qk_pairs": keys,
                                         "attn_kernel_calls":
                                         paged_decode_kernel.calls - called},
                                 slots=len(decode))

        if spec:
            with span("serve.speculate", clock=None):
                if ob is not None:
                    t0 = ob.phase_begin("speculate", self.ticks)
                self._speculate(spec, drafts, extra)
                if ob is not None:
                    ob.phase_end("speculate", self.ticks, t0, sync=self.state,
                                 slots=len(spec))

        if prefill:
            with span("serve.prefill", clock=None):
                if ob is not None:
                    t0 = ob.phase_begin("prefill", self.ticks)
                T = self.prefill_chunk
                # row i of the step is slot rows[i]
                rows = (prefill if self._prefill_rows_only
                        else list(range(self.batch)))
                row = {s: i for i, s in enumerate(rows)}
                tokens = np.zeros((len(rows), T), np.int32)
                lengths = np.zeros(len(rows), np.int32)
                for s in prefill:
                    req = self.slot_req[s]
                    cur = req._cursor  # type: ignore[attr-defined]
                    # the stream includes generated tokens: a preempted
                    # request re-prefills prompt + out and resumes exactly
                    stream = req.prompt + req.out
                    n = min(T, req._prefill_target - cur)
                    tokens[row[s], :n] = stream[cur:cur + n]
                    lengths[row[s]] = n
                if ob is not None:
                    counts = _prefill_counts(
                        self.slot_pos[prefill],
                        lengths[[row[s] for s in prefill]], len(rows) * T)
                with span("serve.dispatch", clock="host"):
                    pos = _snapshot(self.slot_pos[rows], self.device)
                    table = ((_snapshot(self.alloc.page_table[rows],
                                        self.device),) if self.paged else ())
                    logits, self.state = self.api.prefill_step(
                        self.params, self.state, self._tensor(tokens), pos,
                        self._tensor(lengths), *table)
                with span("serve.readback", clock="host"):
                    nxt = logits.argmax(dim=-1).cpu().numpy()
                    self.prefill_chunks += len(prefill)
                    for s in prefill:
                        req = self.slot_req[s]
                        n = int(lengths[row[s]])
                        req._cursor += n  # type: ignore[attr-defined]
                        self.slot_pos[s] += n
                        if req._cursor >= req._prefill_target:
                            req.out.append(int(nxt[row[s]]))
                            self.tokens_generated += 1
                            self._retire_if_done(s)
                if ob is not None:
                    ob.phase_end("prefill", self.ticks, t0, sync=self.state,
                                 counts=counts, slots=len(prefill))

        # sliding-window reclamation: pages whose positions all fell out
        # of the window are never attended again; the next tick's
        # earliest attended position is slot_pos - window + 1
        if self.paged and self.api.cfg.window is not None:
            w = self.api.cfg.window
            for s in range(self.batch):
                if self.slot_req[s] is not None:
                    self.alloc.trim(s, max(0, int(self.slot_pos[s]) - w + 1))
        if ob is not None:
            ob.on_tick_end(self, self.ticks, n_decode=len(decode),
                           n_spec=len(spec), n_prefill=len(prefill))
        return len(active)

    def _speculate(self, spec: list[int], drafts: dict[int, list[int]],
                   extra: tuple) -> None:
        """Verify the chunk [pending token, drafts...] at absolute
        positions pos..pos+d in one forward, accept the longest prefix of
        drafts matching the verifier's own greedy picks (plus its bonus
        token), then COMMIT exactly the accepted tokens with a
        length-gated ``prefill_step``; ``verify_step`` writes no state."""

        D1 = self.spec_depth + 1
        tokens = np.zeros((self.batch, D1), np.int32)
        lengths = np.zeros(self.batch, np.int32)
        for s in spec:
            dr = drafts[s]
            tokens[s, 0] = self.slot_req[s].out[-1]
            tokens[s, 1:1 + len(dr)] = dr
            lengths[s] = len(dr) + 1
        tok, pos = self._tensor(tokens), _snapshot(self.slot_pos, self.device)
        logits, _ = self.api.verify_step(self.params, self.state, tok, pos,
                                         self._tensor(lengths), *extra)
        greedy = logits.argmax(dim=-1).cpu().numpy()        # (B, D1)
        commit = np.zeros(self.batch, np.int32)
        emitted: dict[int, list[int]] = {}
        for s in spec:
            dr = drafts[s]
            k = 0
            while k < len(dr) and int(greedy[s, k]) == dr[k]:
                k += 1
            emitted[s] = dr[:k] + [int(greedy[s, k])]
            commit[s] = k + 1
            req = self.slot_req[s]
            req.spec_proposed += len(dr)
            req.spec_accepted += k
            self.spec_proposed += len(dr)
            self.spec_accepted += k
        _, self.state = self.api.prefill_step(self.params, self.state, tok,
                                              pos, self._tensor(commit),
                                              *extra)
        self.spec_ticks += 1
        for s in spec:
            req = self.slot_req[s]
            e = int(commit[s])
            req._cursor += e  # type: ignore[attr-defined]
            self.slot_pos[s] += e
            req.out.extend(emitted[s])
            self.tokens_generated += e
            if self.paged:
                # hand back pages taken for rejected positions: the table
                # must match a never-speculated drain
                self.alloc.rewind(s, int(self.slot_pos[s]))
            self._retire_if_done(s)

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self.queue:
                return
        raise RuntimeError("serving did not drain")


# the serving tunables and their harnesses live in runtime/tunables.py
# (the policies in runtime/scheduler.py); re-exported here as the
# reference's runtime.serve does, so its import paths work on the port

from .scheduler import SCHEDULER_KINDS  # noqa: E402,F401
from .tunables import (K_AND_V, KV_CACHE_BYTES,  # noqa: E402,F401
                       DecodeBatchTunable, KVPageTunable,
                       PrefillChunkTunable, SchedulerTunable,
                       _require_model, choose_batch, choose_kv_page,
                       choose_prefill_chunk, choose_scheduler,
                       decode_batch_tunable, kv_cache_stream_s,
                       kv_page_tunable, prefill_chunk_tunable,
                       scheduler_tunable, timed_server_drain,
                       timed_trace_drain)

__all__ = ["Server", "Request", "Scheduler", "make_scheduler",
           "SCHEDULER_KINDS",
           "DecodeBatchTunable", "PrefillChunkTunable", "KVPageTunable",
           "SchedulerTunable", "decode_batch_tunable",
           "prefill_chunk_tunable", "kv_page_tunable", "scheduler_tunable",
           "choose_batch", "choose_prefill_chunk", "choose_kv_page",
           "choose_scheduler", "kv_cache_stream_s", "timed_server_drain",
           "timed_trace_drain"]
