"""The concrete half of the server model: a device-free mirror of
:class:`repro_torch.runtime.serve.Server`'s paged bookkeeping (the port's
copy of ``repro.verify.harness``).

The scheduler × server model needs the *real* policy objects
(:mod:`repro_torch.runtime.scheduler`) and the *real*
:class:`~repro_torch.runtime.kv.PagedKVAllocator` making decisions inside
every abstract transition — otherwise the model would re-implement the
policies and verify the re-implementation instead of the shipped code.
:class:`MiniServer` keeps the server's control flow line-for-line
(admission → per-slot page ensure in admission order → decode/prefill
advance → retirement) but strips the device halves: no model steps, no
KV tensors, synthetic generated tokens.  Documented divergences from
``Server.tick``:

* no speculation (the speculate-commit-rewind cycle is its own model,
  :class:`repro_torch.verify.models.SpecSemantics`),
* no sliding-window trim (``api.cfg.window`` is None for the modeled
  dense configs),
* no encoder-decoder frames and no recurrent-state hygiene (device
  state does not exist here),
* generated tokens come from ``scenario.gen`` instead of logits — the
  scheduling/paging state machine never reads token *values* except
  for prefix matching, which the scenario controls.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..runtime.kv import NO_PAGE, PagedKVAllocator, PagedKVSpec
from ..runtime.scheduler import make_scheduler


def restore_allocator(alloc: PagedKVAllocator, proj: tuple) -> PagedKVAllocator:
    """Overwrite ``alloc``'s mutable state with a
    :meth:`~repro_torch.runtime.kv.PagedKVAllocator.project` projection —
    the inverse direction of the shared trace vocabulary, used to
    reconstruct the real allocator at any explored model state."""

    pt, ref, own, free, top = proj
    alloc.page_table[:] = np.array(pt, np.int32)
    alloc.refcount[:] = np.array(ref, np.int32)
    alloc.owner[:] = np.array(own, np.int32)
    alloc._free = list(free)
    alloc._top[:] = np.array(top, np.int64)
    return alloc


def empty_projection(n_slots: int, spec: PagedKVSpec) -> tuple:
    """The projection of a freshly-constructed allocator."""

    return (
        tuple((NO_PAGE,) * spec.pages_per_slot for _ in range(n_slots)),
        (0,) * spec.n_pages,
        (NO_PAGE,) * spec.n_pages,
        tuple(range(spec.n_pages - 1, -1, -1)),
        (-1,) * n_slots,
    )


def canon_pages(proj: tuple) -> tuple:
    """Quotient a projection by physical-page renaming (SPIN-style
    symmetry reduction).  Pages are relabeled in first-occurrence order
    — page-table row-major, then the free list in POP order, then any
    leaked page — which maps the initial projection to itself and is
    idempotent.

    Soundness: the op vocabulary names slots and token counts, never
    page ids, and every allocator rule (LIFO pop, owner handoff by slot
    order, refcount tests) is equivariant under page renaming, so each
    canonical reachable state represents its whole renaming orbit and
    every invariant in :mod:`repro_torch.verify.invariants` is
    renaming-symmetric.  The price: a hypothetical bug that special-
    cases a concrete page id would be invisible — that class is covered
    by the exact-mode (non-canonical) conformance paths and the
    randomized direct tests."""

    pt, ref, own, free, top = proj
    n_pages = len(ref)
    rename: dict[int, int] = {}
    for row in pt:
        for p in row:
            if p != NO_PAGE and p not in rename:
                rename[p] = len(rename)
    for p in reversed(free):          # pop order: free[-1] pops first
        if p not in rename:
            rename[p] = len(rename)
    for p in range(n_pages):          # leaked pages (mutant states)
        if p not in rename:
            rename[p] = len(rename)
    new_ref = [0] * n_pages
    new_own = [NO_PAGE] * n_pages
    for p in range(n_pages):
        q = rename[p]
        new_ref[q] = ref[p]
        new_own[q] = own[p]
    return (
        tuple(tuple(NO_PAGE if p == NO_PAGE else rename[p] for p in row)
              for row in pt),
        tuple(new_ref),
        tuple(new_own),
        tuple(rename[p] for p in free),
        tuple(top),
    )


# ---------------------------------------------------------------------------
# scenario / config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServerScenario:
    """A bounded request mix: the model nondeterministically interleaves
    these arrivals (in order) with engine ticks."""

    name: str
    prompts: tuple[tuple[int, ...], ...]
    max_new: tuple[int, ...]
    slo: tuple[str, ...] = ()
    deadline: tuple[float | None, ...] = ()

    @property
    def n_requests(self) -> int:
        return len(self.prompts)

    def slo_of(self, rid: int) -> str:
        return self.slo[rid] if self.slo else "interactive"

    def deadline_of(self, rid: int) -> float | None:
        return self.deadline[rid] if self.deadline else None

    def gen(self, rid: int, i: int) -> int:
        """Deterministic synthetic generated token: per-request constant
        so two requests' outputs never accidentally extend a shared
        prefix the scenario didn't plan."""

        return 100 + rid


@dataclass(frozen=True)
class ServerConfig:
    """Bounded slot/page configuration for the scheduler × server model."""

    policy: str = "fcfs"
    batch: int = 3
    page_size: int = 2
    pages_per_slot: int = 3
    n_pages: int = 6
    prefill_chunk: int = 2
    age_limit: int = 2
    share_prefix: bool = False
    # liveness bounds (ghost-counter encodings of "eventually"):
    # consecutive ticks the oldest live slot may fail to make fresh
    # progress, and how far past age_limit skips may run (priority's
    # aged-pool picks bump other aged entries; fcfs/prefix never do)
    stall_bound: int = 4
    aging_slack: int = 0

    @property
    def context(self) -> int:
        return self.page_size * self.pages_per_slot

    def kv_spec(self) -> PagedKVSpec:
        return PagedKVSpec(n_pages=self.n_pages, page_size=self.page_size,
                           pages_per_slot=self.pages_per_slot)

    def make_scheduler(self):
        return make_scheduler(self.policy, age_limit=self.age_limit)


@dataclass
class VReq:
    """Request mirror: the fields the scheduler contract and the paged
    bookkeeping actually read (``_cursor``/``_prefill_target`` become
    plain attributes)."""

    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)
    done: bool = False
    slo: str = "interactive"
    deadline: float | None = None
    skips: int = 0
    preempted: int = 0
    shared_prefix: int = 0
    cursor: int = 0
    target: int = 0


# ---------------------------------------------------------------------------
# the server mirror
# ---------------------------------------------------------------------------


class MiniServer:
    """Paged-serving bookkeeping with the device halves stripped; every
    control-flow decision is delegated to the REAL scheduler policy and
    the REAL page allocator (or a planted mutant)."""

    def __init__(self, cfg: ServerConfig, scenario: ServerScenario, *,
                 allocator_cls: type[PagedKVAllocator] = PagedKVAllocator):
        self.cfg = cfg
        self.scenario = scenario
        self.batch = cfg.batch
        self.context = cfg.context
        self.prefill_chunk = cfg.prefill_chunk
        self.share_prefix = cfg.share_prefix
        self.paged = True
        self.alloc = allocator_cls(cfg.kv_spec(), cfg.batch)
        self.scheduler = cfg.make_scheduler()
        self.requests: dict[int, VReq] = {}
        self.queue: list[VReq] = []
        self.completed: list[VReq] = []
        self.slot_req: list[VReq | None] = [None] * cfg.batch
        self.slot_pos = [0] * cfg.batch
        self._slot_seq = [0] * cfg.batch
        self._seq = 0
        self.nsub = 0

    # -- arrivals -----------------------------------------------------------

    def submit(self, rid: int) -> VReq:
        req = VReq(rid=rid, prompt=list(self.scenario.prompts[rid]),
                   max_new=self.scenario.max_new[rid],
                   slo=self.scenario.slo_of(rid),
                   deadline=self.scenario.deadline_of(rid))
        self.requests[rid] = req
        self.queue.append(req)
        self.nsub = max(self.nsub, rid + 1)
        return req

    # -- scheduler-facing queries (the policy contract, as in serve.py) -----

    def live_slots(self) -> list[int]:
        return [s for s in range(self.batch) if self.slot_req[s] is not None]

    def has_free_slot(self) -> bool:
        return any(r is None for r in self.slot_req)

    def slot_seq(self, slot: int) -> int:
        return int(self._slot_seq[slot])

    def slot_request(self, slot: int) -> VReq | None:
        return self.slot_req[slot]

    def admit_fits(self, req: VReq) -> bool:
        total = len(req.prompt) + len(req.out)
        need = self.alloc.pages_needed(total)
        if self.share_prefix:
            _, shared = self._find_share_source(req)
            need -= shared // self.alloc.spec.page_size
        return (need <= self.alloc.spec.pages_per_slot
                and need <= self.alloc.free_pages)

    def shared_prefix_len(self, req: VReq) -> int:
        if not self.share_prefix:
            return 0
        _, shared = self._find_share_source(req)
        return shared

    def is_share_source(self, slot: int) -> bool:
        return any(int(self.alloc.refcount[p]) > 1
                   for p in self.alloc.slot_pages(slot))

    # -- admission / placement / preemption (serve.py line-for-line) --------

    def _admit(self) -> None:
        for _ in range(self.batch):
            if not self.queue:
                break
            victim = self.scheduler.preempt_for(self)
            if victim is None:
                break
            self._preempt(victim)
        for slot in range(self.batch):
            if self.slot_req[slot] is None and self.queue:
                idx = self.scheduler.pick(self)
                if idx is None:
                    return
                self._place(slot, self.queue.pop(idx))

    def _place(self, slot: int, req: VReq) -> None:
        self.slot_req[slot] = req
        self._slot_seq[slot] = self._seq
        self._seq += 1
        req.target = len(req.prompt) + len(req.out)
        start = 0
        if self.share_prefix:
            src, shared = self._find_share_source(req)
            if src is not None and self.alloc.share(src, slot, shared):
                start = shared
                req.shared_prefix = max(req.shared_prefix, shared)
        self.slot_pos[slot] = start
        req.cursor = start

    def _backed_prefix(self, slot: int) -> int:
        n = 0
        for p in self.alloc.page_table[slot]:
            if p == NO_PAGE:
                break
            n += 1
        return n * self.alloc.spec.page_size

    def _find_share_source(self, req: VReq) -> tuple[int | None, int]:
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

    def _preempt(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.cursor = 0
        req.preempted += 1
        self.queue.insert(0, req)
        self.alloc.release(slot)
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0

    def _evict_for(self, slot: int) -> int | None:
        victim = self.scheduler.victim(self)
        if victim is not None:
            self._preempt(victim)
        return victim

    def _ensure_pages(self, slot: int, n_tokens: int) -> bool:
        while not self.alloc.ensure(slot, n_tokens):
            victim = self._evict_for(slot)
            if victim is None or victim == slot:
                return False
        return True

    def _cow_range(self, slot: int, start: int,
                   end: int) -> list[tuple[int, int]]:
        while True:
            pairs = self.alloc.cow_pages(slot, start, end)
            if pairs is not None:
                return pairs
            victim = self._evict_for(slot)
            if victim is None or victim == slot:
                return []

    def _phase(self, slot: int) -> str:
        req = self.slot_req[slot]
        return "prefill" if req.cursor < req.target else "decode"

    def _retire_if_done(self, slot: int) -> None:
        req = self.slot_req[slot]
        if len(req.out) >= req.max_new or \
                self.slot_pos[slot] >= self.context - 1:
            req.done = True
            self.completed.append(req)
            self.slot_req[slot] = None
            self.alloc.release(slot)

    # -- the tick (serve.py's paged path, device halves stripped) -----------

    def tick(self) -> int:
        self._admit()
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
                if not self._ensure_pages(s, pos + 1):
                    continue
            else:
                n = min(self.prefill_chunk, req.target - req.cursor)
                end = pos + n
                if not self._ensure_pages(s, end):
                    continue
            if self.share_prefix and self.slot_req[s] is req:
                self._cow_range(s, pos, end)
        active = [s for s in range(self.batch)
                  if self.slot_req[s] is not None]
        if not active:
            return 0
        decode = [s for s in active if self._phase(s) == "decode"]
        prefill = [s for s in active if self._phase(s) == "prefill"]
        for s in decode:
            req = self.slot_req[s]
            req.cursor += 1
            self.slot_pos[s] += 1
            req.out.append(self.scenario.gen(req.rid, len(req.out)))
            self._retire_if_done(s)
        for s in prefill:
            req = self.slot_req[s]
            n = min(self.prefill_chunk, req.target - req.cursor)
            req.cursor += n
            self.slot_pos[s] += n
            if req.cursor >= req.target:
                req.out.append(self.scenario.gen(req.rid, len(req.out)))
                self._retire_if_done(s)
        return len(active)


__all__ = ["MiniServer", "ServerConfig", "ServerScenario", "VReq",
           "canon_pages", "restore_allocator", "empty_projection"]
