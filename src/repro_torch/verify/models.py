"""Abstract models of the runtime's three concurrent state machines,
expressed in the Promela-subset substrate (the port's copy of
``repro.verify.models``).

Each model is a single driver proctype of the shape

    loop:  select op in enabled_ops(G)   (nondeterministic adversary)
           apply(G, op)                  (deterministic effect)
           goto loop

so the existing DFS explorer enumerates every reachable interleaving of
runtime operations, and every ``select`` label carries the op tuple —
``driver[0]:1:select=('ensure', 0, 3)`` — which is the shared trace
vocabulary :mod:`repro_torch.verify.conformance` replays against the real
code: the op's first element IS the real allocator method name.

Three machines:

* :class:`AllocatorSemantics` — the paged COW allocator under an
  adversarial op stream (ensure/share/cow_pages/release/rewind/trim),
  a token-for-token mirror of :class:`repro_torch.runtime.kv.PagedKVAllocator`
  including the LIFO free list and the owner-handoff rule,
* :class:`ServerSemantics` — the scheduler × server loop: arrivals from
  a bounded scenario interleaved with engine ticks, where each tick IS
  a :class:`repro_torch.verify.harness.MiniServer` step driven by the real
  policy objects and the real allocator,
* :class:`SpecSemantics` — the speculate-commit-rewind cycle on a
  deliberately tight page pool, mirroring ``Server.tick``'s
  opportunistic draft shrinking and post-commit ``rewind``.

State-space hygiene: globals hold only canonical, bounded values —
allocator state via ``project()``, admission order as a rank
permutation (live slots renumbered 0..k), liveness encoded as bounded
ghost stall/skip counters so every property is a ``G p`` reachability
check (the reduction in :mod:`repro_torch.core.properties`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.promela import Expr, Goto, Model, Proctype, Select
from ..runtime.kv import NO_PAGE, PagedKVAllocator, PagedKVSpec
from .harness import (MiniServer, ServerConfig, ServerScenario, VReq,
                      canon_pages, empty_projection, restore_allocator)


def build_driver_model(sem) -> Model:
    """Wrap a semantics object (``init_globals``/``enabled_ops``/
    ``apply``) into the one-process driver model described above."""

    body = [
        "loop",
        Select(var="op", choices=lambda G, L: sem.enabled_ops(G)),
        Expr(fn=lambda G, L: sem.apply(G, L.pop("op")), label_hint="apply"),
        Goto("loop"),
    ]
    proc = Proctype.compile("driver", body)
    return Model({"driver": proc}, sem.init_globals(), "driver")


# ---------------------------------------------------------------------------
# 1. the paged COW allocator under an adversarial op stream
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AllocConfig:
    """Bounded allocator instance.  The default is intentionally
    over-committed (3 slots x 3 pages > 6 physical pages) so ensure
    failure, eviction pressure and every share/cow interleaving are
    reachable."""

    n_slots: int = 3
    page_size: int = 2
    pages_per_slot: int = 3
    n_pages: int = 6
    share: bool = True
    rewind: bool = True
    trim: bool = True

    @property
    def context(self) -> int:
        return self.page_size * self.pages_per_slot

    def kv_spec(self) -> PagedKVSpec:
        return PagedKVSpec(n_pages=self.n_pages, page_size=self.page_size,
                           pages_per_slot=self.pages_per_slot)


class AllocatorSemantics:
    """Mirror of :class:`~repro_torch.runtime.kv.PagedKVAllocator`'s mutation
    semantics over the canonical projection ``(pt, ref, own, free,
    top)``.  ``apply`` returns exactly what the real method returns so
    conformance can compare op by op; ``legal`` mirrors the real
    method's raise conditions (an op is legal iff the real call returns
    instead of raising)."""

    def __init__(self, cfg: AllocConfig, *, canonical: bool = False):
        self.cfg = cfg
        # canonical=True quotients every post-state by page renaming
        # (harness.canon_pages) — the symmetry reduction that makes
        # exhaustive exploration of over-committed configs tractable.
        # Exact mode (False) tracks concrete page ids and is what
        # direction-2 trace conformance uses.
        self.canonical = canonical

    def observe(self, proj: tuple) -> tuple:
        """Map a REAL allocator projection into this semantics' state
        space (identity in exact mode)."""

        return canon_pages(proj) if self.canonical else proj

    def init_globals(self) -> dict:
        return {"alloc": empty_projection(self.cfg.n_slots, self.cfg.kv_spec())}

    # -- helpers ------------------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(0, n_tokens) // self.cfg.page_size)

    def backed_tokens(self, top: int) -> int:
        return (top + 1) * self.cfg.page_size

    # -- the adversary: a small, canonical op menu --------------------------

    def enabled_ops(self, G: dict) -> list[tuple]:
        """Each distinct *effect* once: ensure targets are one page of
        growth and full backing (any token count mapping to the same
        page count has the identical effect), failing ensures included
        (the all-or-nothing contract is exactly what they test)."""

        c = self.cfg
        pt, ref, own, free, top = G["alloc"]
        ops: list[tuple] = []
        empty = [s for s in range(c.n_slots)
                 if top[s] == -1 and all(p == NO_PAGE for p in pt[s])]
        for s in range(c.n_slots):
            bt = self.backed_tokens(top[s])
            grows = {t for t in (bt + c.page_size, c.context)
                     if bt < t <= c.context}
            for t in sorted(grows):
                ops.append(("ensure", s, t))
            if c.share:
                shared_lps = [lp for lp in range(c.pages_per_slot)
                              if pt[s][lp] != NO_PAGE and ref[pt[s][lp]] > 1]
                if shared_lps:
                    lp = shared_lps[0]
                    # one representative single-page write plus the
                    # everything-at-once range
                    ops.append(("cow_pages", s, lp * c.page_size,
                                lp * c.page_size + 1))
                    ops.append(("cow_pages", s, 0, c.context))
                for d in empty:
                    if d == s or bt <= 0:
                        continue
                    for t in sorted({t for t in (c.page_size,
                                                 c.page_size + 1, bt)
                                     if 1 <= t <= bt}):
                        if self._share_legal(G, s, d, t):
                            ops.append(("share", s, d, t))
            if c.rewind and top[s] >= 0:
                keeps = {0, top[s]}       # drop everything / last page only
                for k in sorted(keeps):
                    ops.append(("rewind", s, k * c.page_size))
            if c.trim:
                for k in (c.page_size, 2 * c.page_size):
                    low = min(k // c.page_size, c.pages_per_slot)
                    if any(pt[s][lp] != NO_PAGE for lp in range(low)):
                        ops.append(("trim", s, k))
            if top[s] >= 0 or any(p != NO_PAGE for p in pt[s]):
                ops.append(("release", s))
        return ops

    # -- legality (the real method returns rather than raises) --------------

    def _share_legal(self, G: dict, src: int, dst: int, t: int) -> bool:
        pt, ref, own, free, top = G["alloc"]
        if t <= 0:
            return True               # real share(n<=0) returns 0
        if top[dst] != -1 or any(p != NO_PAGE for p in pt[dst]):
            return False
        need = self.pages_needed(t)
        if need > self.cfg.pages_per_slot:
            return False
        return all(pt[src][lp] != NO_PAGE for lp in range(need))

    def legal(self, G: dict, op: tuple) -> bool:
        c = self.cfg
        name, args = op[0], op[1:]
        if name == "ensure":
            slot, t = args
            if not 0 <= slot < c.n_slots:
                return False
            return t <= 0 or (t - 1) // c.page_size < c.pages_per_slot
        if name == "share":
            return self._share_legal(G, *args)
        if name in ("cow_pages", "release", "rewind", "trim"):
            return 0 <= args[0] < c.n_slots
        return False

    # -- effect (mutates G in place; returns the real method's return) ------

    def apply(self, G: dict, op: tuple):
        c = self.cfg
        ps = c.page_size
        pt = [list(r) for r in G["alloc"][0]]
        ref = list(G["alloc"][1])
        own = list(G["alloc"][2])
        free = list(G["alloc"][3])
        top = list(G["alloc"][4])

        def deref(page: int) -> bool:
            ref[page] -= 1
            if ref[page] <= 0:
                ref[page] = 0
                own[page] = NO_PAGE
                free.append(page)
                return True
            if page not in pt[own[page]]:
                # owner handoff: first holder in slot order (argwhere)
                holder = next((s for s in range(c.n_slots)
                               if page in pt[s]), NO_PAGE)
                own[page] = holder
            return False

        name, args = op[0], op[1:]
        ret: object
        if name == "ensure":
            slot, t = args
            if t <= 0:
                ret = True
            else:
                top_needed = (t - 1) // ps
                grow = top_needed - top[slot]
                if grow <= 0:
                    ret = True
                elif grow > len(free):
                    ret = False
                else:
                    for lp in range(top[slot] + 1, top_needed + 1):
                        page = free.pop()
                        pt[slot][lp] = page
                        own[page] = slot
                        ref[page] = 1
                    top[slot] = top_needed
                    ret = True
        elif name == "share":
            src, dst, t = args
            if t <= 0:
                ret = 0
            else:
                need = self.pages_needed(t)
                for lp in range(need):
                    page = pt[src][lp]
                    pt[dst][lp] = page
                    ref[page] += 1
                top[dst] = need - 1
                ret = need
        elif name == "cow_pages":
            slot, start, end = args
            if end <= start:
                ret = ()
            else:
                lo = start // ps
                hi = min((end - 1) // ps, c.pages_per_slot - 1)
                todo = [lp for lp in range(lo, hi + 1)
                        if pt[slot][lp] != NO_PAGE and ref[pt[slot][lp]] > 1]
                if len(todo) > len(free):
                    ret = None
                else:
                    pairs = []
                    for lp in todo:
                        old = pt[slot][lp]
                        new = free.pop()
                        pt[slot][lp] = new
                        own[new] = slot
                        ref[new] = 1
                        deref(old)
                        pairs.append((old, new))
                    ret = tuple(pairs)
        elif name == "release":
            (slot,) = args
            pages = [p for p in pt[slot] if p != NO_PAGE]
            pt[slot] = [NO_PAGE] * c.pages_per_slot
            top[slot] = -1
            for page in pages:
                deref(page)
            ret = len(pages)
        elif name == "rewind":
            slot, t = args
            keep = self.pages_needed(t)
            freed = 0
            for lp in range(keep, top[slot] + 1):
                page = pt[slot][lp]
                if page != NO_PAGE:
                    pt[slot][lp] = NO_PAGE
                    if deref(page):
                        freed += 1
            top[slot] = min(top[slot], keep - 1)
            ret = freed
        elif name == "trim":
            slot, keep_from = args
            freed = 0
            for lp in range(min(keep_from // ps, c.pages_per_slot)):
                page = pt[slot][lp]
                if page != NO_PAGE:
                    pt[slot][lp] = NO_PAGE
                    if deref(page):
                        freed += 1
            ret = freed
        else:  # pragma: no cover - defensive
            raise ValueError(f"unknown allocator op {op!r}")

        post = (tuple(tuple(r) for r in pt), tuple(ref), tuple(own),
                tuple(free), tuple(top))
        G["alloc"] = canon_pages(post) if self.canonical else post
        return ret


# ---------------------------------------------------------------------------
# 2. the scheduler x server loop
# ---------------------------------------------------------------------------


class ServerSemantics:
    """Arrivals interleaved with engine ticks; each tick decodes the
    globals into a :class:`MiniServer` (real scheduler + real
    allocator), runs one real tick, and re-encodes — so the explored
    state machine IS the shipped admission/eviction/aging logic.

    Per-request tuple: ``(status, skips, n_out, cursor, target)`` with
    status 0=unsubmitted, 1=queued, 2=live, 3=done; skips normalized to
    0 outside the queue (it is only read there).  Liveness ghosts:
    ``maxout[rid]`` (progress-keeps monotone check), ``hicur[rid]``
    (deepest prefill ever reached — re-prefilling after preemption only
    counts as fresh progress once it passes the old high-water mark),
    ``stall`` (consecutive ticks the oldest live slot made no fresh
    progress).  ``err`` is a sticky violation bitmask (bit 0: a
    generated-token count decreased)."""

    def __init__(self, cfg: ServerConfig, scenario: ServerScenario, *,
                 canonical: bool = True,
                 allocator_cls: type[PagedKVAllocator] = PagedKVAllocator):
        self.cfg = cfg
        self.scenario = scenario
        # page-renaming quotient on the embedded allocator state; every
        # scheduler/placement decision is id-free, so this is sound
        # (see harness.canon_pages) and collapses free-list orderings.
        self.canonical = canonical
        # a mutants.* class here plants the bug inside every tick
        self.allocator_cls = allocator_cls

    def init_globals(self) -> dict:
        n = self.scenario.n_requests
        b = self.cfg.batch
        return {
            "rq": ((0, 0, 0, 0, 0),) * n,
            "queue": (),
            "slots": (-1,) * b,
            "pos": (0,) * b,
            "rank": (-1,) * b,
            "alloc": empty_projection(b, self.cfg.kv_spec()),
            "nsub": 0,
            "maxout": (0,) * n,
            "hicur": (0,) * n,
            "stall": 0,
            "err": 0,
        }

    def enabled_ops(self, G: dict) -> list[tuple]:
        ops: list[tuple] = []
        if G["nsub"] < self.scenario.n_requests:
            ops.append(("submit", G["nsub"]))
        if G["queue"] or any(r >= 0 for r in G["slots"]):
            ops.append(("tick",))
        return ops

    # -- globals <-> MiniServer ---------------------------------------------

    def decode(self, G: dict) -> MiniServer:
        ms = MiniServer(self.cfg, self.scenario,
                        allocator_cls=self.allocator_cls)
        ms.nsub = G["nsub"]
        for rid, (st, skips, n_out, cursor, target) in enumerate(G["rq"]):
            if st == 0:
                continue
            req = ms.requests[rid] = VReq(
                rid=rid, prompt=list(self.scenario.prompts[rid]),
                max_new=self.scenario.max_new[rid],
                out=[self.scenario.gen(rid, i) for i in range(n_out)],
                done=(st == 3), slo=self.scenario.slo_of(rid),
                deadline=self.scenario.deadline_of(rid),
                skips=skips, cursor=cursor, target=target)
            if st == 3:
                ms.completed.append(req)
        ms.queue = [ms.requests[r] for r in G["queue"]]
        live = [(G["rank"][s], s) for s in range(self.cfg.batch)
                if G["slots"][s] >= 0]
        for rank, s in live:
            ms.slot_req[s] = ms.requests[G["slots"][s]]
            ms.slot_pos[s] = G["pos"][s]
            ms._slot_seq[s] = rank
        ms._seq = len(live)
        restore_allocator(ms.alloc, G["alloc"])
        return ms

    def encode(self, ms: MiniServer, G: dict) -> None:
        queued = {r.rid for r in ms.queue}
        live_by_rid = {r.rid: s for s, r in enumerate(ms.slot_req)
                       if r is not None}
        rq = []
        for rid in range(self.scenario.n_requests):
            req = ms.requests.get(rid)
            if req is None:
                rq.append((0, 0, 0, 0, 0))
            elif req.done:
                rq.append((3, 0, len(req.out), 0, 0))
            elif rid in queued:
                rq.append((1, req.skips, len(req.out), 0, 0))
            elif rid in live_by_rid:
                rq.append((2, 0, len(req.out), req.cursor, req.target))
            else:  # pragma: no cover - defensive
                raise AssertionError(f"request {rid} in limbo")
        # canonical admission order: live slots renumbered by rank so
        # the monotonically-growing _seq never enters the state
        order = sorted((s for s in range(self.cfg.batch)
                        if ms.slot_req[s] is not None),
                       key=lambda s: ms._slot_seq[s])
        rank = [-1] * self.cfg.batch
        for i, s in enumerate(order):
            rank[s] = i
        G["rq"] = tuple(rq)
        G["queue"] = tuple(r.rid for r in ms.queue)
        G["slots"] = tuple(r.rid if r is not None else -1
                           for r in ms.slot_req)
        G["pos"] = tuple(int(p) for p in ms.slot_pos)
        G["rank"] = tuple(rank)
        proj = ms.alloc.project()
        G["alloc"] = canon_pages(proj) if self.canonical else proj
        G["nsub"] = ms.nsub

    # -- effect -------------------------------------------------------------

    def apply(self, G: dict, op: tuple) -> None:
        ms = self.decode(G)
        if op[0] == "submit":
            ms.submit(op[1])
            self.encode(ms, G)
            return
        # snapshot for the liveness ghosts
        pre = {rid: (t[2], G["hicur"][rid])
               for rid, t in enumerate(G["rq"])}
        oldest = next((s for s in range(self.cfg.batch)
                       if G["rank"][s] == 0), None)
        oldest_rid = G["slots"][oldest] if oldest is not None else None
        ms.tick()
        self.encode(ms, G)
        maxout = list(G["maxout"])
        hicur = list(G["hicur"])
        err = G["err"]
        for rid in range(self.scenario.n_requests):
            req = ms.requests.get(rid)
            n_out = len(req.out) if req is not None else 0
            if n_out < maxout[rid]:
                err |= 1          # generated progress was lost
            maxout[rid] = max(maxout[rid], n_out)
            if req is not None:
                hicur[rid] = max(hicur[rid], req.cursor)
        if oldest_rid is not None:
            req = ms.requests[oldest_rid]
            pre_out, pre_hi = pre[oldest_rid]
            progressed = (len(req.out) > pre_out or req.done
                          or hicur[oldest_rid] > pre_hi)
            G["stall"] = 0 if progressed else G["stall"] + 1
        else:
            G["stall"] = 0
        G["maxout"] = tuple(maxout)
        G["hicur"] = tuple(hicur)
        G["err"] = err


# ---------------------------------------------------------------------------
# 3. the speculate-commit-rewind cycle
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpecConfig:
    """Two slots on a deliberately tight pool: slot 0 speculates,
    slot 1 plain-decodes alongside, so the opportunistic
    draft-shrinking loop and post-commit rewind run under real page
    pressure.  ``page_size=1`` makes draft depth map 1:1 onto pages —
    a full-depth draft can need more pages than are free while a
    shallower one fits, which is exactly the shrink path.  ``caps``
    are per-slot retirement positions.  Demand (``caps`` sum) exceeds
    the pool on purpose; the OOM escape is the ``preempt`` op on
    slot 1 (mirroring ``Server._ensure_pages``'s eviction fallback),
    which keeps the model deadlock-free."""

    page_size: int = 1
    pages_per_slot: int = 5
    n_pages: int = 5
    max_depth: int = 2
    caps: tuple[int, int] = (5, 2)

    @property
    def context(self) -> int:
        return self.page_size * self.pages_per_slot

    def kv_spec(self) -> PagedKVSpec:
        return PagedKVSpec(n_pages=self.n_pages, page_size=self.page_size,
                           pages_per_slot=self.pages_per_slot)


class SpecSemantics:
    """Mirror of ``Server.tick``'s speculation branch: draft depth d is
    shrunk to what the free list covers WITHOUT eviction, the verifier
    nondeterministically accepts k of the drafts, commit advances
    ``min(k, d_eff) + 1`` positions, then ``rewind`` hands back every
    page grabbed for rejected positions.  ``err`` bit 0: an op's
    ensure/rewind disagreed with the real contract; bit 1: the
    committed prefix's page mapping changed across the cycle."""

    def __init__(self, cfg: SpecConfig, *, canonical: bool = True):
        self.cfg = cfg
        # the inner allocator semantics stays EXACT so the within-op
        # prefix-stability check compares concrete page ids across the
        # ensure -> rewind window; the quotient is applied once per op.
        self.canonical = canonical
        self.alloc_sem = AllocatorSemantics(AllocConfig(
            n_slots=2, page_size=cfg.page_size,
            pages_per_slot=cfg.pages_per_slot, n_pages=cfg.n_pages))

    def init_globals(self) -> dict:
        return {
            "alloc": empty_projection(2, self.cfg.kv_spec()),
            "pos": (0, 0),
            "done": (0, 0),
            "err": 0,
        }

    def _grow_fits(self, G: dict, slot: int, t: int) -> bool:
        _, _, _, free, top = G["alloc"]
        grow = (t - 1) // self.cfg.page_size - top[slot]
        return grow <= 0 or grow <= len(free)

    def enabled_ops(self, G: dict) -> list[tuple]:
        ops: list[tuple] = []
        for s in (0, 1):
            if not G["done"][s] and G["pos"][s] < self.cfg.caps[s] \
                    and self._grow_fits(G, s, G["pos"][s] + 1):
                ops.append(("decode", s))
        pos0 = G["pos"][0]
        if not G["done"][0] and pos0 >= 1 \
                and self._grow_fits(G, 0, pos0 + 1):
            dmax = min(self.cfg.max_depth, self.cfg.caps[0] - pos0 - 1)
            for d in range(1, dmax + 1):
                for k in range(d + 1):
                    ops.append(("spec", d, k))
        # the OOM escape serve.py gets from _ensure_pages eviction:
        # when the pool is dry, the neighbour can be preempted (its
        # pages released, its position reset for re-prefill)
        if not G["done"][1] and G["pos"][1] > 0 and not G["alloc"][3]:
            ops.append(("preempt", 1))
        return ops

    def apply(self, G: dict, op: tuple) -> None:
        c = self.cfg
        pos = list(G["pos"])
        done = list(G["done"])
        err = G["err"]
        if op[0] == "preempt":
            s = op[1]
            self.alloc_sem.apply(G, ("release", s))
            pos[s] = 0
            G["alloc"] = canon_pages(G["alloc"]) if self.canonical \
                else G["alloc"]
            G["pos"] = tuple(pos)
            return
        if op[0] == "decode":
            s = op[1]
            ok = self.alloc_sem.apply(G, ("ensure", s, pos[s] + 1))
            if ok is not True:
                err |= 1           # guard said this fits
            pos[s] += 1
        else:
            (_, d, k) = op
            s = 0
            # opportunistic shrink: largest dd the free list covers
            # without evicting the neighbour (serve.py's loop)
            d_eff = 0
            for dd in range(d, 0, -1):
                if self._grow_fits(G, s, pos[s] + dd + 1):
                    ok = self.alloc_sem.apply(G, ("ensure", s,
                                                  pos[s] + dd + 1))
                    if ok is not True:
                        err |= 1
                    d_eff = dd
                    break
            if d_eff == 0:
                ok = self.alloc_sem.apply(G, ("ensure", s, pos[s] + 1))
                if ok is not True:
                    err |= 1
            e = min(k, d_eff) + 1
            new_pos = pos[s] + e
            keep = self.alloc_sem.pages_needed(new_pos)
            prefix_before = G["alloc"][0][s][:keep]
            self.alloc_sem.apply(G, ("rewind", s, new_pos))
            if G["alloc"][0][s][:keep] != prefix_before:
                err |= 2           # committed positions remapped
            pos[s] = new_pos
        if pos[s] >= c.caps[s]:    # retirement, as _retire_if_done
            self.alloc_sem.apply(G, ("release", s))
            done[s] = 1
        if self.canonical:
            G["alloc"] = canon_pages(G["alloc"])
        G["pos"] = tuple(pos)
        G["done"] = tuple(done)
        G["err"] = err


__all__ = ["AllocConfig", "AllocatorSemantics", "ServerSemantics",
           "SpecConfig", "SpecSemantics", "build_driver_model"]
