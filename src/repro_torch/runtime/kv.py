"""Paged KV-cache bookkeeping: the block-table allocator.

The contiguous serving cache reserves a full ``context``-length ring per
slot, so memory scales with ``batch * context`` whether a request uses
three tokens or three thousand — mixed short/long traffic strands most
of it.  Paged mode replaces the per-slot ring with a shared **pool** of
fixed-size pages; each slot holds a *page table* mapping logical page
``pos // page_size`` to a physical page id, pages are allocated on
demand as prefill chunks and decode steps advance, and a retired slot's
pages return to a free list for immediate reuse.

This module is the host-side bookkeeping half (pure numpy — the page
table crosses to the device as a plain ``(slots, pages_per_slot)`` int32
tensor); the device-side gather/scatter lives in
:func:`repro_torch.models.attention.decode_attention_paged` and its
chunked sibling, and :class:`repro_torch.runtime.serve.Server` threads
the two together (``paged=True``).  It is the port's own copy of
``repro.runtime.kv``, op for op: ``tests/test_torch_kv.py`` holds the
two to equal page tables, refcounts, free lists and stats after every
operation of a seeded random sequence.

**Copy-on-write prefix sharing** extends the table with per-page
refcounts: :meth:`PagedKVAllocator.share` maps the pages backing a
common prompt prefix into a second slot's page table (the K/V is
prefilled once, then referenced N times), and
:meth:`PagedKVAllocator.cow_pages` breaks the sharing page-by-page the
moment a slot is about to *write* into a shared page — the caller gets
``(src_page, dst_page)`` pairs to copy device-side, and the writer
proceeds against its private copy.  ``release``/``rewind``/``trim``
decrement refcounts and only return a page to the free list when its
last holder lets go.

Invariants the allocator maintains (tested in ``tests/test_torch_kv.py``):

* a physical page is EXCLUSIVELY owned unless explicitly shared via
  ``share`` (refcount == number of page tables mapping it),
* ``ensure`` is all-or-nothing — a partial allocation never leaks,
* ``release``/``rewind``/``trim`` decrement refcounts; a page returns
  to the free list (LIFO, so reuse is immediate and cache-friendly)
  exactly when its refcount reaches zero,
* the page table never points at a freed page,
* ``cow_pages`` is all-or-nothing: a write range either gets every
  shared page it touches copied, or (free list too short) nothing
  changes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

NO_PAGE = -1


def _traced(fn):
    """Record ``(method, args, ret)`` on ``self.trace`` when tracing is
    on — the narrow op-trace hook :mod:`repro_torch.verify.conformance`
    replays against the abstract allocator model.  List returns are
    frozen to tuples so traces are hashable/JSON-friendly."""

    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(self, *args):
        ret = fn(self, *args)
        if self.trace is not None:
            rec = tuple(tuple(p) if isinstance(p, tuple) else p
                        for p in ret) if isinstance(ret, list) else ret
            self.trace.append((name, tuple(int(a) for a in args), rec))
        return ret
    return wrapper


@dataclass(frozen=True)
class PagedKVSpec:
    """Static shape of a paged KV pool: ``n_pages`` physical pages of
    ``page_size`` tokens each, addressed through per-slot page tables of
    ``pages_per_slot`` logical entries (= ``ceil(context / page_size)``,
    the per-request position bound)."""

    n_pages: int
    page_size: int
    pages_per_slot: int

    def __post_init__(self):
        if self.page_size < 1 or self.n_pages < 1 or self.pages_per_slot < 1:
            raise ValueError(f"degenerate paged spec: {self}")

    @property
    def pool_tokens(self) -> int:
        return self.n_pages * self.page_size

    @classmethod
    def for_server(cls, *, context: int, page_size: int,
                   n_pages: int | None = None,
                   batch: int = 1) -> "PagedKVSpec":
        """The spec a :class:`~repro_torch.runtime.serve.Server` needs:
        ``pages_per_slot`` covers ``context`` positions; ``n_pages``
        defaults to full per-slot backing (equal memory to the
        contiguous layout) and must cover at least one full slot so a
        lone request can always make progress (deferral has nobody else
        to evict)."""

        pps = -(-context // page_size)
        if n_pages is None:
            n_pages = batch * pps
        if n_pages < pps:
            raise ValueError(
                f"kv_pages={n_pages} cannot back even one full slot "
                f"({pps} pages for context={context} at "
                f"page_size={page_size}); a single request could deadlock")
        return cls(n_pages=n_pages, page_size=page_size, pages_per_slot=pps)


class PagedKVAllocator:
    """Free-list page allocator + per-slot page tables (host side)."""

    def __init__(self, spec: PagedKVSpec, n_slots: int):
        self.spec = spec
        self.n_slots = n_slots
        self.page_table = np.full((n_slots, spec.pages_per_slot), NO_PAGE,
                                  np.int32)
        self.owner = np.full(spec.n_pages, NO_PAGE, np.int32)
        # live page-table references per page: 1 = exclusive, >1 =
        # prefix-shared (writes must go through cow_pages first)
        self.refcount = np.zeros(spec.n_pages, np.int32)
        # LIFO free list: a just-released page is handed out first
        self._free: list[int] = list(range(spec.n_pages - 1, -1, -1))
        # highest logical page ever backed per slot: ensure() only
        # allocates ABOVE it, so pages trimmed away (SWA) or still held
        # are never re-backed for positions already written
        self._top = np.full(n_slots, -1, np.int64)
        # op-trace hook for the verifier: set to a list to record every
        # mutating call as (method, args, ret)
        self.trace: list[tuple] | None = None

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.spec.n_pages - len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        """Physical pages backing positions ``[0, n_tokens)``."""

        return -(-max(0, n_tokens) // self.spec.page_size)

    def fits(self, n_tokens: int) -> bool:
        """Could a fresh slot hold ``n_tokens`` right now?  (Admission
        check: positions bound by the page table, pages by the free
        list.)"""

        need = self.pages_needed(n_tokens)
        return need <= self.spec.pages_per_slot and need <= self.free_pages

    def slot_pages(self, slot: int) -> list[int]:
        row = self.page_table[slot]
        return [int(p) for p in row if p != NO_PAGE]

    @property
    def shared_pages(self) -> int:
        """Physical pages currently mapped by more than one slot."""

        return int(np.sum(self.refcount > 1))

    def is_shared(self, slot: int, logical_page: int) -> bool:
        page = int(self.page_table[slot, logical_page])
        return page != NO_PAGE and int(self.refcount[page]) > 1

    def project(self) -> tuple:
        """Canonical hashable projection of the allocator's mutable
        state — the shared vocabulary between this class and the
        abstract model in :mod:`repro_torch.verify.models` (state agreement
        along a replayed trail is projection equality)."""

        return (
            tuple(tuple(int(p) for p in row) for row in self.page_table),
            tuple(int(r) for r in self.refcount),
            tuple(int(o) for o in self.owner),
            tuple(self._free),
            tuple(int(t) for t in self._top),
        )

    # -- mutation -----------------------------------------------------------

    def _deref(self, page: int) -> bool:
        """Drop one reference to ``page`` (its table entry must already
        be cleared); frees it when the last holder lets go.  Returns
        True when the page actually hit the free list."""

        self.refcount[page] -= 1
        if self.refcount[page] <= 0:
            self.refcount[page] = 0
            self.owner[page] = NO_PAGE
            self._free.append(page)
            return True
        if not np.any(self.page_table[int(self.owner[page])] == page):
            # the nominal owner let go first: hand ownership to any
            # remaining holder so owner never names a slot without the
            # page in its table
            holders = np.argwhere(self.page_table == page)
            self.owner[page] = int(holders[0][0]) if len(holders) else NO_PAGE
        return False

    @_traced
    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Back positions ``[0, n_tokens)`` of ``slot``; allocates only
        logical pages above the slot's high-water mark.  All-or-nothing:
        returns False (and allocates nothing) when the free list cannot
        cover the growth."""

        if n_tokens <= 0:
            return True
        top_needed = (n_tokens - 1) // self.spec.page_size
        if top_needed >= self.spec.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed the page table "
                f"({self.spec.pages_per_slot} pages of "
                f"{self.spec.page_size})")
        grow = top_needed - int(self._top[slot])
        if grow <= 0:
            return True
        if grow > len(self._free):
            return False
        for lp in range(int(self._top[slot]) + 1, top_needed + 1):
            page = self._free.pop()
            self.page_table[slot, lp] = page
            self.owner[page] = slot
            self.refcount[page] = 1
        self._top[slot] = top_needed
        return True

    @_traced
    def share(self, src_slot: int, dst_slot: int, n_tokens: int) -> int:
        """Map the pages backing positions ``[0, n_tokens)`` of
        ``src_slot`` into ``dst_slot``'s page table (refcounts bumped,
        no K/V moved — both slots now read the same physical pages).
        ``dst_slot`` must be empty and the source range fully backed.
        Returns the number of pages shared."""

        if n_tokens <= 0:
            return 0
        if int(self._top[dst_slot]) != -1 or self.slot_pages(dst_slot):
            raise ValueError(f"share: dst slot {dst_slot} is not empty")
        need = self.pages_needed(n_tokens)
        row = self.page_table[src_slot, :need]
        if np.any(row == NO_PAGE):
            raise ValueError(
                f"share: src slot {src_slot} does not back {n_tokens} "
                f"tokens ({need} pages)")
        for lp in range(need):
            page = int(row[lp])
            self.page_table[dst_slot, lp] = page
            self.refcount[page] += 1
        self._top[dst_slot] = need - 1
        return need

    @_traced
    def cow_pages(self, slot: int, start_pos: int,
                  end_pos: int) -> list[tuple[int, int]] | None:
        """Break sharing before ``slot`` writes positions
        ``[start_pos, end_pos)``: every SHARED page in that range is
        remapped to a fresh private page (refcount 1, old refcount
        dropped).  Returns ``(old_page, new_page)`` pairs for the caller
        to copy device-side, or None when the free list cannot cover
        them (all-or-nothing — no table entry changes on failure)."""

        if end_pos <= start_pos:
            return []
        ps = self.spec.page_size
        lo = start_pos // ps
        hi = min((end_pos - 1) // ps, self.spec.pages_per_slot - 1)
        todo = [lp for lp in range(lo, hi + 1)
                if self.is_shared(slot, lp)]
        if len(todo) > len(self._free):
            return None
        pairs: list[tuple[int, int]] = []
        for lp in todo:
            old = int(self.page_table[slot, lp])
            new = self._free.pop()
            self.page_table[slot, lp] = new
            self.owner[new] = slot
            self.refcount[new] = 1
            self._deref(old)
            pairs.append((old, new))
        return pairs

    @_traced
    def release(self, slot: int) -> int:
        """Drop ``slot``'s reference to every page it maps (retire /
        deferral / preemption); a page returns to the free list only
        when no other slot still maps it.  Returns the number of pages
        the slot let go of."""

        pages = self.slot_pages(slot)
        self.page_table[slot] = NO_PAGE
        self._top[slot] = -1
        for page in pages:
            self._deref(page)
        return len(pages)

    @_traced
    def rewind(self, slot: int, n_tokens: int) -> int:
        """Roll ``slot`` back so it backs exactly positions
        ``[0, n_tokens)`` again: free every page above
        ``pages_needed(n_tokens)`` and LOWER the high-water mark so a
        later ``ensure`` re-backs those logical pages with fresh
        physical ones.  This is the speculation-rejection path — pages
        grabbed for draft tokens the verifier refused must come back
        immediately, leaving the table byte-identical to a slot that
        never speculated.  Returns the number freed."""

        keep = self.pages_needed(n_tokens)
        freed = 0
        for lp in range(keep, int(self._top[slot]) + 1):
            page = int(self.page_table[slot, lp])
            if page != NO_PAGE:
                self.page_table[slot, lp] = NO_PAGE
                if self._deref(page):
                    freed += 1
        self._top[slot] = min(int(self._top[slot]), keep - 1)
        return freed

    @_traced
    def trim(self, slot: int, keep_from_pos: int) -> int:
        """Free pages of ``slot`` holding only positions strictly below
        ``keep_from_pos`` (sliding-window reclamation: positions that
        fell out of the window are never attended again).  Whole pages
        only; returns the number freed."""

        ps = self.spec.page_size
        full_below = keep_from_pos // ps      # pages [0, full_below) dead
        freed = 0
        for lp in range(min(full_below, self.spec.pages_per_slot)):
            page = int(self.page_table[slot, lp])
            if page != NO_PAGE:
                self.page_table[slot, lp] = NO_PAGE
                if self._deref(page):
                    freed += 1
        return freed

    # -- stats --------------------------------------------------------------

    def stats(self, live_tokens: int = 0) -> dict[str, float]:
        """Occupancy/fragmentation snapshot.  ``live_tokens`` is the
        caller's count of positions actually holding K/V (the allocator
        tracks pages, not tokens); internal fragmentation is the share
        of allocated page capacity those tokens do not fill."""

        used = self.used_pages
        cap = used * self.spec.page_size
        return {
            "n_pages": float(self.spec.n_pages),
            "page_size": float(self.spec.page_size),
            "used_pages": float(used),
            "free_pages": float(self.free_pages),
            "occupancy": used / self.spec.n_pages,
            "live_tokens": float(live_tokens),
            "fragmentation": (1.0 - live_tokens / cap) if cap else 0.0,
            "shared_pages": float(self.shared_pages),
        }


__all__ = ["NO_PAGE", "PagedKVSpec", "PagedKVAllocator"]
