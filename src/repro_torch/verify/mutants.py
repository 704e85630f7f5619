"""Deliberately broken allocator variants: the checker's own test bed
(the port's copy of ``repro.verify.mutants``).

A verifier that has never found a bug is indistinguishable from one
that cannot.  Each mutant plants a realistic single-edit bug in a
:class:`~repro_torch.runtime.kv.PagedKVAllocator` subclass — the refcount
dropped on the wrong side of a copy, a loop guard that quietly skips
shared pages — and the test suite (and ``chip_smoke.py``'s phase 8)
asserts that :func:`~repro_torch.verify.conformance.coupled_explore`
catches every one with a counterexample trail that
:func:`~repro_torch.verify.conformance.replay_ops` reproduces as a concrete
real-allocator failure.
"""

from __future__ import annotations

from ..runtime.kv import NO_PAGE, PagedKVAllocator, _traced

MUTANTS: dict[str, type[PagedKVAllocator]] = {}

# the base allocator's op-trace surface; mutant overrides of these must
# re-wrap in ``_traced`` or the buggy op itself vanishes from the op
# stream an online monitor records (the violation would still be caught
# via state projection, but the dumped trail could not reproduce it)
_TRACED_OPS = ("ensure", "share", "cow_pages", "release", "rewind", "trim")


def _mutant(name: str):
    def deco(cls):
        for op in _TRACED_OPS:
            if op in vars(cls):
                setattr(cls, op, _traced(vars(cls)[op]))
        MUTANTS[name] = cls
        return cls
    return deco


@_mutant("cow-deref-before-copy")
class CowDerefBeforeCopy(PagedKVAllocator):
    """cow_pages drops the old page's reference BEFORE remapping the
    table entry and checks the free list per page instead of up front:
    the owner-handoff logic sees the stale mapping (owner ends up naming
    a slot that no longer maps the page), and on free-list exhaustion
    the op bails mid-loop, breaking all-or-nothing."""

    def cow_pages(self, slot, start_pos, end_pos):
        if end_pos <= start_pos:
            return []
        ps = self.spec.page_size
        lo = start_pos // ps
        hi = min((end_pos - 1) // ps, self.spec.pages_per_slot - 1)
        pairs = []
        for lp in range(lo, hi + 1):
            if not self.is_shared(slot, lp):
                continue
            old = int(self.page_table[slot, lp])
            self._deref(old)                  # BUG: before the copy
            if not self._free:
                return None                   # BUG: partial on failure
            new = self._free.pop()
            self.page_table[slot, lp] = new
            self.owner[new] = slot
            self.refcount[new] = 1
            pairs.append((old, new))
        return pairs


@_mutant("rewind-keeps-shared")
class RewindKeepsShared(PagedKVAllocator):
    """rewind skips refcount>1 pages entirely — the table keeps mapping
    them ABOVE the lowered high-water mark, and the sharer's refcount
    never comes back down."""

    def rewind(self, slot, n_tokens):
        keep = self.pages_needed(n_tokens)
        freed = 0
        for lp in range(keep, int(self._top[slot]) + 1):
            page = int(self.page_table[slot, lp])
            if page != NO_PAGE and int(self.refcount[page]) == 1:  # BUG
                self.page_table[slot, lp] = NO_PAGE
                if self._deref(page):
                    freed += 1
        self._top[slot] = min(int(self._top[slot]), keep - 1)
        return freed


@_mutant("release-leaks-shared")
class ReleaseLeaksShared(PagedKVAllocator):
    """release clears the table but forgets to deref pages other slots
    still share: their refcount stays one too high forever (a page leak
    once the sharer retires too)."""

    def release(self, slot):
        pages = self.slot_pages(slot)
        self.page_table[slot] = NO_PAGE
        self._top[slot] = -1
        for page in pages:
            if int(self.refcount[page]) == 1:   # BUG: shared pages skipped
                self._deref(page)
        return len(pages)


@_mutant("ensure-partial-on-oom")
class EnsurePartialOnOOM(PagedKVAllocator):
    """ensure allocates page by page and returns False when the free
    list runs dry mid-growth — the pages already grabbed stay mapped,
    breaking the all-or-nothing contract callers rely on for eviction
    retries."""

    def ensure(self, slot, n_tokens):
        if n_tokens <= 0:
            return True
        top_needed = (n_tokens - 1) // self.spec.page_size
        if top_needed >= self.spec.pages_per_slot:
            raise ValueError("exceeds page table")
        for lp in range(int(self._top[slot]) + 1, top_needed + 1):
            if not self._free:
                return False                    # BUG: keeps partial growth
            page = self._free.pop()
            self.page_table[slot, lp] = page
            self.owner[page] = slot
            self.refcount[page] = 1
            self._top[slot] = lp
        return True


@_mutant("trim-stale-entry")
class TrimStaleEntry(PagedKVAllocator):
    """trim frees the page but forgets to clear the table entry: the
    slot keeps a live mapping to a page back on the free list (the
    freed-page-referenced class of bug)."""

    def trim(self, slot, keep_from_pos):
        ps = self.spec.page_size
        freed = 0
        for lp in range(min(keep_from_pos // ps, self.spec.pages_per_slot)):
            page = int(self.page_table[slot, lp])
            if page != NO_PAGE:
                if self._deref(page):           # BUG: entry not cleared
                    freed += 1
        return freed


@_mutant("share-skips-refcount")
class ShareSkipsRefcount(PagedKVAllocator):
    """share maps the source's pages into the destination table without
    bumping refcounts — the first release by either slot frees pages
    the other still reads."""

    def share(self, src_slot, dst_slot, n_tokens):
        if n_tokens <= 0:
            return 0
        if int(self._top[dst_slot]) != -1 or self.slot_pages(dst_slot):
            raise ValueError("share: dst not empty")
        need = self.pages_needed(n_tokens)
        row = self.page_table[src_slot, :need]
        if (row == NO_PAGE).any():
            raise ValueError("share: src does not back the range")
        for lp in range(need):
            self.page_table[dst_slot, lp] = int(row[lp])   # BUG: no ref++
        self._top[dst_slot] = need - 1
        return need


__all__ = ["MUTANTS", "CowDerefBeforeCopy", "RewindKeepsShared",
           "ReleaseLeaksShared", "EnsurePartialOnOOM", "TrimStaleEntry",
           "ShareSkipsRefcount"]
