"""The properties (the port's copy of ``repro.verify.invariants``): each
a ``G p`` safety/liveness invariant evaluated over a model's global
variables, so the existing reachability reduction
(:mod:`repro_torch.core.properties`: a violation of ``G p`` is a reachable
state with ``not p``) applies unchanged.

Liveness properties ("the oldest slot always eventually progresses",
"no request is starved past the aging barrier") are encoded as bounded
ghost counters in the model (``stall``, ``skips``) so "eventually"
becomes "within B steps" — a safety invariant the DFS can refute with a
concrete trail.

All allocator-level invariants read the canonical projection
``G["alloc"] == (pt, ref, own, free, top)`` shared by every model AND
by the real :meth:`~repro_torch.runtime.kv.PagedKVAllocator.project`, so the
same predicates double as the concrete-state check during conformance
replay."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..runtime.kv import NO_PAGE
from .harness import ServerConfig
from .models import SpecConfig


@dataclass(frozen=True)
class Invariant:
    name: str
    description: str
    violates: Callable[[dict], bool]


def violated(invariants: list[Invariant], G: dict) -> list[str]:
    """Names of every invariant ``G`` breaks."""

    return [inv.name for inv in invariants if inv.violates(G)]


def violates_any(invariants: list[Invariant]) -> Callable[[dict], bool]:
    """The explorer-facing predicate: True when any invariant breaks."""

    def _violates(G: dict) -> bool:
        return any(inv.violates(G) for inv in invariants)
    return _violates


# ---------------------------------------------------------------------------
# allocator safety (shared by all three models and the concrete check)
# ---------------------------------------------------------------------------


def _mapped(pt) -> list[int]:
    return [p for row in pt for p in row if p != NO_PAGE]


def _conservation(G) -> bool:
    pt, ref, own, free, top = G["alloc"]
    return sum(ref) != len(_mapped(pt))


def _no_lost_pages(G) -> bool:
    pt, ref, own, free, top = G["alloc"]
    held = {p for p in range(len(ref)) if ref[p] > 0}
    return len(free) + len(held) != len(ref) or bool(held & set(free))


def _no_double_free(G) -> bool:
    free = G["alloc"][3]
    return len(set(free)) != len(free)


def _freed_never_mapped(G) -> bool:
    pt, ref, own, free, top = G["alloc"]
    freed = set(free)
    return any(p in freed or ref[p] < 1 for p in _mapped(pt))


def _owner_consistent(G) -> bool:
    pt, ref, own, free, top = G["alloc"]
    for p in range(len(ref)):
        if ref[p] > 0:
            if own[p] == NO_PAGE or p not in pt[own[p]]:
                return True
        elif own[p] != NO_PAGE:
            return True
    return False


def _high_water(G) -> bool:
    pt, ref, own, free, top = G["alloc"]
    return any(pt[s][lp] != NO_PAGE
               for s in range(len(pt))
               for lp in range(top[s] + 1, len(pt[s])))


def allocator_invariants() -> list[Invariant]:
    """Refcount conservation and friends; shape-free (everything is
    read off the projection itself)."""

    return [
        Invariant("refcount_conservation",
                  "sum(refcounts) == number of live page-table entries",
                  _conservation),
        Invariant("no_lost_pages",
                  "every page is free xor held; the two sets partition "
                  "the pool", _no_lost_pages),
        Invariant("no_double_free",
                  "the free list never holds a page twice",
                  _no_double_free),
        Invariant("freed_never_mapped",
                  "no live table entry points at a freed page",
                  _freed_never_mapped),
        Invariant("owner_consistent",
                  "a held page's owner maps it; a free page has no owner",
                  _owner_consistent),
        Invariant("high_water_clean",
                  "no table entry above the slot's high-water mark",
                  _high_water),
    ]


# ---------------------------------------------------------------------------
# scheduler x server
# ---------------------------------------------------------------------------


def server_invariants(cfg: ServerConfig) -> list[Invariant]:
    def _progress_lost(G) -> bool:
        return bool(G["err"] & 1)

    def _livelock(G) -> bool:
        return G["stall"] > cfg.stall_bound

    def _starved(G) -> bool:
        limit = cfg.age_limit + cfg.aging_slack
        return any(t[1] > limit for t in G["rq"])

    def _backing_misaligned(G) -> bool:
        pt, ref, own, free, top = G["alloc"]
        ps = cfg.page_size
        for s in range(cfg.batch):
            if G["slots"][s] >= 0:
                need = -(-max(0, G["pos"][s]) // ps)
                if top[s] != need - 1:
                    return True
        return False

    return allocator_invariants() + [
        Invariant("progress_kept",
                  "a request's generated-token count never decreases "
                  "(preemption keeps progress)", _progress_lost),
        Invariant("no_livelock",
                  f"the oldest live slot makes fresh progress within "
                  f"{cfg.stall_bound} ticks (OOM-defer-youngest cannot "
                  f"starve it)", _livelock),
        Invariant("aging_barrier",
                  f"no queued request is bypassed more than age_limit"
                  f"+{cfg.aging_slack} times", _starved),
        Invariant("slot_backing",
                  "every live slot's pages exactly back its position",
                  _backing_misaligned),
    ]


def drain_incomplete(G: dict) -> list[str]:
    """Terminal-state check (deadlock-freedom half of liveness): when
    no op is enabled anymore, every submitted request must have retired
    with at least one generated token."""

    bad = []
    for rid, t in enumerate(G["rq"]):
        if t[0] != 3 or t[2] < 1:
            bad.append(f"request {rid} ended in status {t[0]} "
                       f"with {t[2]} tokens")
    return bad


# ---------------------------------------------------------------------------
# speculate-commit-rewind
# ---------------------------------------------------------------------------


def spec_invariants(cfg: SpecConfig) -> list[Invariant]:
    def _contract(G) -> bool:
        return bool(G["err"] & 1)

    def _prefix_moved(G) -> bool:
        return bool(G["err"] & 2)

    def _rewind_incomplete(G) -> bool:
        pt, ref, own, free, top = G["alloc"]
        ps = cfg.page_size
        for s in (0, 1):
            if G["done"][s]:
                if top[s] != -1 or any(p != NO_PAGE for p in pt[s]):
                    return True
            else:
                need = -(-max(0, G["pos"][s]) // ps)
                if top[s] != need - 1:
                    return True
        return False

    return allocator_invariants() + [
        Invariant("spec_alloc_contract",
                  "guarded ensure/rewind calls succeed as the real "
                  "allocator's contract promises", _contract),
        Invariant("spec_prefix_stable",
                  "the committed prefix's page mapping survives the "
                  "speculate-commit-rewind cycle", _prefix_moved),
        Invariant("spec_rewind_complete",
                  "after every cycle a slot backs exactly its committed "
                  "positions (no page leaked to rejected drafts)",
                  _rewind_incomplete),
    ]


__all__ = ["Invariant", "allocator_invariants", "server_invariants",
           "spec_invariants", "drain_incomplete", "violated",
           "violates_any"]
