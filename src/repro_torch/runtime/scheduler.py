"""Serving policy, factored out of the engine: WHICH request to admit,
WHICH slot to sacrifice under page pressure, WHEN to preempt (the
port's copy of ``repro.runtime.scheduler``: pure Python, the same
policies and contract).

:class:`~repro_torch.runtime.serve.Server` owns mechanism — the model
steps, per-slot state, page-table plumbing — and delegates every discretionary
decision to a :class:`Scheduler` through three hooks:

* ``pick(server)``: index into ``server.queue`` of the next request to
  place into a free slot (None = hold admission this round),
* ``victim(server)``: the slot to preempt when the page pool cannot
  cover a tick's allocations (the OOM backpressure path),
* ``preempt_for(server)``: a slot to preempt so a WAITING request can
  run — the proactive, SLO-driven sibling of ``victim`` (None = never,
  which is every policy except ``priority``).

The server-side contract the hooks may rely on: ``server.queue`` is the
live waiting list (mutating order is allowed, the server pops the index
``pick`` returns), ``server.admit_fits(req)`` says whether a request's
pages fit right now, ``server.live_slots()`` / ``server.slot_request`` /
``server.slot_seq`` expose the occupied slots, their requests, and
admission order, and ``server.shared_prefix_len(req)`` /
``server.is_share_source(slot)`` expose the copy-on-write prefix index
(the paged allocator's ``share``).

Three policies ship behind the ``register_scheduler`` registry:

* ``fcfs`` — arrival order; in paged mode first-fit over the queue with
  an **aging barrier**: a request bypassed ``age_limit`` times blocks
  everything behind it until it fits, so a long prompt is never starved
  by a stream of short ones (the ``skips`` counter on
  :class:`~repro_torch.runtime.serve.Request`).
* ``priority`` — SLO classes (``Request.slo``, e.g. ``interactive`` /
  ``batch``) ranked by per-class weights, earliest deadline first
  within a class, with the same aging escape hatch; under a full house
  it preempts the youngest lowest-class slot to admit a strictly
  higher-class arrival (generated tokens are kept and re-prefilled on
  resume — see ``Server._preempt``).
* ``prefix`` — fcfs plus **prefix affinity**: among fitting requests,
  prefer the one with the longest shared prefix against a live slot, so
  copy-on-write sharing triggers while the source's pages are still
  resident; OOM victims are chosen among non-source slots first to keep
  shared prefixes hot.

The policy choice itself is a tunable
(:class:`~repro_torch.runtime.tunables.SchedulerTunable`,
``serve.scheduler``), measured over a seeded traffic trace.  A paged ``Server`` answers the page hooks
(``admit_fits``, ``shared_prefix_len``, ``is_share_source``) from its
:class:`~repro_torch.runtime.kv.PagedKVAllocator`; a contiguous one as
the reference's does (always fits, nothing shared).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Mapping, Protocol, runtime_checkable

if TYPE_CHECKING:   # pragma: no cover - import cycle guard (serve imports us)
    from .serve import Server


@runtime_checkable
class Scheduler(Protocol):
    """Policy hooks the server calls; see the module docstring for the
    contract of each."""

    kind: str

    def pick(self, server: "Server") -> int | None: ...

    def victim(self, server: "Server") -> int | None: ...

    def preempt_for(self, server: "Server") -> int | None: ...


_REGISTRY: dict[str, type] = {}


def register_scheduler(kind: str):
    """Class decorator: make ``kind`` constructible via
    :func:`make_scheduler` (and listed in :data:`SCHEDULER_KINDS`)."""

    def deco(cls):
        cls.kind = kind
        _REGISTRY[kind] = cls
        return cls
    return deco


def make_scheduler(kind: str | Scheduler | None, **kwargs) -> Scheduler:
    """Resolve a policy: an instance passes through, a kind string is
    looked up in the registry (``prefix-affinity`` aliases ``prefix``),
    None means the default ``fcfs``."""

    if kind is None:
        kind = "fcfs"
    if not isinstance(kind, str):
        if kwargs:
            raise ValueError("scheduler kwargs only apply to kind strings")
        return kind
    key = {"prefix-affinity": "prefix"}.get(kind, kind)
    if key not in _REGISTRY:
        raise ValueError(f"unknown scheduler {kind!r}; "
                         f"known: {', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[key](**kwargs)


def _bump_skips(queue, picked: int) -> int:
    """Requests ahead of the pick were bypassed: age them.  Returns the
    pick unchanged so call sites can ``return _bump_skips(q, i)``."""

    for j in range(picked):
        queue[j].skips += 1
    return picked


@register_scheduler("fcfs")
@dataclass
class FCFSScheduler:
    """Arrival order; paged first-fit with an aging barrier.

    Contiguous mode admits strictly in order (a free slot always has a
    full ring reserved).  Paged mode admits the oldest request whose
    prompt fits the free pages — but a request bypassed ``age_limit``
    times becomes a barrier: nothing behind it is considered until it
    fits, so pages drained by retiring slots flow to the starved
    request instead of the next small arrival."""

    age_limit: int = 8

    def pick(self, server: "Server") -> int | None:
        q = server.queue
        if not q:
            return None
        if not server.paged:
            return 0
        barrier = next((i for i, r in enumerate(q)
                        if r.skips >= self.age_limit), len(q) - 1)
        for i in range(barrier + 1):
            if server.admit_fits(q[i]):
                return _bump_skips(q, i)
        return None

    def victim(self, server: "Server") -> int | None:
        """Youngest active slot: least sunk work, and the oldest slot is
        never sacrificed before all younger ones, so it always
        progresses and the server cannot livelock."""

        live = server.live_slots()
        return max(live, key=server.slot_seq) if live else None

    def preempt_for(self, server: "Server") -> int | None:
        return None


@register_scheduler("priority")
@dataclass
class PriorityScheduler:
    """SLO classes with per-class weights + earliest-deadline-first.

    ``weights`` maps ``Request.slo`` to a rank (lower runs first);
    unknown classes rank after every known one.  Within a class,
    requests order by deadline (unset = latest), then arrival.  Aging
    still applies ACROSS classes: a batch request bypassed ``age_limit``
    times is served next, bounding interactive-storm starvation.  With
    ``preempt=True`` (default) a waiting request of a strictly higher
    class evicts the youngest slot of the lowest live class when no
    slot is free — the preempted request keeps its generated tokens and
    re-prefills them on resume."""

    weights: Mapping[str, int] = field(
        default_factory=lambda: {"interactive": 0, "batch": 1})
    age_limit: int = 32
    preempt: bool = True

    def _rank(self, req) -> int:
        fallback = max(self.weights.values(), default=0) + 1
        return self.weights.get(req.slo, fallback)

    def _key(self, req, order: int):
        dl = req.deadline if req.deadline is not None else float("inf")
        return (self._rank(req), dl, order)

    def pick(self, server: "Server") -> int | None:
        q = server.queue
        if not q:
            return None
        aged = [i for i, r in enumerate(q) if r.skips >= self.age_limit]
        cand = aged or range(len(q))
        fits = [i for i in cand if server.admit_fits(q[i])]
        if not fits:
            return None
        best = min(fits, key=lambda i: self._key(q[i], i))
        return _bump_skips(q, best)

    def victim(self, server: "Server") -> int | None:
        """Lowest class first, youngest within it — batch slots absorb
        page pressure before any interactive slot is touched."""

        live = server.live_slots()
        if not live:
            return None
        return max(live, key=lambda s: (self._rank(server.slot_request(s)),
                                        server.slot_seq(s)))

    def preempt_for(self, server: "Server") -> int | None:
        if not self.preempt or not server.queue or server.has_free_slot():
            return None
        wait = min(self._rank(r) for r in server.queue)
        live = server.live_slots()
        victims = [s for s in live
                   if self._rank(server.slot_request(s)) > wait]
        if not victims:
            return None
        return max(victims, key=lambda s: (
            self._rank(server.slot_request(s)), server.slot_seq(s)))


@register_scheduler("prefix")
@dataclass
class PrefixAffinityScheduler:
    """fcfs first-fit, but among fitting requests prefer the longest
    live shared prefix — admitting a sharer while its source's pages
    are resident turns a prefill into a page-table copy
    (the paged allocator's ``share``)."""

    age_limit: int = 8

    def pick(self, server: "Server") -> int | None:
        q = server.queue
        if not q:
            return None
        if not server.paged:
            return 0
        barrier = next((i for i, r in enumerate(q)
                        if r.skips >= self.age_limit), len(q) - 1)
        fits = [i for i in range(barrier + 1) if server.admit_fits(q[i])]
        if not fits:
            return None
        best = max(fits, key=lambda i: (server.shared_prefix_len(q[i]), -i))
        if server.shared_prefix_len(q[best]) <= 0:
            best = fits[0]           # nothing shares: plain first-fit
        return _bump_skips(q, best)

    def victim(self, server: "Server") -> int | None:
        """Youngest NON-SOURCE slot first: evicting a share source
        leaves its pages pinned by sharers anyway (refcounts), but
        keeping it live keeps the prefix admittable for free."""

        live = server.live_slots()
        if not live:
            return None
        pool = [s for s in live if not server.is_share_source(s)] or live
        return max(pool, key=server.slot_seq)

    def preempt_for(self, server: "Server") -> int | None:
        return None


SCHEDULER_KINDS: tuple[str, ...] = tuple(sorted(_REGISTRY))

__all__ = ["Scheduler", "FCFSScheduler", "PriorityScheduler",
           "PrefixAffinityScheduler",
           "register_scheduler", "make_scheduler", "SCHEDULER_KINDS"]
