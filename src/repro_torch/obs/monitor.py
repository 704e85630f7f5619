"""Online model-conformance monitor for a live paged allocator (the port's
copy of ``repro.obs.monitor``).

The direction-2 check
(:func:`repro_torch.verify.conformance.trace_accepted`) validates
recorded allocator traces offline.  This module
runs the SAME check continuously against a serving drain: the monitor
enables the allocator's ``trace`` hook, and every
:meth:`ConformanceMonitor.poll` (the engine calls it at the end of each
tick) feeds the ops recorded since the last poll through an incremental
:class:`~repro.verify.conformance.TraceChecker` — every real op must be
a legal model transition returning exactly what the model returns —
and then compares the real allocator's full state projection against
the tracked model state.  The projection compare is the teeth: a
mutation whose returns still agree (a leaked refcount, a stale page
table entry) is caught at the first poll after the bad op.

On violation the monitor freezes with a diagnosis and can dump a
*replayable trail*: the complete op history in the reference's trail
format (the one ``python -m repro.verify replay --trail`` consumes; the
port replays it with :func:`repro_torch.verify.replay_ops`), with the
allocator field naming the planted mutant when the live allocator is
one.  A bounded sliding ``window`` of recent records rides
along in reports for at-a-glance context; the full history is capped
at ``max_trail`` ops (past the cap the trail is marked
non-replayable rather than silently truncated into a bogus repro).
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Any

from ..runtime.kv import PagedKVAllocator
from ..verify.conformance import ConformanceError, TraceChecker
from ..verify.models import AllocConfig, AllocatorSemantics


def _jsonable_ret(ret: Any) -> Any:
    if isinstance(ret, (list, tuple)):
        return [list(p) if isinstance(p, (list, tuple)) else p
                for p in ret]
    if isinstance(ret, bool) or ret is None:
        return ret
    return int(ret)


def thaw_ret(ret: Any) -> Any:
    """JSON round-tripped return -> the form ``_norm`` produces
    (pair lists refreeze to tuples of tuples)."""

    if isinstance(ret, list):
        return tuple(tuple(p) for p in ret)
    return ret


class ConformanceMonitor:
    def __init__(self, alloc: PagedKVAllocator, *, window: int = 256,
                 max_trail: int = 200_000, strict: bool = False):
        spec = alloc.spec
        self.alloc = alloc
        self.cfg = AllocConfig(n_slots=alloc.n_slots,
                               page_size=spec.page_size,
                               pages_per_slot=spec.pages_per_slot,
                               n_pages=spec.n_pages)
        self.sem = AllocatorSemantics(self.cfg, canonical=False)
        self.checker = TraceChecker(self.sem)
        self.strict = strict
        if alloc.trace is None:
            alloc.trace = []
        self._consumed = len(alloc.trace)
        self.window: deque[tuple] = deque(maxlen=window)
        self.ops: list[tuple] = []      # full (method, args) history
        self.max_trail = max_trail
        self.truncated = False
        self.ops_checked = 0
        self.polls = 0
        self.violation: dict | None = None

    @property
    def allocator_name(self) -> str:
        """``MUTANTS`` key when the live allocator is a planted mutant,
        ``"real"`` otherwise — resolved at call time so a class swapped
        in after construction is still named correctly in the dumped
        trail."""

        from ..verify.mutants import MUTANTS
        cls = type(self.alloc)
        return next((k for k, v in MUTANTS.items() if cls is v), "real")

    @property
    def accepted(self) -> bool:
        return self.violation is None

    def poll(self, tick: int | None = None) -> bool:
        """Consume and check ops recorded since the last poll, then
        compare state projections.  Returns True while conformant; once
        violated the monitor latches (``strict=True`` raises
        instead)."""

        if self.violation is not None:
            return False
        self.polls += 1
        trace = self.alloc.trace
        new = trace[self._consumed:]
        self._consumed = len(trace)
        for record in new:
            method, args, _ret = record
            self.window.append(record)
            if len(self.ops) < self.max_trail:
                self.ops.append((method, *args))
            else:
                self.truncated = True
            try:
                self.checker.feed(record)
            except ConformanceError as exc:
                return self._violate(str(exc), tick)
            self.ops_checked += 1
        divergence = self.checker.state_divergence(self.alloc)
        if divergence is not None:
            return self._violate(divergence, tick)
        return True

    def _violate(self, message: str, tick: int | None) -> bool:
        self.violation = {"message": message, "tick": tick,
                          "op_index": self.ops_checked,
                          "allocator": self.allocator_name}
        if self.strict:
            raise ConformanceError(
                f"online conformance violation (tick {tick}): {message}")
        return False

    def report(self) -> dict:
        """Status summary embedded in exported traces; ``window`` holds
        the most recent records (with returns) for context, ``records``
        the full history when it fits — enough for ``python -m
        repro_torch.obs check`` to re-run the offline check."""

        rep = {
            "status": "accepted" if self.accepted else "violation",
            "allocator": self.allocator_name,
            "config": dataclasses.asdict(self.cfg),
            "ops_checked": self.ops_checked,
            "polls": self.polls,
            "truncated": self.truncated,
            "window": [[m, list(a), _jsonable_ret(r)]
                       for m, a, r in self.window],
            "violation": self.violation,
        }
        if not self.truncated:
            rep["records"] = [[m, list(a), _jsonable_ret(r)]
                              for m, a, r in self.alloc.trace]
        return rep

    def trail(self) -> dict:
        """The replayable counterexample payload, in the reference's
        trail format (``python -m repro.verify replay --trail``)."""

        v = self.violation or {}
        return {
            "model": "allocator",
            "allocator": self.allocator_name,
            "config": dataclasses.asdict(self.cfg),
            "ops": [list(op) for op in self.ops],
            "message": v.get("message", "no violation"),
            "source": "repro_torch.obs online conformance monitor",
            "replayable": not self.truncated,
        }

    def dump_trail(self, path: str) -> dict:
        payload = self.trail()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        return payload


__all__ = ["ConformanceMonitor", "thaw_ret"]
