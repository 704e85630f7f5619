"""The bridge that makes this static analysis rather than a toy (the
port's copy of ``repro.verify.conformance``): the abstract allocator
model and the real :class:`~repro_torch.runtime.kv.PagedKVAllocator`
speak one trace vocabulary (op tuples whose first element is the real
method name; state agreement is
:meth:`~repro_torch.runtime.kv.PagedKVAllocator.project` equality), and
this module drives them against each other in both directions:

* :func:`coupled_explore` — exhaustive DFS over the model where EVERY
  transition is also executed on a real allocator reconstructed at the
  pre-state; any return-value or state disagreement (or concrete
  invariant breach) yields a counterexample op trail.  Run against the
  shipped allocator it is a bounded conformance proof; run against a
  :mod:`~repro_torch.verify.mutants` variant it is the bug detector.
* :func:`replay_ops` — SPIN guided-simulation analogue: re-run a trail
  op-for-op on ONE persistent real allocator from the initial state,
  asserting agreement at every step (``python -m repro_torch.verify
  replay``).
* :func:`trace_accepted` — direction 2: every trace a *real* allocator
  records (the ``trace`` hook in :mod:`repro_torch.runtime.kv`) must be a
  legal path of the model with identical returns and states.
"""

from __future__ import annotations

import ast
import time as _time
from dataclasses import dataclass

from ..core.promela import freeze
from ..runtime.kv import PagedKVAllocator
from .harness import restore_allocator
from .invariants import allocator_invariants, violated
from .models import AllocatorSemantics


class ConformanceError(AssertionError):
    """Real code and abstract model disagreed (op index + detail in
    ``args[0]``)."""


def ops_from_trail(trail: tuple[str, ...]) -> list[tuple]:
    """Recover the op sequence from explorer trail labels: a driver
    model's ``select`` labels end in ``:select=(op...)``."""

    ops = []
    for label in trail:
        if ":select=" in label:
            ops.append(ast.literal_eval(label.split(":select=", 1)[1]))
    return ops


def _norm(ret):
    """Real returns -> model returns (lists of pairs freeze to tuples)."""

    if isinstance(ret, list):
        return tuple(tuple(p) for p in ret)
    return ret


def _rets_match(sem, op, got, want) -> bool:
    """Exact return comparison, except ``cow_pages`` under a canonical
    (page-renamed) semantics in *cross-step* replay: there the model's
    pair list carries canonical ids while the real allocator's carries
    concrete ids, so only the shape (None-ness + pair count) is
    comparable.  ``coupled_explore`` never takes this branch — it
    reconstructs the real allocator at the model's own pre-state, so
    even canonical cow pairs compare exactly."""

    if sem.canonical and op[0] == "cow_pages":
        if got is None or want is None:
            return got is None and want is None
        return len(got) == len(want)
    return got == want


def _check_concrete(alloc: PagedKVAllocator) -> list[str]:
    """The allocator invariant suite evaluated on the REAL allocator's
    projection — the concrete half of every conformance step."""

    return violated(allocator_invariants(), {"alloc": alloc.project()})


@dataclass
class CoupledResult:
    ok: bool
    states: int = 0
    transitions: int = 0
    max_depth: int = 0
    truncated: bool = False
    elapsed_s: float = 0.0
    ops: tuple[tuple, ...] = ()       # counterexample op trail
    message: str = ""

    @property
    def status(self) -> str:
        if not self.ok:
            return "violated"
        return "bounded" if self.truncated else "verified"


def coupled_explore(sem: AllocatorSemantics,
                    allocator_cls: type[PagedKVAllocator] = PagedKVAllocator,
                    *, max_states: int = 500_000,
                    check_invariants: bool = True) -> CoupledResult:
    """DFS the allocator model; at every transition reconstruct a real
    ``allocator_cls`` at the pre-state, run the real method, and demand
    projection + return agreement with the model step (plus the
    concrete invariant suite).  Divergence is detected before visited
    pruning, so keying the visited set on the model state alone is
    sound: along agreeing paths the real state is a function of the
    model state."""

    t0 = _time.perf_counter()
    res = CoupledResult(ok=True)
    cfg = sem.cfg
    G0 = sem.init_globals()
    visited = {hash(freeze(G0))}
    stack: list[tuple[dict, tuple[tuple, ...]]] = [(G0, ())]
    res.states = 1
    scratch = allocator_cls(cfg.kv_spec(), cfg.n_slots)

    while stack:
        G, ops = stack.pop()
        res.max_depth = max(res.max_depth, len(ops))
        for op in sem.enabled_ops(G):
            res.transitions += 1
            G2 = dict(G)
            want_ret = sem.apply(G2, op)
            restore_allocator(scratch, G["alloc"])
            trail = ops + (op,)
            try:
                got_ret = _norm(getattr(scratch, op[0])(*op[1:]))
            except Exception as exc:   # mutants may blow up outright
                res.ok = False
                res.ops, res.message = trail, (
                    f"real {op!r} raised {type(exc).__name__}: {exc}")
                break
            if got_ret != want_ret:
                res.ok = False
                res.ops, res.message = trail, (
                    f"return mismatch on {op!r}: real {got_ret!r} "
                    f"!= model {want_ret!r}")
                break
            if sem.observe(scratch.project()) != G2["alloc"]:
                res.ok = False
                res.ops, res.message = trail, (
                    f"state divergence after {op!r}: real "
                    f"{sem.observe(scratch.project())} != model "
                    f"{G2['alloc']}")
                break
            if check_invariants:
                bad = _check_concrete(scratch)
                if bad:
                    res.ok = False
                    res.ops, res.message = trail, (
                        f"real allocator violates {bad} after {op!r}")
                    break
            h = hash(freeze(G2))
            if h in visited:
                continue
            visited.add(h)
            res.states += 1
            if res.states > max_states:
                res.truncated = True
                stack.clear()
                break
            stack.append((G2, trail))
        if not res.ok:
            break

    res.elapsed_s = _time.perf_counter() - t0
    return res


def replay_ops(sem: AllocatorSemantics, ops: list[tuple],
               allocator_cls: type[PagedKVAllocator] = PagedKVAllocator,
               *, log=None) -> PagedKVAllocator:
    """Replay an op trail on ONE persistent real allocator from the
    initial state (the concrete reproduction of an explorer
    counterexample).  Raises :class:`ConformanceError` at the first
    disagreement or concrete invariant breach; returns the final
    allocator on full agreement."""

    G = sem.init_globals()
    alloc = allocator_cls(sem.cfg.kv_spec(), sem.cfg.n_slots)
    for i, op in enumerate(ops):
        op = tuple(op)
        want_ret = sem.apply(G, op)
        try:
            got_ret = _norm(getattr(alloc, op[0])(*op[1:]))
        except Exception as exc:
            raise ConformanceError(
                f"op {i} {op!r}: real allocator raised "
                f"{type(exc).__name__}: {exc}") from exc
        if log is not None:
            log(f"  [{i}] {op!r} -> {got_ret!r}")
        if not _rets_match(sem, op, got_ret, want_ret):
            raise ConformanceError(
                f"op {i} {op!r}: return mismatch real {got_ret!r} "
                f"!= model {want_ret!r}")
        if sem.observe(alloc.project()) != G["alloc"]:
            raise ConformanceError(
                f"op {i} {op!r}: state divergence\n"
                f"  real:  {sem.observe(alloc.project())}\n"
                f"  model: {G['alloc']}")
        bad = _check_concrete(alloc)
        if bad:
            raise ConformanceError(
                f"op {i} {op!r}: real allocator violates {bad}")
    return alloc


class TraceChecker:
    """Incremental direction-2 conformance: feed ``(method, args,
    ret)`` records one at a time, as a real allocator emits them.

    The checker walks the abstract model alongside the real op stream —
    each record must be legal at the model's current state and return
    exactly what the model returns — which is what lets the online
    monitor (:class:`repro_torch.obs.monitor.ConformanceMonitor`)
    validate a LIVE drain without re-scanning the trace prefix every
    tick.  :meth:`state_divergence`
    adds the stronger check an offline trace cannot make: compare the
    real allocator's projection against the tracked model state, which
    catches mutations whose per-op returns still agree (leaked
    refcounts, stale table entries) at the first poll after the bad
    op rather than N ops later."""

    def __init__(self, sem: AllocatorSemantics):
        if sem.canonical:
            raise ValueError(
                "TraceChecker needs an exact (non-canonical) semantics: "
                "real traces carry concrete page ids")
        self.sem = sem
        self.G = sem.init_globals()
        self.count = 0

    def feed(self, record: tuple) -> None:
        method, args, real_ret = record
        op = (method, *tuple(args))
        if not self.sem.legal(self.G, op):
            raise ConformanceError(
                f"trace step {self.count} {op!r}: not a legal model op "
                f"at this state")
        want_ret = self.sem.apply(self.G, op)
        if _norm(real_ret) != want_ret:
            raise ConformanceError(
                f"trace step {self.count} {op!r}: real returned "
                f"{real_ret!r}, model {want_ret!r}")
        self.count += 1

    def state_divergence(self, alloc: PagedKVAllocator) -> str | None:
        real = self.sem.observe(alloc.project())
        if real != self.G["alloc"]:
            return (f"state divergence after trace step "
                    f"{self.count - 1}:\n  real:  {real}\n"
                    f"  model: {self.G['alloc']}")
        return None


def trace_accepted(sem: AllocatorSemantics,
                   trace: list[tuple]) -> None:
    """Direction 2: a ``(method, args, ret)`` trace recorded by a real
    allocator (the ``trace`` hook) must be a path of the model — every
    op legal at its state, every return matching the model's.  Raises
    :class:`ConformanceError` otherwise."""

    checker = TraceChecker(sem)
    for record in trace:
        checker.feed(record)


__all__ = ["ConformanceError", "CoupledResult", "TraceChecker",
           "coupled_explore", "ops_from_trail", "replay_ops",
           "trace_accepted"]
