"""A Promela-like process runtime with explicit small-step semantics
(the port's copy of ``repro.core.promela``).

This is the substrate for the paper's Step 1 ("represent the parallel
program with its tuning parameters and target architecture in the language
of a model checking tool").  We reproduce the Promela feature subset the
paper's listings use:

* ``proctype`` definitions as straight-line statement lists with labels,
  program counters and local variables,
* rendezvous (capacity-0) channels with handshake send/receive,
* ``atomic`` blocks (exclusive scheduling until exit or block),
* nondeterministic ``select`` (used by ``main`` to pick tuning parameters)
  and guarded ``if`` with multiple simultaneously-true branches,
* dynamic process creation (``run``).

States are immutable and hashable so an explicit-state explorer
(:mod:`repro_torch.core.explorer`) can do SPIN-style DFS with a visited set,
depth bounds and trail recording.

Semantics notes (deviations from SPIN):

* Receives never initiate a handshake: a rendezvous transition is
  attributed to the *sender* (one global transition per matching
  sender/receiver pair).  This is observationally equivalent to SPIN's
  semantics for the models used here.
* If a process blocks inside an ``atomic`` block, atomicity is released
  (same as SPIN).
* Variables are plain Python ints/bools/tuples.  Globals and locals are
  kept in immutable mappings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping, Sequence

# ---------------------------------------------------------------------------
# Frozen mapping helpers (states must be hashable)
# ---------------------------------------------------------------------------


def freeze(d: Mapping[str, Any]) -> tuple[tuple[str, Any], ...]:
    return tuple(sorted(d.items()))


def thaw(t: tuple[tuple[str, Any], ...]) -> dict[str, Any]:
    return dict(t)


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Stmt:
    """Base statement.  Subclasses define executability and effect."""


@dataclass(frozen=True)
class Expr(Stmt):
    """Always-executable effect: ``fn(G, L)`` mutates the dict copies."""

    fn: Callable[[dict, dict], None]
    label_hint: str = "expr"


@dataclass(frozen=True)
class Guard(Stmt):
    """Blocks until ``cond(G, L)`` is true; no effect (Promela expression
    statement)."""

    cond: Callable[[dict, dict], bool]
    label_hint: str = "guard"


@dataclass(frozen=True)
class GuardedExpr(Stmt):
    """Atomic guard+effect: executable iff cond; then applies fn."""

    cond: Callable[[dict, dict], bool]
    fn: Callable[[dict, dict], None]
    label_hint: str = "guarded_expr"


@dataclass(frozen=True)
class Send(Stmt):
    """Rendezvous send: executable iff some process is at a matching Recv."""

    chan: Callable[[dict, dict], str]
    msg: Callable[[dict, dict], tuple]
    label_hint: str = "send"


@dataclass(frozen=True)
class Recv(Stmt):
    """Rendezvous receive; ``bind(G, L, msg)`` stores message fields.

    ``accept(G, L, msg) -> bool`` implements Promela's constant-matching
    receive (e.g. ``u_pex ? 0, stop``)."""

    chan: Callable[[dict, dict], str]
    bind: Callable[[dict, dict, tuple], None] = lambda G, L, m: None
    accept: Callable[[dict, dict, tuple], bool] = lambda G, L, m: True
    label_hint: str = "recv"


@dataclass(frozen=True)
class Select(Stmt):
    """Nondeterministic choice: ``var`` gets each value from ``choices``.

    This is the paper's ``select (i : 1 .. n-1)`` used to pick tuning
    parameters; the explorer branches over every value."""

    var: str
    choices: Callable[[dict, dict], Sequence[Any]]
    label_hint: str = "select"


@dataclass(frozen=True)
class IfGoto(Stmt):
    """Promela ``if``: branches is a tuple of (cond, target_label).

    All branches with a true guard are explored (nondeterminism).  Use
    ``cond=None`` for ``else`` (enabled iff no other branch is)."""

    branches: tuple[tuple[Callable[[dict, dict], bool] | None, str], ...]
    label_hint: str = "if"


@dataclass(frozen=True)
class Goto(Stmt):
    target: str
    label_hint: str = "goto"


@dataclass(frozen=True)
class Run(Stmt):
    """Spawn a new process of ``proctype`` with locals from ``args``."""

    proctype: str
    args: Callable[[dict, dict], dict]
    label_hint: str = "run"


@dataclass(frozen=True)
class AtomicEnter(Stmt):
    label_hint: str = "atomic{"


@dataclass(frozen=True)
class AtomicExit(Stmt):
    label_hint: str = "}atomic"


@dataclass(frozen=True)
class Halt(Stmt):
    """Process end."""

    label_hint: str = "end"


def atomic(*stmts: Stmt | str) -> list[Stmt | str]:
    """Wrap statements in an atomic block."""

    return [AtomicEnter(), *stmts, AtomicExit()]


# ---------------------------------------------------------------------------
# Proctypes
# ---------------------------------------------------------------------------


@dataclass
class Proctype:
    """A compiled proctype: statement list + label table."""

    name: str
    stmts: list[Stmt]
    labels: dict[str, int]

    @staticmethod
    def compile(name: str, body: Sequence) -> "Proctype":
        """Strings in ``body`` are labels for the following statement.
        Nested lists (from helpers like ``for_loop``/``sleep``/``atomic``)
        are flattened recursively."""

        stmts: list[Stmt] = []
        labels: dict[str, int] = {}

        def emit(items) -> None:
            for item in items:
                if isinstance(item, str):
                    labels[item] = len(stmts)
                elif isinstance(item, (list, tuple)):
                    emit(item)
                else:
                    stmts.append(item)

        emit(body)
        stmts.append(Halt())
        labels["__end__"] = len(stmts) - 1
        return Proctype(name, stmts, labels)


# ---------------------------------------------------------------------------
# Program state
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProcState:
    proctype: str
    pc: int
    locals: tuple[tuple[str, Any], ...]
    alive: bool = True


@dataclass(frozen=True)
class State:
    globals: tuple[tuple[str, Any], ...]
    procs: tuple[ProcState, ...]
    atomic_owner: int = -1  # -1: none

    def get(self, name: str) -> Any:
        return thaw(self.globals)[name]


@dataclass(frozen=True)
class Transition:
    """A global transition: which pid moved, a human label, whether this
    was a *choice* (select/if branch) rather than a scheduling alternative,
    and the successor state."""

    pid: int
    label: str
    state: State
    is_choice: bool = False


class Model:
    """A closed Promela-like model: proctypes + initial process."""

    def __init__(self, proctypes: dict[str, Proctype], init_globals: dict[str, Any],
                 init_proc: str, init_locals: dict[str, Any] | None = None):
        self.proctypes = proctypes
        self._init_globals = dict(init_globals)
        self._init_proc = init_proc
        self._init_locals = dict(init_locals or {})

    def initial_state(self) -> State:
        return State(
            globals=freeze(self._init_globals),
            procs=(ProcState(self._init_proc, 0, freeze(self._init_locals)),),
        )

    # -- small-step semantics ------------------------------------------------

    def _stmt(self, ps: ProcState) -> Stmt:
        return self.proctypes[ps.proctype].stmts[ps.pc]

    def _advance(self, ps: ProcState, new_locals: dict, pc: int | None = None) -> ProcState:
        npc = ps.pc + 1 if pc is None else pc
        proctype = self.proctypes[ps.proctype]
        npc = min(npc, len(proctype.stmts) - 1)
        # Advancing into Halt kills the process immediately (no extra step).
        alive = not isinstance(proctype.stmts[npc], Halt)
        return ProcState(ps.proctype, npc, freeze(new_locals), alive=alive)

    def _label(self, proctype: str, name: str) -> int:
        return self.proctypes[proctype].labels[name]

    def successors(self, state: State) -> list[Transition]:
        """All enabled global transitions from ``state``."""

        G = thaw(state.globals)
        out: list[Transition] = []

        pids: Iterable[int]
        if state.atomic_owner >= 0:
            pids = (state.atomic_owner,)
        else:
            pids = range(len(state.procs))

        for pid in pids:
            out.extend(self._proc_transitions(state, G, pid))

        if not out and state.atomic_owner >= 0:
            # Owner blocked inside atomic: release atomicity (SPIN semantics)
            # and retry with every process schedulable.
            released = dataclasses.replace(state, atomic_owner=-1)
            return self.successors(released)
        return out

    # pylint: disable=too-many-branches,too-many-locals
    def _proc_transitions(self, state: State, G: dict, pid: int) -> list[Transition]:
        ps = state.procs[pid]
        if not ps.alive:
            return []
        stmt = self._stmt(ps)
        L = thaw(ps.locals)
        name = f"{ps.proctype}[{pid}]:{ps.pc}:{stmt.label_hint}"
        out: list[Transition] = []

        def commit(new_G: dict, new_procs: list[ProcState], label: str,
                   is_choice: bool = False, owner: int | None = None) -> None:
            new_owner = state.atomic_owner if owner is None else owner
            out.append(Transition(pid, label, State(freeze(new_G), tuple(new_procs), new_owner),
                                  is_choice))

        def with_proc(new_ps: ProcState, extra: list[ProcState] | None = None) -> list[ProcState]:
            procs = list(state.procs)
            procs[pid] = new_ps
            if extra:
                procs.extend(extra)
            return procs

        if isinstance(stmt, Halt):
            if ps.alive:
                procs = with_proc(dataclasses.replace(ps, alive=False))
                commit(dict(G), procs, name)
            return out

        if isinstance(stmt, Expr):
            G2, L2 = dict(G), dict(L)
            stmt.fn(G2, L2)
            commit(G2, with_proc(self._advance(ps, L2)), name)
        elif isinstance(stmt, Guard):
            if stmt.cond(G, L):
                commit(dict(G), with_proc(self._advance(ps, L)), name)
        elif isinstance(stmt, GuardedExpr):
            if stmt.cond(G, L):
                G2, L2 = dict(G), dict(L)
                stmt.fn(G2, L2)
                commit(G2, with_proc(self._advance(ps, L2)), name)
        elif isinstance(stmt, Select):
            for v in stmt.choices(G, L):
                L2 = dict(L)
                L2[stmt.var] = v
                commit(dict(G), with_proc(self._advance(ps, L2)),
                       f"{name}={v}", is_choice=True)
        elif isinstance(stmt, IfGoto):
            enabled = []
            has_else = None
            for cond, target in stmt.branches:
                if cond is None:
                    has_else = target
                elif cond(G, L):
                    enabled.append(target)
            if not enabled and has_else is not None:
                enabled = [has_else]
            multi = len(enabled) > 1
            for target in enabled:
                commit(dict(G), with_proc(self._advance(ps, L, pc=self._label(ps.proctype, target))),
                       f"{name}->{target}", is_choice=multi)
        elif isinstance(stmt, Goto):
            commit(dict(G), with_proc(self._advance(ps, L, pc=self._label(ps.proctype, stmt.target))),
                   name)
        elif isinstance(stmt, Run):
            child_locals = stmt.args(G, L)
            child = ProcState(stmt.proctype, 0, freeze(child_locals))
            commit(dict(G), with_proc(self._advance(ps, L), extra=[child]),
                   f"{name}:{stmt.proctype}")
        elif isinstance(stmt, AtomicEnter):
            commit(dict(G), with_proc(self._advance(ps, L)), name, owner=pid)
        elif isinstance(stmt, AtomicExit):
            commit(dict(G), with_proc(self._advance(ps, L)), name, owner=-1)
        elif isinstance(stmt, Send):
            chan = stmt.chan(G, L)
            msg = stmt.msg(G, L)
            # Find matching receivers (any process at a Recv on same channel
            # whose accept predicate passes).
            for rpid, rps in enumerate(state.procs):
                if rpid == pid or not rps.alive:
                    continue
                rstmt = self._stmt(rps)
                if not isinstance(rstmt, Recv):
                    continue
                RL = thaw(rps.locals)
                if rstmt.chan(G, RL) != chan:
                    continue
                if not rstmt.accept(G, RL, msg):
                    continue
                G2 = dict(G)
                RL2 = dict(RL)
                rstmt.bind(G2, RL2, msg)
                procs = list(state.procs)
                procs[pid] = self._advance(ps, L)
                procs[rpid] = self._advance(rps, RL2)
                commit(G2, procs, f"{name}!{chan}{msg}->pid{rpid}")
        elif isinstance(stmt, Recv):
            # Receives do not initiate handshakes (sender-attributed).
            pass
        else:  # pragma: no cover - defensive
            raise TypeError(f"unknown statement {stmt}")
        return out


__all__ = [
    "Expr", "Guard", "GuardedExpr", "Send", "Recv", "Select", "IfGoto",
    "Goto", "Run", "AtomicEnter", "AtomicExit", "Halt", "atomic",
    "Proctype", "ProcState", "State", "Transition", "Model",
    "freeze", "thaw",
]
