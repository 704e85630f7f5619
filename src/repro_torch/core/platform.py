"""Abstract OpenCL platform model in the Promela-like runtime (the port's
copy of ``repro.core.platform``).

This is the paper's Step 1: the components of the OpenCL platform model
(Fig. 2/4) as communicating processes:

* ``main``    — nondeterministically selects the tuning parameters
                (workgroup size WG and tile size TS as powers of two, as in
                Listing 3) and launches ``host`` and ``clock``;
* ``host``    — activates the device and raises ``FIN`` on completion
                (Listing 4);
* ``device``  — feeds workgroups to its unit sequentially (Listing 5,
                reduced to one unit per the paper's §5 symmetry argument);
* ``unit``    — schedules workgroup items onto processing elements in
                waves of at most NP and orchestrates the group epilogue
                (Listing 6 / Listing 14);
* ``pex``     — a processing element running the kernel body; *computation
                is abstracted to its duration* (Listing 8 / Listing 15):
                local-memory work costs 1 time unit per element and
                global-memory work costs GMT units, exactly as the paper's
                ``long_work(gt, tz)``;
* ``barrier`` — local synchronization of one wave's resident elements
                (Listing 7);
* ``clock``   — global time (Listing 9).  We use an *event-driven*
                lock-step clock: a processing element sleeps by posting a
                wake time; the clock advances time to the earliest posted
                wake time, and the explorer only schedules the clock when
                no other process can move (maximal progress).  This is
                observationally equivalent to the paper's per-tick counter
                scheme (``NRP_work == allNWE``) but collapses the tick
                interleavings, so states are fewer.  Model time remains
                interleaving-invariant — asserted by tests.

Two kernels are modeled:

* ``abstract`` — the generic tiled kernel of Listing 2/8: every work item
  walks ``size/TS`` tiles; per tile it loads TS elements from global
  memory (GMT·TS), barriers, computes on TS local elements (TS·1),
  barriers; finally writes its result to global memory (GMT·1).
* ``minimum``  — the §7 reduction use case (Listing 10/15): every work
  item scans its own TS-element tile from global memory (GMT·TS) keeping
  a running minimum in local memory; after a group's waves complete, the
  group's element 0 reduces the resident local slots ((r−1)·1) and writes
  the group minimum to global memory (GMT·1); the host performs the final
  reduction over group minima (1 per group, Listing 11 lines 22-24).

Cost-model notes (documented deviations): the paper's
published excerpts have integer-division edge cases (e.g. ``WGs = 0`` for
``WG·TS > size``) that make Table 1's absolute numbers non-derivable; we
use the well-defined semantics above.  A per-group launch overhead ``L``
(default 0) models workgroup dispatch cost, which the paper carries
implicitly in its handshake steps.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

from .promela import (
    Expr, Guard, GuardedExpr, Goto, IfGoto, Model, Proctype, Recv,
    Run, Select, Send, State, atomic,
)

# ---------------------------------------------------------------------------
# Structured-control helpers (compile for-loops down to IfGoto/Goto)
# ---------------------------------------------------------------------------

_uid = itertools.count()


def for_loop(var: str, count_fn, body: list) -> list:
    """``for (var : 0 .. count-1) { body }`` with a fresh label pair."""

    k = next(_uid)
    top, bodyl, after = f"_for{k}", f"_forb{k}", f"_fora{k}"
    return [
        Expr(lambda G, L, v=var: L.__setitem__(v, 0), label_hint=f"for:{var}=0"),
        top,
        IfGoto(branches=((lambda G, L, v=var, c=count_fn: L[v] < c(G, L), bodyl),
                         (None, after)), label_hint=f"for:{var}"),
        bodyl,
        *body,
        Expr(lambda G, L, v=var: L.__setitem__(v, L[v] + 1), label_hint=f"{var}++"),
        Goto(top),
        after,
        Expr(lambda G, L: None, label_hint="nop"),
    ]


def sleep(duration_fn, tag: str = "work") -> list:
    """Model ``long_work``: post a wake time, block until the clock reaches
    it, then deregister.  ``duration_fn(G, L) -> int`` may be 0 (no-op)."""

    def post(G, L):
        d = duration_fn(G, L)
        L["__wake"] = G["time"] + d
        if d > 0:
            G["wakes"] = tuple(sorted(G["wakes"] + ((L["uid"], L["__wake"]),)))

    def done(G, L):
        G["wakes"] = tuple(w for w in G["wakes"] if w[0] != L["uid"])

    return [
        GuardedExpr(cond=lambda G, L: True, fn=post, label_hint=f"sleep:{tag}"),
        Guard(cond=lambda G, L: G["time"] >= L["__wake"], label_hint=f"wake:{tag}"),
        Expr(fn=done, label_hint=f"awake:{tag}"),
    ]


# ---------------------------------------------------------------------------
# Timed model: the clock only moves when nothing else can (maximal progress)
# ---------------------------------------------------------------------------


class TimedModel(Model):
    """Model whose ``clock`` tick transitions have lowest priority."""

    CLOCK_PROCTYPE = "clock"

    def successors(self, state: State):
        trans = super().successors(state)
        non_clock = [t for t in trans
                     if state.procs[t.pid].proctype != self.CLOCK_PROCTYPE]
        if non_clock:
            return non_clock
        return trans


# ---------------------------------------------------------------------------
# Platform model builder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlatformSpec:
    """Static parameters of the abstract platform + workload.

    size: input data size (power of two), NP: processing elements per unit,
    GMT: global/local memory access-time ratio, L: per-workgroup launch
    overhead, kind: "abstract" | "minimum".
    """

    size: int
    NP: int = 4
    GMT: int = 4
    L: int = 0
    kind: str = "abstract"
    # Optional pinned configuration (skip nondeterministic selection).
    fixed_WG: int | None = None
    fixed_TS: int | None = None

    def config_choices(self) -> list[tuple[int, int]]:
        """All (WG, TS) pairs main may select: powers of two ≤ size,
        restricted by any pinned values."""

        n = self.size.bit_length() - 1
        pows = [1 << i for i in range(0, n + 1)]
        wgs = [self.fixed_WG] if self.fixed_WG is not None else pows
        tss = [self.fixed_TS] if self.fixed_TS is not None else pows
        return [(wg, ts) for wg in wgs for ts in tss]


def build_model(spec: PlatformSpec) -> TimedModel:
    # reset the loop-label counter so identical specs build identical
    # label names (trail replay across model rebuilds relies on it)
    global _uid
    _uid = itertools.count()

    size, NP, GMT, L = spec.size, spec.NP, spec.GMT, spec.L

    # -- main (Listing 3) ---------------------------------------------------
    def wg_choices(G, L_):
        if spec.fixed_WG is not None:
            return [spec.fixed_WG]
        n = size.bit_length() - 1
        return [1 << i for i in range(0, n + 1)]

    def ts_choices(G, L_):
        if spec.fixed_TS is not None:
            return [spec.fixed_TS]
        n = size.bit_length() - 1
        return [1 << i for i in range(0, n + 1)]

    def derive(G, L_):
        G["WG"] = L_["wg"]
        G["TS"] = L_["ts"]
        items = size // G["TS"]
        G["items"] = items
        # number of workgroups (ceil) — well-defined also when WG > items
        G["WGs"] = max(1, -(-items // G["WG"]))

    main = Proctype.compile("main", [
        Select("wg", wg_choices),
        Select("ts", ts_choices),
        *atomic(
            Expr(derive, label_hint="derive"),
            Run("host", lambda G, L_: {"uid": "host"}),
            Run("clock", lambda G, L_: {"uid": "clock"}),
        ),
    ])

    # -- clock (Listing 9, event-driven) -------------------------------------
    def can_tick(G, L_):
        return bool(G["wakes"]) and min(w for _, w in G["wakes"]) > G["time"]

    def tick(G, L_):
        G["time"] = min(w for _, w in G["wakes"])

    clock = Proctype.compile("clock", [
        "loop",
        IfGoto(branches=(
            (lambda G, L_: G["FIN"], "__end__"),
            (can_tick, "dotick"),
        ), label_hint="clock"),
        "dotick",
        GuardedExpr(cond=can_tick, fn=tick, label_hint="tick"),
        Goto("loop"),
    ])

    # -- host (Listing 4) -----------------------------------------------------
    host = Proctype.compile("host", [
        Run("device", lambda G, L_: {"uid": "dev"}),
        Send(chan=lambda G, L_: "hst_d", msg=lambda G, L_: ("go",)),
        Recv(chan=lambda G, L_: "d_hst",
             accept=lambda G, L_, m: m[0] == "done"),
        # Host-side final reduction over group minima (Listing 11 l.22-24).
        *(sleep(lambda G, L_: G["WGs"], tag="host_reduce")
          if spec.kind == "minimum" else []),
        Send(chan=lambda G, L_: "hst_d", msg=lambda G, L_: ("stop",)),
        Expr(lambda G, L_: G.__setitem__("FIN", True), label_hint="FIN"),
    ])

    # -- device (Listing 5, one unit) ----------------------------------------
    device = Proctype.compile("device", [
        Recv(chan=lambda G, L_: "hst_d", accept=lambda G, L_, m: m[0] == "go"),
        Run("unit", lambda G, L_: {"uid": "unit"}),
        for_loop("g", lambda G, L_: G["WGs"], [
            Send(chan=lambda G, L_: "dev_u", msg=lambda G, L_: ("go", L_["g"])),
            Recv(chan=lambda G, L_: "u_dev", accept=lambda G, L_, m: m[0] == "done"),
        ]),
        Send(chan=lambda G, L_: "dev_u", msg=lambda G, L_: ("stop", 0)),
        Send(chan=lambda G, L_: "d_hst", msg=lambda G, L_: ("done",)),
        Recv(chan=lambda G, L_: "hst_d", accept=lambda G, L_, m: m[0] == "stop"),
    ])

    # -- unit (Listings 6/14) -------------------------------------------------
    def group_items(G, L_):
        """Items resident in group ``L_["grp"]`` (last group may be short)."""
        g = L_["grp"]
        return min(G["WG"], G["items"] - g * G["WG"])

    def wave_count(G, L_):
        cnt = group_items(G, L_)
        return -(-cnt // NP)

    def wave_resident(G, L_):
        cnt = group_items(G, L_)
        w = L_["w"]
        return min(NP, cnt - w * NP)

    def set_nwe(G, L_):
        G["NWE"] = wave_resident(G, L_)

    # The unit's do-od alternative over {go, stop} receives is emulated with
    # an accept-any receive followed by a dispatch on the command.
    unit = Proctype.compile("unit", [
        Expr(lambda G, L_: G.__setitem__("NWE", 0), label_hint="init"),
        Run("barrier", lambda G, L_: {"uid": "barrier"}),
        *[Run("pex", lambda G, L_, i=i: {"me": i, "uid": f"pex{i}"})
          for i in range(NP)],
        "serve",
        Recv(chan=lambda G, L_: "dev_u",
             bind=lambda G, L_, m: (L_.__setitem__("cmd", m[0]),
                                    L_.__setitem__("grp", m[1]))),
        IfGoto(branches=((lambda G, L_: L_["cmd"] == "stop", "shutdown"),
                         (None, "dogroup")), label_hint="cmd"),
        "dogroup",
        for_loop("w", wave_count, [
            Expr(set_nwe, label_hint="NWE"),
            for_loop("i", wave_resident, [
                Send(chan=lambda G, L_: "u_pex",
                     msg=lambda G, L_: ("go", L_["i"])),
            ]),
            for_loop("i", wave_resident, [
                Recv(chan=lambda G, L_: "pex_u",
                     accept=lambda G, L_, m: m[0] == "done"),
            ]),
        ]),
        *([
            Expr(lambda G, L_: G.__setitem__(
                "NWE", min(group_items(G, L_), NP)), label_hint="slots"),
            Send(chan=lambda G, L_: "u_pex", msg=lambda G, L_: ("reduce", 0)),
            Recv(chan=lambda G, L_: "pex_u",
                 accept=lambda G, L_, m: m[0] == "done"),
        ] if spec.kind == "minimum" else []),
        *(sleep(lambda G, L_: L, tag="launch") if L > 0 else []),
        Send(chan=lambda G, L_: "u_dev", msg=lambda G, L_: ("done",)),
        Goto("serve"),
        "shutdown",
        *[Send(chan=lambda G, L_: "u_pex", msg=lambda G, L_: ("stop", 0))
          for _ in range(NP)],
        Send(chan=lambda G, L_: "pex_b", msg=lambda G, L_: ("stop",)),
    ])

    # -- barrier (Listing 7) ---------------------------------------------------
    barrier = Proctype.compile("barrier", [
        "loop",
        Recv(chan=lambda G, L_: "pex_b",
             bind=lambda G, L_, m: L_.__setitem__("cmd", m[0])),
        IfGoto(branches=((lambda G, L_: L_["cmd"] == "stop", "__end__"),
                         (None, "count")), label_hint="bcmd"),
        "count",
        Expr(lambda G, L_: L_.__setitem__("i", L_.get("i", 0) + 1), label_hint="b++"),
        IfGoto(branches=((lambda G, L_: L_["i"] >= G["NWE"], "release"),
                         (None, "loop")), label_hint="bfull"),
        "release",
        Expr(lambda G, L_: L_.__setitem__("i", 0), label_hint="b=0"),
        for_loop("j", lambda G, L_: G["NWE"], [
            Send(chan=lambda G, L_: "b_pex", msg=lambda G, L_: ("go",)),
        ]),
        Goto("loop"),
    ])

    # -- pex (Listings 8/15) ----------------------------------------------------
    if spec.kind == "abstract":
        # per activation: size/TS tile iterations of
        #   global load (GMT·TS) — barrier — local compute (TS) — barrier
        # then result writeback (GMT·1).
        pex = Proctype.compile("pex", [
            "serve",
            Recv(chan=lambda G, L_: "u_pex",
                 bind=lambda G, L_, m: L_.__setitem__("cmd", m[0])),
            IfGoto(branches=((lambda G, L_: L_["cmd"] == "stop", "__end__"),
                             (None, "work")), label_hint="pcmd"),
            "work",
            for_loop("it", lambda G, L_: G["items"], [
                *sleep(lambda G, L_: GMT * G["TS"], tag="glob"),
                Send(chan=lambda G, L_: "pex_b", msg=lambda G, L_: ("done",)),
                Recv(chan=lambda G, L_: "b_pex",
                     accept=lambda G, L_, m: m[0] == "go"),
                *sleep(lambda G, L_: G["TS"], tag="loc"),
                Send(chan=lambda G, L_: "pex_b", msg=lambda G, L_: ("done",)),
                Recv(chan=lambda G, L_: "b_pex",
                     accept=lambda G, L_, m: m[0] == "go"),
            ]),
            *sleep(lambda G, L_: GMT, tag="writeback"),
            Send(chan=lambda G, L_: "pex_u", msg=lambda G, L_: ("done",)),
            Goto("serve"),
        ])
    else:  # minimum
        pex = Proctype.compile("pex", [
            "serve",
            Recv(chan=lambda G, L_: "u_pex",
                 bind=lambda G, L_, m: L_.__setitem__("cmd", m[0])),
            IfGoto(branches=(
                (lambda G, L_: L_["cmd"] == "stop", "__end__"),
                (lambda G, L_: L_["cmd"] == "reduce", "reduce"),
                (None, "work"),
            ), label_hint="pcmd"),
            "work",
            # MAP: scan own TS-element tile from global memory
            *sleep(lambda G, L_: GMT * G["TS"], tag="map"),
            Send(chan=lambda G, L_: "pex_u", msg=lambda G, L_: ("done",)),
            Goto("serve"),
            "reduce",
            # REDUCE local: (slots-1) local compares + global writeback
            *sleep(lambda G, L_: (G["NWE"] - 1) * 1, tag="reduce_loc"),
            *sleep(lambda G, L_: GMT, tag="reduce_glob"),
            Send(chan=lambda G, L_: "pex_u", msg=lambda G, L_: ("done",)),
            Goto("serve"),
        ])

    proctypes = {p.name: p for p in (main, clock, host, device, unit, barrier, pex)}
    init_globals = {
        "time": 0, "FIN": False, "wakes": (), "WG": 0, "TS": 0,
        "items": 0, "WGs": 0, "NWE": 0,
    }
    return TimedModel(proctypes, init_globals, "main", {"uid": "main"})


__all__ = ["PlatformSpec", "build_model", "TimedModel", "for_loop", "sleep"]
