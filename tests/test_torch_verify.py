"""The port's ``verify`` against the JAX package's: the allocator, server
and speculation models, the conformance bridge to the port's real
``PagedKVAllocator``, the mutant battery, and a real port ``Server``
drain's allocator trace as a model path.

Configurations are built from the same field values in ``repro.verify``
and ``repro_torch.verify``; state counts, verdicts and counterexample op
trails must be equal.  Then the reference's own checks
(``tests/test_verify_models.py``, ``tests/test_verify_conformance.py``)
on the port's copy.  Only the last test runs a model (a ``.reduced()``
one, f32, on the CPU).
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.verify as jv  # noqa: E402
from repro.core.explorer import explore as jax_explore  # noqa: E402
from repro.verify.invariants import (  # noqa: E402
    drain_incomplete as jax_drain_incomplete)
from repro_torch.core.explorer import explore  # noqa: E402
from repro_torch.runtime.kv import PagedKVAllocator  # noqa: E402
from repro_torch.verify import (MUTANTS, AllocConfig,  # noqa: E402
                                AllocatorSemantics, ConformanceError,
                                ServerConfig, ServerScenario, ServerSemantics,
                                SpecConfig, SpecSemantics, allocator_invariants,
                                build_driver_model, canon_pages,
                                coupled_explore, ops_from_trail, replay_ops,
                                server_invariants, spec_invariants,
                                trace_accepted, violated, violates_any)
from repro_torch.verify.harness import empty_projection  # noqa: E402
from repro_torch.verify.invariants import drain_incomplete  # noqa: E402

SMALL = dict(n_slots=2, page_size=2, pages_per_slot=2, n_pages=3)
# the reference builders' canonical state count of AllocConfig()
DEFAULT_CANONICAL_STATES = 162_503


def _summary(res):
    return {"states": res.states, "transitions": res.transitions,
            "max_depth": res.max_depth, "frontier_peak": res.frontier_peak,
            "status": res.status, "bound_reason": res.bound_reason,
            "trail": (res.counterexample.trail
                      if res.counterexample is not None else None)}


def _alloc_runs(cfg, canonical, **kw):
    got = explore(build_driver_model(AllocatorSemantics(
        AllocConfig(**cfg), canonical=canonical)),
        violates_any(allocator_invariants()), schedule="por", **kw)
    want = jax_explore(jv.build_driver_model(jv.AllocatorSemantics(
        jv.AllocConfig(**cfg), canonical=canonical)),
        jv.violates_any(jv.allocator_invariants()), schedule="por", **kw)
    return got, want


# ---------------------------------------------------------------------------
# the allocator model: state counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,canonical,budget,status", [
    (SMALL, True, None, "verified"),
    (SMALL, False, None, "verified"),
    ({}, True, None, "verified"),
    ({}, False, 5_000, "bounded"),
], ids=["small-canonical", "small-exact", "default-canonical",
        "default-exact-bounded"])
def test_allocator_model_matches_jax(cfg, canonical, budget, status):
    """The same states, transitions, depth, frontier and verdict as
    ``repro.verify``; the default (over-committed 3 x 3 > 6) config
    verifies exhaustively in canonical mode; in exact mode it is far
    larger and is compared under a state budget."""

    kw = {} if budget is None else {"max_states": budget}
    got, want = _alloc_runs(cfg, canonical, **kw)
    assert _summary(got) == _summary(want)
    assert got.status == status
    if cfg == {} and canonical:
        assert got.states == DEFAULT_CANONICAL_STATES


def test_canonical_quotient_is_smaller():
    exact, _ = _alloc_runs(SMALL, False)
    quot, _ = _alloc_runs(SMALL, True)
    assert quot.states < exact.states


def test_bounded_run_is_distinct_from_verified():
    res, ref = _alloc_runs({}, True, max_states=50)
    assert res.truncated and res.property_holds
    assert res.status == "bounded" and res.bound_reason == "max_states"
    assert res.frontier_peak > 0 and res.states <= 51
    assert _summary(res) == _summary(ref)


def test_depth_limit_reported_as_bound_reason():
    res, ref = _alloc_runs(SMALL, True, depth_limit=4)
    assert res.status == "bounded" and res.bound_reason == "depth_limit"
    assert _summary(res) == _summary(ref)


def test_violation_wins_over_bound_and_on_violation_fires():
    sem = AllocatorSemantics(AllocConfig(**SMALL), canonical=True)
    seen = []
    res = explore(build_driver_model(sem), lambda G: G["alloc"][4][0] >= 0,
                  schedule="por", stop_on_first=False,
                  on_violation=seen.append)
    assert res.status == "violated" and res.counterexample is not None
    assert seen and seen[0].trail == res.counterexample.trail


def test_allocator_model_never_deadlocks():
    sem = AllocatorSemantics(AllocConfig(**SMALL), canonical=True)
    res = explore(build_driver_model(sem), violates_any(allocator_invariants()),
                  schedule="por", collect_terminals=True)
    assert res.status == "verified" and res.terminals == []


# ---------------------------------------------------------------------------
# page-symmetry canonicalization and the invariant predicates
# ---------------------------------------------------------------------------


def test_canon_pages_matches_jax_and_is_idempotent():
    cfg = AllocConfig(**SMALL)
    assert canon_pages(empty_projection(2, cfg.kv_spec())) == \
        empty_projection(2, cfg.kv_spec())
    sem = AllocatorSemantics(cfg, canonical=False)
    jsem = jv.AllocatorSemantics(jv.AllocConfig(**SMALL), canonical=False)
    G, JG = sem.init_globals(), jsem.init_globals()
    for op in [("ensure", 0, 4), ("share", 0, 1, 2), ("release", 0),
               ("ensure", 0, 2), ("cow_pages", 1, 0, 4)]:
        assert sem.apply(G, op) == jsem.apply(JG, op)
        assert G == JG
        c1 = canon_pages(G["alloc"])
        assert c1 == jv.canon_pages(JG["alloc"])
        assert canon_pages(c1) == c1
        assert sorted(c1[1]) == sorted(G["alloc"][1])
        assert c1[4] == G["alloc"][4]


BAD_PROJECTIONS = {
    "refcount_conservation": (((0, -1), (-1, -1)), (2, 0, 0), (0, -1, -1),
                              (2, 1), (0, -1)),
    "no_lost_pages": (((-1, -1), (-1, -1)), (0, 0, 0), (-1, -1, -1), (2, 1),
                      (-1, -1)),
    "no_double_free": (((-1, -1), (-1, -1)), (0, 0, 0), (-1, -1, -1),
                       (2, 1, 1), (-1, -1)),
    "freed_never_mapped": (((0, -1), (-1, -1)), (0, 0, 0), (-1, -1, -1),
                           (2, 1, 0), (0, -1)),
    "owner_consistent": (((0, -1), (-1, -1)), (1, 0, 0), (1, -1, -1), (2, 1),
                         (0, -1)),
    "high_water_clean": (((-1, 0), (-1, -1)), (1, 0, 0), (0, -1, -1), (2, 1),
                         (-1, -1)),
}


@pytest.mark.parametrize("name", sorted(BAD_PROJECTIONS))
def test_invariants_catch_seeded_bad_state(name):
    G = {"alloc": BAD_PROJECTIONS[name]}
    got = violated(allocator_invariants(), G)
    assert name in got
    assert got == jv.violated(jv.allocator_invariants(), G)


def test_clean_projection_passes_all():
    assert violated(allocator_invariants(),
                    {"alloc": empty_projection(2, AllocConfig(
                        **SMALL).kv_spec())}) == []


# ---------------------------------------------------------------------------
# the server and speculation models
# ---------------------------------------------------------------------------


SERVER_CASES = {
    "fcfs": (dict(policy="fcfs", batch=3),
             dict(name="t", prompts=((3, 3, 3), (4, 4, 4, 4), (5, 5)),
                  max_new=(2, 1, 1))),
    "fcfs-share": (dict(policy="fcfs", batch=3, share_prefix=True),
                   dict(name="share",
                        prompts=((7, 7, 7, 7), (7, 7, 7, 5), (7, 7)),
                        max_new=(2, 1, 1))),
    "priority": (dict(policy="priority", batch=2, aging_slack=3),
                 dict(name="slo", prompts=((3, 3, 3), (4, 4), (5, 5, 5)),
                      max_new=(2, 1, 1),
                      slo=("batch", "interactive", "interactive"))),
    "prefix": (dict(policy="prefix", batch=3, share_prefix=True),
               dict(name="pf", prompts=((7, 7, 7, 7), (7, 7, 7, 5), (9, 9)),
                    max_new=(2, 1, 1))),
}


def _server_runs(case, allocator=None, **kw):
    cfg_kw, scen_kw = SERVER_CASES[case]
    cfg, scen = ServerConfig(**cfg_kw), ServerScenario(**scen_kw)
    jcfg, jscen = jv.ServerConfig(**cfg_kw), jv.ServerScenario(**scen_kw)
    extra = {} if allocator is None else {"allocator_cls": MUTANTS[allocator]}
    jextra = ({} if allocator is None
              else {"allocator_cls": jv.MUTANTS[allocator]})
    got = explore(build_driver_model(ServerSemantics(cfg, scen, **extra)),
                  violates_any(server_invariants(cfg)), schedule="por", **kw)
    want = jax_explore(
        jv.build_driver_model(jv.ServerSemantics(jcfg, jscen, **jextra)),
        jv.violates_any(jv.server_invariants(jcfg)), schedule="por", **kw)
    return cfg, got, want


@pytest.mark.parametrize("case", SERVER_CASES)
def test_server_model_matches_jax_verified_and_drains(case):
    """The real port scheduler and allocator inside every tick: the same
    states and terminals as ``repro.verify``, verified, every terminal a
    full drain."""

    _, got, want = _server_runs(case, collect_terminals=True)
    assert _summary(got) == _summary(want)
    assert got.status == "verified", got.counterexample
    assert [t.globals for t in got.terminals] == \
        [t.globals for t in want.terminals]
    assert got.terminals
    for t in got.terminals:
        assert drain_incomplete(t.globals) == [] == \
            jax_drain_incomplete(t.globals)


def test_server_model_catches_planted_allocator_bug():
    cfg, got, want = _server_runs("fcfs-share",
                                  allocator="share-skips-refcount")
    assert got.status == want.status == "violated"
    assert got.counterexample.trail == want.counterexample.trail
    assert violated(server_invariants(cfg), got.counterexample.globals)


def test_spec_model_matches_jax_and_both_slots_retire():
    cfg = SpecConfig()
    got = explore(build_driver_model(SpecSemantics(cfg)),
                  violates_any(spec_invariants(cfg)), schedule="por",
                  collect_terminals=True)
    want = jax_explore(jv.build_driver_model(jv.SpecSemantics(
        jv.SpecConfig())), jv.violates_any(jv.spec_invariants(
            jv.SpecConfig())), schedule="por", collect_terminals=True)
    assert _summary(got) == _summary(want)
    assert got.status == "verified" and got.terminals
    for t in got.terminals:
        assert t.globals["done"] == (1, 1)
        assert len(t.globals["alloc"][3]) == cfg.n_pages


def test_spec_model_exercises_draft_shrinking():
    cfg = SpecConfig()
    seen_shrink = []

    class Probe(SpecSemantics):
        def apply(self, G, op):
            if op[0] == "spec" and not self._grow_fits(
                    G, 0, G["pos"][0] + op[1] + 1):
                seen_shrink.append(op)
            return SpecSemantics.apply(self, G, op)

    explore(build_driver_model(Probe(cfg)),
            violates_any(spec_invariants(cfg)), schedule="por")
    assert seen_shrink


# ---------------------------------------------------------------------------
# conformance: the model against the port's real allocator
# ---------------------------------------------------------------------------


def test_real_allocator_conforms_exhaustively_on_small():
    got = coupled_explore(AllocatorSemantics(AllocConfig(**SMALL),
                                             canonical=True))
    want = jv.coupled_explore(jv.AllocatorSemantics(jv.AllocConfig(**SMALL),
                                                    canonical=True))
    assert got.ok and got.status == "verified", got.message
    assert got.transitions > 500
    assert (got.states, got.transitions, got.max_depth) == \
        (want.states, want.transitions, want.max_depth)


def test_exact_mode_conformance_also_holds():
    res = coupled_explore(AllocatorSemantics(AllocConfig(**SMALL),
                                             canonical=False),
                          max_states=20_000)
    assert res.ok, res.message


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_mutant_caught_with_replayable_trail(name):
    """Each planted bug is caught with the reference's trail; the trail
    fails on a fresh port mutant and replays clean on the port's
    correct allocator."""

    assert sorted(MUTANTS) == sorted(jv.MUTANTS)
    sem = AllocatorSemantics(AllocConfig(**SMALL), canonical=True)
    res = coupled_explore(sem, MUTANTS[name])
    ref = jv.coupled_explore(jv.AllocatorSemantics(jv.AllocConfig(**SMALL),
                                                   canonical=True),
                             jv.MUTANTS[name])
    assert not res.ok and res.ops
    assert res.ops == ref.ops and res.states == ref.states
    with pytest.raises(ConformanceError):
        replay_ops(sem, list(res.ops), MUTANTS[name])
    replay_ops(sem, list(res.ops), PagedKVAllocator)


def test_mutants_keep_the_trace_hook():
    """A mutant's overridden op still records itself on ``trace``."""

    for name, cls in MUTANTS.items():
        alloc = cls(AllocConfig(**SMALL).kv_spec(), 2)
        alloc.trace = []
        alloc.ensure(0, 2)
        alloc.release(0)
        assert [m for m, _, _ in alloc.trace] == ["ensure", "release"], name


def test_ops_from_trail_parses_select_labels():
    trail = ("driver[0]:0:goto", "driver[0]:1:select=('ensure', 0, 2)",
             "driver[0]:2:apply", "driver[0]:1:select=('release', 0)")
    assert ops_from_trail(trail) == [("ensure", 0, 2), ("release", 0)]


def test_replay_agrees_on_failure():
    sem = AllocatorSemantics(AllocConfig(**SMALL), canonical=True)
    alloc = replay_ops(sem, [("ensure", 0, 4), ("ensure", 1, 4)])
    assert alloc.free_pages == 1


# ---------------------------------------------------------------------------
# direction 2: every real trace is a model path
# ---------------------------------------------------------------------------


def _random_walk_trace(seed, allocator_cls, sem_cls, cfg, steps=40):
    rng = random.Random(seed)
    sem = sem_cls(cfg, canonical=False)
    alloc = allocator_cls(cfg.kv_spec(), cfg.n_slots)
    alloc.trace = []
    for _ in range(steps):
        op = rng.choice(sem.enabled_ops({"alloc": alloc.project()}))
        getattr(alloc, op[0])(*op[1:])
    return alloc.trace


@pytest.mark.parametrize("seed", range(25))
def test_randomized_real_traces_are_model_paths(seed):
    """The port's real allocator driven by the model's enabled ops: its
    recorded trace is the reference allocator's under the same seed,
    and is accepted as a model path."""

    trace = _random_walk_trace(seed, PagedKVAllocator, AllocatorSemantics,
                               AllocConfig(**SMALL))
    from repro.runtime.kv import PagedKVAllocator as JaxAllocator
    assert trace == _random_walk_trace(seed, JaxAllocator,
                                       jv.AllocatorSemantics,
                                       jv.AllocConfig(**SMALL))
    trace_accepted(AllocatorSemantics(AllocConfig(**SMALL), canonical=False),
                   trace)


def test_trace_accepted_rejects_canonical_semantics():
    with pytest.raises(ValueError, match="exact"):
        trace_accepted(AllocatorSemantics(AllocConfig(**SMALL),
                                          canonical=True), [])


def _tampered(trace):
    """The first ``ensure`` record with its return flipped."""

    trace = list(trace)
    i = next(i for i, (m, _, _) in enumerate(trace) if m == "ensure")
    m, args, ret = trace[i]
    trace[i] = (m, args, not ret)
    return trace


def test_trace_accepted_flags_tampered_trace():
    trace = _random_walk_trace(3, PagedKVAllocator, AllocatorSemantics,
                               AllocConfig(**SMALL))
    with pytest.raises(ConformanceError):
        trace_accepted(AllocatorSemantics(AllocConfig(**SMALL),
                                          canonical=False), _tampered(trace))


# ---------------------------------------------------------------------------
# a real port Server drain
# ---------------------------------------------------------------------------


def test_real_server_allocator_trace_is_a_model_path():
    """Every allocator call of a paged copy-on-write drain of the port's
    ``Server`` (the prefix scheduler deciding, on the CPU) is a legal
    path of the abstract model with identical returns; the trace equals
    the JAX ``Server``'s on the same weights; a tampered copy is
    rejected."""

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.runtime.serve import Server as JaxServer
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_jax
    from repro_torch.models import build_model
    from repro_torch.runtime import Server

    jcfg = jax_get_config("smollm-135m").reduced().replace(
        logits_dtype="float32")
    japi = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      japi.init(jax.random.PRNGKey(0)))
    api = build_model(get_config("smollm-135m").reduced().replace(
        logits_dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")

    prefix = list(range(11, 29))
    traces, outs = [], []
    for cls, a, p in ((Server, api, params), (JaxServer, japi, jp)):
        srv = cls(a, p, batch=3, context=48, paged=True, page_size=4,
                  prefill_chunk=8, scheduler="prefix", share_prefix=True)
        srv.alloc.trace = []
        reqs = [srv.submit(prefix + [40, 50], max_new=3)]
        while not reqs[0].out:
            srv.tick()               # the source holds a written prefix
        reqs += [srv.submit(prefix + [40 + i, 50 + i], max_new=3)
                 for i in range(1, 4)]
        srv.run_until_drained()
        assert all(r.done for r in reqs)
        traces.append(list(srv.alloc.trace))
        outs.append([r.out for r in reqs])
        spec = srv.alloc.spec
        if cls is Server:
            assert srv.stats()["share_hits"] > 0
            cfg = AllocConfig(n_slots=srv.batch, page_size=spec.page_size,
                              pages_per_slot=spec.pages_per_slot,
                              n_pages=spec.n_pages)
    assert traces[0] == traces[1] and outs[0] == outs[1]
    methods = {m for m, _, _ in traces[0]}
    assert {"ensure", "share", "cow_pages", "release"} <= methods
    sem = AllocatorSemantics(cfg, canonical=False)
    trace_accepted(sem, traces[0])
    with pytest.raises(ConformanceError):
        trace_accepted(AllocatorSemantics(cfg, canonical=False),
                       _tampered(traces[0]))
