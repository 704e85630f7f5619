"""The port's observability against the JAX package's: ``Server(obs=)``
with the trace recorder, the metrics registry, the online conformance
monitor and the phase profiler, ``TracingScheduler``, and the ``python -m
repro_torch.obs`` CLI.

Reduced qwen1.5-4b in f32 (weights carried across by ``params_from_jax``),
seeded traffic from ``generate_trace``, the same drain through both
packages' paged ``Server``: tokens and tick counts equal; every trace
event equal in name, phase, track, tick and args (timestamps are wall
clock and differ); the metrics equal but for ``peak_used_pages``, a
counter only the port's ``Server.stats`` reports; the monitor's verdict,
polls and checked ops equal.  An observed drain's tokens equal the
unobserved drain's (the hooks touch no device value), exactly.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.obs import Observability as JaxObservability  # noqa: E402
from repro.obs.cli import main as jax_obs_main  # noqa: E402
from repro.runtime import workload as jax_workload  # noqa: E402
from repro.runtime.scheduler import TracingScheduler as JaxTracingScheduler  # noqa: E402
from repro.runtime.scheduler import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.runtime.serve import Server as JaxServer  # noqa: E402
from repro.verify.mutants import MUTANTS as JAX_MUTANTS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import (MetricsRegistry, Observability,  # noqa: E402
                             PhaseProfiler, parse_trace, spans_from_events,
                             validate_trace)
from repro_torch.obs.cli import main as obs_main  # noqa: E402
from repro_torch.obs.monitor import thaw_ret  # noqa: E402
from repro_torch.obs.profile import sync_devices  # noqa: E402
from repro_torch.runtime import Server, TracingScheduler, workload  # noqa: E402
from repro_torch.runtime.scheduler import make_scheduler  # noqa: E402
from repro_torch.runtime.tunables import (timed_server_drain,  # noqa: E402
                                          timed_trace_drain)
from repro_torch.verify import (AllocConfig, AllocatorSemantics,  # noqa: E402
                                ConformanceError, MUTANTS, replay_ops)

# seed 5 of this trace on 10 pages: every policy defers on page OOM,
# prefix shares, priority preempts; with a 10-token prefix (not a whole
# number of 4-token pages) a shared page is copied on write
TRACE = dict(requests=7, burst=3, burst_every=2, prompt_len=(4, 12),
             max_new=(2, 5), shared_frac=0.8, prefix_len=8, vocab=256,
             seed=5)
SERVE = dict(batch=2, context=40, prefill_chunk=8, paged=True, page_size=4,
             kv_pages=10)
# the reference's e2e mutant drain: 3 slots over 24 pages, every prompt
# behind one 8-token prefix
MUTANT_TRACE = dict(requests=10, arrival="bursty", burst=3, burst_every=4,
                    prompt_len=(6, 14), max_new=(3, 6), shared_frac=1.0,
                    prefix_len=8, vocab=256, seed=3)
MUTANT_SERVE = dict(batch=3, context=48, prefill_chunk=8, paged=True,
                    page_size=4, kv_pages=24, scheduler="prefix",
                    share_prefix=True)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen1.5-4b").reduced().replace(
        logits_dtype="float32")
    japi = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      japi.init(jax.random.PRNGKey(0)))
    api = build_model(get_config("qwen1.5-4b").reduced().replace(
        logits_dtype="float32"))
    return (japi, jp), (api, params_from_jax(jax.tree.map(np.asarray, jp),
                                             "cpu"))


def _traces(**kw):
    cfg = dict(TRACE, **kw)
    return (workload.generate_trace(workload.TraceConfig(**cfg)),
            jax_workload.generate_trace(jax_workload.TraceConfig(**cfg)))


def _events(doc_or_events):
    """Every event without its wall-clock timestamp; tracks as tuples (a
    parsed document holds them as lists)."""

    evs = (parse_trace(doc_or_events) if isinstance(doc_or_events, dict)
           else doc_or_events)
    return [(e["name"], e["ph"], tuple(e["track"]), e["tick"],
             e.get("args", {})) for e in evs]


def _tokens(records):
    return {rid: list(r["request"].out) for rid, r in records.items()}


def _snapshot(obs):
    snap = obs.registry.snapshot()
    snap["gauges"].pop("serve.drain.peak_used_pages", None)
    return snap


def _observed_pair(models, policy, prefix_len=8, **obs_kw):
    (japi, jp), (api, p) = models
    trace, jtrace = _traces(prefix_len=prefix_len)
    share = policy == "prefix"
    kw = dict(trace=True, metrics=True, monitor=True, **obs_kw)
    jobs, obs = JaxObservability(**kw), Observability(**kw)
    jsrv = JaxServer(japi, jp, scheduler=jax_make_scheduler(
        policy, age_limit=4), share_prefix=share, obs=jobs, **SERVE)
    want = jax_workload.drive_trace(jsrv, jtrace)
    srv = Server(api, p, scheduler=make_scheduler(policy, age_limit=4),
                 share_prefix=share, obs=obs, **SERVE)
    with torch.inference_mode():
        got = workload.drive_trace(srv, trace)
    return (jsrv, jobs, want), (srv, obs, got)


@pytest.mark.parametrize("policy,prefix_len", [
    ("fcfs", 8), ("prefix", 8), ("priority", 8), ("prefix", 10)])
def test_observed_drain_matches_reference(models, policy, prefix_len):
    (jsrv, jobs, want), (srv, obs, got) = _observed_pair(models, policy,
                                                         prefix_len)
    assert _tokens(got) == _tokens(want)
    assert srv.ticks == jsrv.ticks
    jdoc, doc = jobs.export(), obs.export()
    assert validate_trace(doc) == []
    assert _events(doc) == _events(jdoc)
    assert _snapshot(obs) == _snapshot(jobs)
    collected = obs.registry.collect("serve")
    assert collected.pop("drain.peak_used_pages") == srv.peak_used_pages
    assert collected == jobs.registry.collect("serve")
    mon, jmon = doc["monitor"], jdoc["monitor"]
    assert mon["status"] == jmon["status"] == "accepted"
    assert mon["ops_checked"] == jmon["ops_checked"] > 0
    assert (mon["polls"], mon["records"], mon["window"], mon["config"]) == \
        (jmon["polls"], jmon["records"], jmon["window"], jmon["config"])
    st = srv.stats()
    assert st["deferrals"] > 0
    assert (st["shared_tokens"] > 0) == (policy == "prefix")
    assert (st["cow_copies"] > 0) == (prefix_len == 10)
    assert (st["preemptions"] > 0) == (policy == "priority")
    names = {e[0] for e in _events(doc)}
    assert {"request", "queued", "running", "tick", "phase.prefill",
            "phase.decode", "workload.submitted",
            "workload.retired"} <= names
    assert ("phase.cow_copy" in names) == (prefix_len == 10)


@pytest.mark.parametrize("case", [
    dict(paged=False),
    dict(paged=True, kv_pages=10),
    dict(paged=True, kv_pages=10, share_prefix=True, scheduler="prefix"),
    dict(paged=True, kv_pages=10, scheduler="priority"),
    dict(paged=True, speculate="ngram", spec_depth=3),
    dict(paged=False, speculate="ngram", spec_depth=2),
], ids=["contiguous", "paged", "shared", "priority", "ngram-paged",
        "ngram-contiguous"])
def test_observed_tokens_equal_unobserved(models, case):
    _, (api, p) = models
    trace, _ = _traces()
    kw = dict(batch=2, context=40, prefill_chunk=8, page_size=4, **case)

    def drain(obs):
        srv = Server(api, p, obs=obs, **kw)
        with torch.inference_mode():
            return srv, workload.drive_trace(srv, trace)

    base_srv, base = drain(None)
    obs = Observability(trace=True, metrics=True, profile=True,
                        monitor=kw["paged"])
    srv, got = drain(obs)
    assert _tokens(got) == _tokens(base)
    assert srv.stats() == base_srv.stats()
    doc = obs.export()
    assert validate_trace(doc) == []
    assert set(doc["phases"]) >= {"prefill", "host"}
    if kw["paged"]:
        assert doc["monitor"]["status"] == "accepted"


def test_preemption_spans_nest_queued_running_cycles(models):
    """A preempted request's track reads queued -> running ->
    queued(resumed) -> running inside one request span, and the slot
    track shows both occupancies; the same in both packages."""

    (japi, jp), (api, p) = models

    def drain(server_cls, a, params, obs_cls):
        obs = obs_cls(trace=True, metrics=True, monitor=True)
        srv = server_cls(a, params, batch=1, context=48, paged=True,
                         page_size=4, prefill_chunk=8, scheduler="priority",
                         obs=obs)
        rb = srv.submit(list(range(1, 17)), max_new=6, slo="batch")
        for _ in range(4):
            srv.tick()
        ri = srv.submit([7, 5, 3, 2], max_new=4, slo="interactive",
                        deadline=20.0)
        srv.run_until_drained()
        return obs, rb, ri

    jobs, jrb, jri = drain(JaxServer, japi, jp, JaxObservability)
    with torch.inference_mode():
        obs, rb, ri = drain(Server, api, p, Observability)
    assert (rb.out, ri.out, rb.preempted) == (jrb.out, jri.out, jrb.preempted)
    assert rb.preempted >= 1 and rb.done and ri.done
    doc = obs.export()
    assert validate_trace(doc) == []
    assert _events(doc) == _events(jobs.export())
    evs = [ev for ev in parse_trace(doc)
           if tuple(ev["track"]) == ("request", rb.rid)]
    (req_span,) = spans_from_events(evs)
    kids = [c.name for c in req_span.children]
    assert kids == ["queued", "running"] * (1 + rb.preempted)
    resumed = [c for c in req_span.children
               if c.name == "queued" and c.args.get("resumed")]
    assert len(resumed) == rb.preempted
    slot_spans = spans_from_events(
        [ev for ev in parse_trace(doc) if tuple(ev["track"]) == ("slot", 0)])
    occupants = [sp.args["rid"] for sp in slot_spans]
    assert occupants.count(rb.rid) == 1 + rb.preempted
    assert occupants.count(ri.rid) == 1
    snap = obs.registry.snapshot()
    assert snap["counters"][
        'serve.preemptions{reason="slo-preempt"}'] == rb.preempted
    assert obs.monitor.accepted


def _mutant_drain(server_cls, api, params, obs, mutant, trace):
    srv = server_cls(api, params, obs=obs, **MUTANT_SERVE)
    srv.alloc.__class__ = mutant
    pending = iter(sorted(trace, key=lambda r: (r.arrival, r.rid)))
    nxt = next(pending, None)
    clock = 0
    while (nxt is not None or srv.queue
           or any(r is not None for r in srv.slot_req)):
        while nxt is not None and nxt.arrival <= clock:
            srv.submit(list(nxt.prompt), max_new=nxt.max_new, slo=nxt.slo)
            nxt = next(pending, None)
        srv.tick()
        clock += 1
        if obs.monitor.violation is not None or clock > 400:
            break
    return srv


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_mutant_trips_monitor_at_the_reference_tick(models, name, tmp_path):
    """A planted allocator mutant trips the port's monitor at the tick
    and op where it trips the reference's (or neither trips), and a
    tripped monitor's trail replays to a failure on the mutant and clean
    on the real allocator."""

    (japi, jp), (api, p) = models
    cfg = dict(TRACE, **MUTANT_TRACE)
    trace = workload.generate_trace(workload.TraceConfig(**cfg))
    jtrace = jax_workload.generate_trace(jax_workload.TraceConfig(**cfg))
    jobs = JaxObservability(trace=True, metrics=True, monitor=True,
                            monitor_window=64)
    _mutant_drain(JaxServer, japi, jp, jobs, JAX_MUTANTS[name], jtrace)
    obs = Observability(trace=True, metrics=True, monitor=True,
                        monitor_window=64)
    with torch.inference_mode():
        _mutant_drain(Server, api, p, obs, MUTANTS[name], trace)
    jv, v = jobs.monitor.violation, obs.monitor.violation
    assert (v is None) == (jv is None)
    # this drain frees and shares pages but never rewinds, trims, runs
    # out of pages mid-tick or copies on write: two mutants trip
    if name in ("release-leaks-shared", "share-skips-refcount"):
        assert v is not None and "divergence" in v["message"]
    if v is None:
        assert obs.monitor.accepted
        return
    assert (v["tick"], v["op_index"], v["allocator"]) == \
        (jv["tick"], jv["op_index"], jv["allocator"]) == \
        (v["tick"], v["op_index"], name)
    assert obs.monitor.ops == jobs.monitor.ops
    path = tmp_path / "trail.json"
    payload = obs.monitor.dump_trail(str(path))
    jpayload = jobs.monitor.trail()
    assert json.loads(path.read_text()) == payload
    assert {k: v for k, v in payload.items() if k != "source"} == \
        {k: v for k, v in jpayload.items() if k != "source"}
    assert payload["replayable"] and payload["allocator"] == name
    sem = AllocatorSemantics(AllocConfig(**payload["config"]),
                             canonical=False)
    ops = [tuple(op) for op in payload["ops"]]
    with pytest.raises(ConformanceError):
        replay_ops(sem, ops, MUTANTS[name])
    doc = obs.export()
    assert doc["monitor"]["status"] == "violation"
    assert any(ev["name"] == "conformance.violation"
               for ev in parse_trace(doc))
    assert obs.registry.snapshot()["counters"][
        "serve.conformance_violations"] == 1


@pytest.mark.parametrize("policy", ["fcfs", "prefix", "priority"])
def test_tracing_scheduler_matches_reference(models, policy):
    (japi, jp), (api, p) = models
    trace, jtrace = _traces()
    share = policy == "prefix"
    jobs = JaxObservability(trace=True, metrics=False)
    jsched = JaxTracingScheduler(jax_make_scheduler(policy, age_limit=4),
                                 recorder=jobs.recorder)
    jsrv = JaxServer(japi, jp, scheduler=jsched, share_prefix=share,
                     obs=jobs, **SERVE)
    jax_workload.drive_trace(jsrv, jtrace)
    obs = Observability(trace=True, metrics=False)
    sched = TracingScheduler(make_scheduler(policy, age_limit=4),
                             recorder=obs.recorder)
    srv = Server(api, p, scheduler=sched, share_prefix=share, obs=obs,
                 **SERVE)
    with torch.inference_mode():
        workload.drive_trace(srv, trace)
    assert sched.kind == jsched.kind == f"traced-{policy}"
    assert sched.trace == jsched.trace
    assert any(d is not None for _, d in sched.trace)
    decided = {h for h, d in sched.trace if d is not None}
    assert "pick" in decided and "victim" in decided
    assert ("preempt_for" in decided) == (policy == "priority")
    sched_events = [e for e in _events(obs.recorder.events)
                    if e[0].startswith("sched.")]
    assert sched_events == [e for e in _events(jobs.recorder.events)
                            if e[0].startswith("sched.")]
    assert len(sched_events) == sum(d is not None for _, d in sched.trace)


@pytest.mark.parametrize("case", ["shared", "speculate"])
def test_phase_profiler_reports_the_reference_phases(models, case):
    (japi, jp), (api, p) = models
    if case == "shared":
        kw = dict(SERVE, share_prefix=True, scheduler="prefix")
        trace, jtrace = _traces(prefix_len=10)
    else:
        kw = dict(SERVE, kv_pages=None, speculate="ngram", spec_depth=3)
        trace, jtrace = _traces(prompt_len=(8, 12), shared_frac=0.0)
        # one token repeated: the n-gram drafter finds matches
        trace = [dataclasses.replace(t, prompt=(t.prompt[0],) * 8)
                 for t in trace]
        jtrace = [dataclasses.replace(t, prompt=(t.prompt[0],) * 8)
                  for t in jtrace]
    jobs = JaxObservability(trace=True, profile=True)
    jsrv = JaxServer(japi, jp, obs=jobs, **kw)
    jax_workload.drive_trace(jsrv, jtrace)
    obs = Observability(trace=True, profile=True)
    srv = Server(api, p, obs=obs, **kw)
    with torch.inference_mode():
        workload.drive_trace(srv, trace)
    rep, jrep = obs.profiler.report(), jobs.profiler.report()
    assert set(rep) == set(jrep)
    assert {k: r["count"] for k, r in rep.items()} == \
        {k: r["count"] for k, r in jrep.items()}
    assert obs.profiler.ticks == jobs.profiler.ticks == srv.ticks
    want = {"shared": "cow_copy", "speculate": "speculate"}[case]
    assert want in rep and "host" in rep
    assert abs(sum(r["share"] for r in rep.values()) - 1.0) < 1e-9
    assert "phase profile" in obs.profiler.format()


def test_profiler_syncs_nothing_for_cpu_tensors(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("synchronize called for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    tree = {"blocks": {"a": {"kv": {"k": torch.zeros(2), "v": [
        torch.ones(1), (torch.zeros(3),)]}}}, "n": 3}
    sync_devices(tree)
    prof = PhaseProfiler(warmup_ticks=0)
    prof.tick_begin()
    t0 = prof.phase_begin()
    assert prof.phase_end("decode", t0, sync=tree) >= 0
    prof.tick_end()
    assert set(prof.report()) == {"decode", "host"}
    assert PhaseProfiler().format().startswith("phase profile: no samples")


def test_monitor_needs_a_paged_server(models):
    _, (api, p) = models
    with pytest.raises(ValueError, match="needs Server\\(paged=True\\)"):
        Server(api, p, batch=1, context=16,
               obs=Observability(monitor=True))
    obs = Observability()
    srv = Server(api, p, batch=1, context=16, obs=obs)
    with pytest.raises(ValueError, match="per-Server"):
        obs.attach(Server(api, p, batch=1, context=16))
    assert obs._server is srv


def _export_doc(models, tmp_path, which):
    (japi, jp), (api, p) = models
    trace, jtrace = _traces()
    kw = dict(SERVE, share_prefix=True, scheduler="prefix")
    path = tmp_path / f"{which}.json"
    if which == "port":
        obs = Observability(trace=True, metrics=True, monitor=True)
        with torch.inference_mode():
            workload.drive_trace(Server(api, p, obs=obs, **kw), trace)
    else:
        obs = JaxObservability(trace=True, metrics=True, monitor=True)
        jax_workload.drive_trace(JaxServer(japi, jp, obs=obs, **kw), jtrace)
    obs.export(str(path))
    return path


@pytest.mark.parametrize("which", ["port", "reference"])
def test_obs_cli_summarize_check_export(models, tmp_path, capsys, which):
    path = _export_doc(models, tmp_path, which)
    assert obs_main(["summarize", str(path)]) == 0
    out = capsys.readouterr().out
    assert "workload: 7 requests" in out and "monitor: accepted" in out

    assert obs_main(["check", str(path), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["problems"] == []
    assert report["monitor"] == report["monitor_recheck"] == "accepted"
    # the reference's CLI reads the same document the same way
    assert jax_obs_main(["check", str(path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == report

    chrome = tmp_path / "chrome.json"
    assert obs_main(["export", str(path), "--out", str(chrome)]) == 0
    capsys.readouterr()
    stripped = json.loads(chrome.read_text())
    assert set(stripped) == {"displayTimeUnit", "traceEvents"}
    assert stripped["traceEvents"] == json.loads(
        path.read_text())["traceEvents"]

    # a tampered monitor section fails the offline re-check
    doc = json.loads(path.read_text())
    doc["monitor"]["records"][0][2] = False
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    assert obs_main(["check", str(bad)]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_thaw_ret_refreezes_pair_lists():
    assert thaw_ret([[1, 2], [3, 4]]) == ((1, 2), (3, 4))
    assert thaw_ret(True) is True and thaw_ret(3) == 3


def test_timed_server_drain_attaches_obs_to_the_last_drain(models):
    _, (api, p) = models
    obs = Observability(trace=True, metrics=True, monitor=True)
    reg, stats = MetricsRegistry(), {}
    us = timed_server_drain(api, p, batch=2, context=32, paged=True,
                            page_size=4, prompts=[[1, 2, 3], [4, 5, 6, 7]],
                            max_new=3, obs=obs, registry=reg,
                            stats_out=stats, warmup=1, iters=1)
    assert us > 0 and stats == reg.collect("serve")
    doc = obs.export()
    snap = obs.registry.snapshot()
    assert snap["counters"]["serve.submitted"] == 2     # one drain only
    assert snap["counters"]["serve.retired"] == 2
    assert validate_trace(doc) == []
    assert doc["monitor"]["status"] == "accepted"
    assert snap["gauges"]["serve.drain.ticks"] == stats["ticks"]


def test_drive_trace_records_into_the_attached_bundle(models):
    _, (api, p) = models
    trace, _ = _traces()
    obs = Observability(trace=True, metrics=True, monitor=True)
    srv = Server(api, p, obs=obs, **SERVE)
    with torch.inference_mode():
        records = workload.drive_trace(srv, trace)
    names = [e["name"] for e in obs.recorder.events]
    assert names.count("workload.submitted") == len(trace)
    assert names.count("workload.retired") == len(trace)
    parsed = workload.records_from_events(parse_trace(obs.export()))
    assert parsed == {rid: {k: v for k, v in r.items() if k != "request"}
                      for rid, r in records.items()}
    # and timed_trace_drain hands its bundle to the last drain
    obs2 = Observability(trace=True, metrics=True, monitor=True)
    stats = {}
    timed_trace_drain(api, p, trace, obs=obs2, stats_out=stats, warmup=1,
                      iters=1, **SERVE)
    assert workload.records_from_events(obs2.recorder.events) == parsed
    assert obs2.registry.snapshot()["counters"]["serve.submitted"] == \
        len(trace)
