"""The port's metrics registry and trace recorder against the JAX
package's: the same operations on both give the same ``collect``,
``snapshot``, Prometheus text and quantiles, and the same trace document
(events, spans, validation), field for field.  Both recorders run on one
scripted clock, so even the timestamps agree; only the provenance
``meta`` differs (the tool's name)."""

from dataclasses import asdict

import pytest

pytest.importorskip("torch")

from repro.obs import metrics as jax_metrics  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402


def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve.retired", help="requests retired").inc()
    reg.counter("serve.retired").inc(2.5)
    reg.counter("serve.preemptions", reason="slo").inc(3)
    reg.counter("serve.preemptions", reason="oom").inc()
    reg.gauge("serve.ticks").set(17)
    reg.gauge("serve.active").inc(4)
    reg.gauge("serve.active").dec()
    reg.gauge("traffic.p99_all").set(26.67)
    h = reg.histogram("serve.queue_wait", help="ticks queued")
    for v in (0, 0.5, 1, 2, 3, 5, 9, 17, 100, 1000, 40000):
        h.observe(v)
    reg.histogram("serve.latency", slo="batch").observe(12)
    return reg


def test_registry_matches_reference():
    got, want = _fill(metrics), _fill(jax_metrics)
    assert got.snapshot() == want.snapshot()
    assert got.to_prometheus() == want.to_prometheus()
    for prefix in ("serve", "traffic", "absent"):
        assert got.collect(prefix) == want.collect(prefix)
    assert got.collect("serve") == {"retired": 3.5, "ticks": 17.0,
                                    "active": 3.0}
    assert [(n, k) for n, k, _ in got] == [(n, k) for n, k, _ in want]


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_match_reference(q):
    got, want = metrics.Histogram(), jax_metrics.Histogram()
    for v in (0.2, 1.5, 3, 3, 7, 64, 65, 1e4):
        got.observe(v)
        want.observe(v)
    assert got.quantile(q) == want.quantile(q)
    assert got.mean() == want.mean() and got.buckets == want.buckets


def test_registry_errors_match_reference():
    for mod in (metrics, jax_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")
        with pytest.raises(ValueError, match=">= 0"):
            reg.counter("x").inc(-1)
        h = reg.histogram("h")
        assert h.quantile(0.5) == 0.0
        h.observe(2)
        with pytest.raises(ValueError, match="quantile"):
            h.quantile(1.5)


def _record(mod):
    """A drain's worth of events on a scripted clock, left with one span
    open (``close_open_spans`` truncates it)."""

    ticks = iter(range(1000))
    rec = mod.TraceRecorder(clock=lambda: next(ticks) * 1e-3)
    rec.instant("workload.submitted", track=("request", 0), tick=0, rid=0,
                arrival=0, slo="interactive", deadline=48)
    rec.begin("request", track=("request", 0), tick=0)
    rec.begin("queued", track=("request", 0), tick=0)
    rec.end("queued", track=("request", 0), tick=1)
    rec.begin("tick", tick=1, active=1)
    rec.begin("prefill", tick=1, slots=1)
    rec.end("prefill", tick=1)
    rec.counter("kv.used_pages", 3, tick=1)
    rec.end("tick", tick=1)
    rec.begin("running", track=("request", 0), tick=1)
    rec.begin("slot", track=("slot", 2), tick=1, rid=0)
    rec.end("slot", track=("slot", 2), tick=4)
    rec.end("running", track=("request", 0), tick=4)
    rec.instant("workload.retired", track=("request", 0), tick=4, rid=0,
                finish=4, tokens=3)
    rec.begin("tick", tick=5)
    return rec


def test_trace_recorder_and_export_match_reference(tmp_path):
    got, want = _record(trace), _record(jax_trace)
    assert got.events == want.events
    assert got.open_spans(("request", 0)) == ["request"]
    assert got.close_open_spans() == want.close_open_spans() == 2
    assert got.events == want.events
    meta = {"created_utc": "2026-01-01T00:00:00Z"}
    doc = trace.export_trace(got.events, str(tmp_path / "t.json"),
                             metrics={"gauges": {}}, meta=meta)
    jdoc = jax_trace.export_trace(want.events, metrics={"gauges": {}},
                                  meta=meta)
    assert doc == jdoc
    assert trace.TRACE_KIND == jax_trace.TRACE_KIND
    assert trace.parse_trace(doc) == jax_trace.parse_trace(jdoc)
    assert trace.parse_trace(doc) == [
        dict(ev, track=tuple(ev["track"])) for ev in got.events]
    assert trace.validate_trace(doc) == jax_trace.validate_trace(jdoc) == []
    spans = trace.spans_from_events(trace.parse_trace(doc))
    jspans = jax_trace.spans_from_events(jax_trace.parse_trace(jdoc))
    assert [asdict(s) for s in spans] == [asdict(s) for s in jspans]
    (req,) = [s for s in spans if s.name == "request"]
    assert [c.name for c in req.children] == ["queued", "running"]
    assert req.args == {"truncated": True}


def test_default_meta_names_the_port():
    doc = trace.export_trace([])
    assert doc["meta"]["tool"].startswith("repro_torch ")
    assert trace.validate_trace(doc) == []
    jdoc = jax_trace.export_trace([])
    assert set(doc["meta"]) == set(jdoc["meta"])


def test_validate_trace_flags_the_same_problems():
    good = trace.export_trace(_record(trace).events,
                              meta={"created_utc": "x"})
    bad = dict(good, kind="other", schema=9, meta={})
    assert trace.validate_trace(bad) == jax_trace.validate_trace(bad)
    assert len(trace.validate_trace(bad)) == 4       # + the open span
    swapped = dict(good, traceEvents=list(reversed(good["traceEvents"])))
    assert trace.validate_trace(swapped) == \
        jax_trace.validate_trace(swapped) != []
