"""The port's seeded traffic traces and trace drains against the JAX
package's.

``generate_trace`` must give the reference's trace request for request
(poisson and bursty arrivals, shared prefixes, several seeds).  Then one
trace is driven through the port's paged ``Server`` and the reference's
under each policy (fcfs, prefix with copy-on-write sharing, priority):
every request's tokens and finish tick equal, and ``summarize``'s record
equal.  Reduced configs in f32, weights carried across by
``params_from_jax``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import workload as jax_workload  # noqa: E402
from repro.runtime.scheduler import make_scheduler as jax_make_scheduler  # noqa: E402
from repro.runtime.serve import Server as JaxServer  # noqa: E402
from repro.runtime.tunables import timed_trace_drain as jax_timed_trace_drain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.runtime import Server, workload  # noqa: E402
from repro_torch.runtime.scheduler import make_scheduler  # noqa: E402
from repro_torch.runtime.tunables import timed_trace_drain  # noqa: E402

# seed 5 of this trace on 10 pages: every policy defers on page OOM,
# prefix shares, priority preempts
TRACE = dict(requests=7, burst=3, burst_every=2, prompt_len=(4, 12),
             max_new=(2, 5), shared_frac=0.8, prefix_len=8, vocab=256,
             seed=5)
SERVE = dict(batch=2, context=40, prefill_chunk=8, paged=True, page_size=4,
             kv_pages=10)


def _fields(trace):
    return [dataclasses.astuple(r) for r in trace]


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("arrival,shared", [("bursty", 0.0), ("bursty", 0.5),
                                            ("poisson", 0.0),
                                            ("poisson", 0.7)])
def test_generate_trace_matches_reference(arrival, shared, seed):
    kw = dict(requests=20, arrival=arrival, rate=0.6, burst=5,
              burst_every=7, prompt_len=(3, 30), max_new=(2, 9),
              interactive_frac=0.4, shared_frac=shared, prefix_len=11,
              vocab=500, seed=seed)
    got = workload.generate_trace(workload.TraceConfig(**kw))
    want = jax_workload.generate_trace(jax_workload.TraceConfig(**kw))
    assert _fields(got) == _fields(want)
    assert all(r.arrival <= s.arrival for r, s in zip(got, got[1:]))
    if shared:
        prefix = [r.prompt[:11] for r in got if len(r.prompt) > 30]
        assert prefix and all(p == prefix[0] for p in prefix)


def test_generate_trace_rejects_unknown_arrivals():
    with pytest.raises(ValueError, match="unknown arrival"):
        workload.generate_trace(workload.TraceConfig(arrival="uniform"))


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


def _records(records):
    """The per-request record without its live request object, plus the
    request's tokens."""

    return {rid: ({k: v for k, v in r.items() if k != "request"},
                  list(r["request"].out))
            for rid, r in records.items()}


@pytest.mark.parametrize("policy", ["fcfs", "prefix", "priority"])
def test_drive_trace_matches_reference(models, policy):
    (japi, jp), (api, p) = models
    trace = workload.generate_trace(workload.TraceConfig(**TRACE))
    jtrace = jax_workload.generate_trace(
        jax_workload.TraceConfig(**TRACE))
    share = policy == "prefix"
    jsrv = JaxServer(japi, jp, scheduler=jax_make_scheduler(
        policy, age_limit=4), share_prefix=share, **SERVE)
    want = jax_workload.drive_trace(jsrv, jtrace)
    rec = TraceRecorder()
    srv = Server(api, p, scheduler=make_scheduler(policy, age_limit=4),
                 share_prefix=share, **SERVE)
    with torch.inference_mode():
        got = workload.drive_trace(srv, trace, recorder=rec)
    assert _records(got) == _records(want)
    assert srv.ticks == jsrv.ticks
    assert workload.summarize(got, srv.ticks) == \
        jax_workload.summarize(want, jsrv.ticks)
    # the records are the recorder's events, read back
    assert _records(workload.records_from_events(rec.events, {
        rid: r["request"] for rid, r in got.items()})) == _records(got)
    st = srv.stats()
    assert st["deferrals"] > 0
    assert (st["shared_tokens"] > 0) == share
    assert (st["preemptions"] > 0) == (policy == "priority")
    for k in ("deferrals", "shared_tokens", "preemptions", "cow_copies"):
        assert st[k] == jsrv.stats()[k]


def test_timed_trace_drain_matches_reference(models):
    (japi, jp), (api, p) = models
    trace = workload.generate_trace(workload.TraceConfig(**TRACE))
    jtrace = jax_workload.generate_trace(
        jax_workload.TraceConfig(**TRACE))
    kw = dict(warmup=0, iters=1, share_prefix=True, **SERVE)
    want, got = {}, {}
    jax_timed_trace_drain(japi, jp, jtrace, scheduler="prefix",
                          stats_out=want, **kw)
    us = timed_trace_drain(api, p, trace, scheduler="prefix",
                           stats_out=got, **kw)
    assert us > 0
    assert _records(got.pop("records")) == _records(want.pop("records"))
    assert got == want
    assert {"p99_all", "slo_attainment", "goodput_per_tick",
            "prefill_chunks", "preemptions", "shared_tokens"} <= set(got)


def test_timed_trace_drain_with_obs_raises(models):
    """``obs`` reaches the last drain's ``Server``, which does not take
    one yet: the error says so instead of dropping it."""

    _, (api, p) = models
    trace = workload.generate_trace(workload.TraceConfig(**TRACE))
    with pytest.raises(ValueError, match="obs= is not ported yet"):
        timed_trace_drain(api, p, trace, obs=object(), warmup=0, iters=1,
                          **SERVE)
