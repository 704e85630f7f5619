"""The port's program ranges (``repro_torch.obs.profile.span``) and the
phase profiler's counters, on the CPU.

A profiled drain of the reduced qwen1.5-4b times ``attn.kv`` and
``attn.core`` once a layer and step into each phase's entry, and counts
the keys, query-key pairs, chunk tokens and padded positions the steps
were handed; under ``torch.profiler`` every range is a named
``record_function`` (the Server's inside its ``serve.tick``, the train
step's three); with neither on, the helper opens nothing.  The
recorder's origin on the profiler's clock lays its phase spans over a
profiler trace of the same drain.  The benchmark's five metrics that
read these numbers are held to hand values on synthetic runs.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import (Observability, parse_trace,  # noqa: E402
                             spans_from_events)
from repro_torch.obs import profile as obs_profile  # noqa: E402
from repro_torch.runtime import Server  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402

SERVE = dict(batch=3, context=48, prefill_chunk=8, paged=True, page_size=4,
             kv_pages=40)
LENGTHS = (5, 13, 21, 9)        # prompts of 1-3 chunks, one queued
SERVE_RANGES = {"serve.tick", "serve.admit", "serve.back_pages",
                "serve.decode", "serve.prefill", "serve.speculate",
                "serve.dispatch", "serve.readback"}
ATTN_RANGES = {"attn.kv", "attn.core"}


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen1.5-4b").reduced().replace(logits_dtype="float32")
    api = build_model(cfg)
    return api, api.init(0, "cpu")


class StepSpy:
    """The model API, with each step's host-side arguments kept."""

    def __init__(self, api):
        self._api = api
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._api, name)

    def decode_step(self, params, state, tokens, pos, *extra, active):
        self.calls.append(("decode", pos.numpy().copy(),
                           active.numpy().copy()))
        return self._api.decode_step(params, state, tokens, pos, *extra,
                                     active=active)

    def prefill_step(self, params, state, tokens, pos, lengths, *extra):
        self.calls.append(("prefill", pos.numpy().copy(),
                           lengths.numpy().copy(), tokens.shape[1]))
        return self._api.prefill_step(params, state, tokens, pos, lengths,
                                      *extra)


def _prompts(lengths=LENGTHS, seed=0, repeat=()):
    g = torch.Generator().manual_seed(seed)
    out = []
    for i, n in enumerate(lengths):
        if i in repeat:
            out.append([7, 8] * (n // 2) + [7] * (n % 2))
        else:
            out.append(torch.randint(1, 250, (n,), generator=g).tolist())
    return out


def _server(api, params, obs=None, prompts=None, max_new=4, **kw):
    srv = Server(api, params, obs=obs, **dict(SERVE, **kw))
    for p in prompts or _prompts():
        srv.submit(p, max_new)
    return srv


def _drain(*args, **kw):
    srv = _server(*args, **kw)
    with torch.inference_mode():
        srv.run_until_drained()
    return srv


def _hand_counts(calls):
    """The counters, from the positions and lengths each step was
    handed: a decoding slot at p reads p + 1 keys; a prefilling slot at
    p with n tokens reads p + n, its token i attending p + i + 1."""

    want = {"decode": dict(kv_tokens=0, qk_pairs=0),
            "prefill": dict(kv_tokens=0, qk_pairs=0, tokens=0,
                            positions=0)}
    for call in calls:
        if call[0] == "decode":
            _, pos, active = call
            keys = sum(int(p) + 1 for p, a in zip(pos, active) if a)
            want["decode"]["kv_tokens"] += keys
            want["decode"]["qk_pairs"] += keys
        else:
            _, pos, lengths, T = call
            w = want["prefill"]
            for p, n in zip(pos.tolist(), lengths.tolist()):
                if n:
                    w["kv_tokens"] += p + n
                    w["qk_pairs"] += sum(p + i + 1 for i in range(n))
                    w["tokens"] += n
            w["positions"] += len(pos) * T
    return want


def test_profiled_drain_times_each_layer_and_counts_the_steps(model):
    api, params = model
    spy = StepSpy(api)
    obs = Observability(trace=False, metrics=False, profile=True,
                        profile_warmup_ticks=0)
    srv = _drain(spy, params, obs)
    rep = obs.profiler.report()
    steps = {ph: sum(c[0] == ph for c in spy.calls)
             for ph in ("decode", "prefill")}
    assert steps["decode"] > 0 and steps["prefill"] > 0
    assert obs.profiler.ticks == srv.ticks == rep["host"]["count"]
    L = api.cfg.n_layers
    for ph, n in steps.items():
        entry = rep[ph]
        assert entry["count"] == n
        for name in ATTN_RANGES:
            assert entry["ranges"][name]["count"] == L * n
            assert entry["ranges"][name]["total_us"] > 0
        assert entry["ranges"]["serve.dispatch"]["count"] == n
        assert entry["ranges"]["serve.readback"]["count"] == n
        ranged = sum(entry["ranges"][r]["total_us"]
                     for r in ("serve.dispatch", "serve.readback"))
        assert ranged <= entry["total_us"]
    want = _hand_counts(spy.calls)
    for ph, counts in want.items():
        assert {k: rep[ph][k] for k in counts} == counts
    assert want["prefill"]["tokens"] == sum(LENGTHS)
    assert set(rep["host"]["ranges"]) == {"serve.admit", "serve.back_pages"}
    assert rep["host"]["ranges"]["serve.admit"]["count"] == srv.ticks
    assert abs(sum(r["share"] for r in rep.values()) - 1.0) < 1e-9


def test_an_empty_tick_counts_nothing(model):
    api, params = model
    obs = Observability(trace=True, metrics=False, profile=True,
                        profile_warmup_ticks=0)
    srv = _drain(api, params, obs)
    ticks, rep = obs.profiler.ticks, obs.profiler.report()
    events = len(obs.recorder.events)
    with torch.inference_mode():
        assert srv.tick() == 0
    assert obs.profiler.ticks == ticks == srv.ticks
    assert obs.profiler.report() == rep
    assert len(obs.recorder.events) == events
    assert obs_profile._open is None


def _kineto(prof):
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def test_profiler_trace_names_every_range_and_ticks_hold_the_ops(model):
    from torch.profiler import ProfilerActivity, profile

    api, params = model
    # one prompt of a repeated pair, which the n-gram drafter continues,
    # beside random ones: ticks with decode, speculation and prefill
    srv = _server(api, params, prompts=_prompts(repeat=(1,)), max_new=6,
                  speculate="ngram", spec_depth=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.inference_mode():
        srv.run_until_drained()
    assert srv.stats()["spec_ticks"] > 0
    events = _kineto(prof)
    names = {n for n, _, _ in events}
    assert SERVE_RANGES | ATTN_RANGES <= names
    ticks = sorted((s, e) for n, s, e in events if n == "serve.tick")
    assert len(ticks) == srv.ticks + 1      # the last, empty tick too
    ops = [(s, e) for n, s, e in events if n.startswith("aten::")]
    assert ops
    starts = [s for s, _ in ticks]
    for s, e in ops:
        i = np.searchsorted(starts, s, side="right") - 1
        assert i >= 0 and ticks[i][0] <= s and e <= ticks[i][1]


def test_no_profiler_and_no_profiled_tick_open_no_range(model, monkeypatch):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    api, params = model
    assert obs_profile.span("attn.kv") is obs_profile._OFF
    _drain(api, params)
    obs = Observability(trace=True, metrics=True, profile=False)
    _drain(api, params, obs)
    assert opened == []
    # a profiled tick times its ranges, still with no record_function
    obs = Observability(trace=False, metrics=False, profile=True)
    _drain(api, params, obs)
    assert opened == []
    assert "attn.kv" in obs.profiler.report()["decode"]["ranges"]


def test_recorder_origin_lays_phases_over_the_profiler_trace(model):
    from torch.profiler import ProfilerActivity, profile

    api, params = model
    obs = Observability(trace=True, metrics=False, profile=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drain(api, params, obs)
    doc = obs.export()
    origin = doc["meta"]["ts_origin_unix_ns"]
    assert origin == obs.recorder.origin_ns

    def walk(spans):
        for s in spans:
            yield s
            yield from walk(s.children)

    phases = sorted((origin + s.ts * 1e3, origin + (s.ts + s.dur) * 1e3)
                    for s in walk(spans_from_events(parse_trace(doc)))
                    if s.name == "phase.decode")
    ranges = sorted((s, e) for n, s, e in _kineto(prof)
                    if n == "serve.decode")
    assert phases and len(phases) == len(ranges)
    for (a0, a1), (b0, b1) in zip(phases, ranges):
        assert abs(a0 - b0) <= 2e6 and abs(a1 - b1) <= 2e6


def test_profiled_train_step_names_its_three_ranges():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.train import (TrainConfig, build_train_step,
                                           init_train_state)

    cfg = get_config("smollm-135m").reduced()
    api = build_model(cfg)
    tcfg = TrainConfig(lr=1e-3, warmup=1, total_steps=10)
    state = init_train_state(api, 0, tcfg, device="cpu")
    step = build_train_step(api, tcfg)
    tokens = torch.randint(1, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, {"tokens": tokens, "labels": tokens})
    found = [n for n, _, _ in sorted(_kineto(prof), key=lambda e: e[1])
             if n.startswith("train.")]
    assert found == ["train.forward", "train.backward", "train.optimizer"]


# -- the benchmark's metrics over these numbers -------------------------------

CHAT = "qwen1.5-4b.chat-c64"
NEW_METRICS = ("kv_gather_ms.chat", "attn_core_ms.chat",
               "kv_read_roofline.chat", "dispatch_ms.chat",
               "prefill_useful_share.chat")


def _run(device: str) -> harness.Run:
    bj = harness.load_benchmark()
    run = harness.prepare(bj, CHAT, 1, 1.0, True, torch.device(device), 0.0)
    run.counters["ticks"] = 4
    r = lambda us, n: {"total_us": us, "count": n}
    run.spans = {
        "decode": {"total_us": 9e5, "count": 4.0, "mean_us": 2.25e5,
                   "share": 0.3, "kv_tokens": 20_000, "qk_pairs": 20_000,
                   "ranges": {"attn.kv": r(2e5, 160), "attn.core": r(1e5, 160),
                              "serve.dispatch": r(8e4, 4)}},
        "prefill": {"total_us": 1.6e6, "count": 3.0, "mean_us": 5.3e5,
                    "share": 0.6, "kv_tokens": 6_000, "qk_pairs": 400_000,
                    "tokens": 600, "positions": 3 * 64 * 128,
                    "ranges": {"attn.kv": r(3e5, 120),
                               "attn.core": r(5e5, 120),
                               "serve.dispatch": r(4e4, 3)}},
        "host": {"total_us": 2e5, "count": 4.0, "mean_us": 5e4, "share": 0.1},
    }
    return run


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_new_metric_reads_the_spans_on_a_card_only(metric):
    mod = harness.load_metric(metric)
    assert mod.read(_run("cpu")) is None
    bare = _run("cuda")
    bare.spans = {}
    assert mod.read(bare) is None
    got = mod.read(_run("cuda"))
    # qwen1.5-4b: 40 layers, 20 kv heads of 128, bf16
    kv_bytes = lambda keys: keys * 40 * 2 * 20 * 128 * 2
    flops = lambda pairs: 4.0 * 40 * 20 * 128 * pairs
    ideal = sum(max(kv_bytes(k) / 3.35e12, flops(p) / 989e12)
                for k, p in ((20_000, 20_000), (6_000, 400_000)))
    want = {"kv_gather_ms.chat": (2e5 + 3e5) / 1e3 / 4,
            "attn_core_ms.chat": (1e5 + 5e5) / 1e3 / 4,
            "dispatch_ms.chat": (8e4 + 4e4) / 1e3 / 4,
            "prefill_useful_share.chat": 100.0 * 600 / (3 * 64 * 128),
            "kv_read_roofline.chat": 100.0 * ideal / 1.1}[metric]
    assert got == pytest.approx(want, rel=1e-12)
