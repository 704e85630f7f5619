"""The harness on the CPU: its copied arithmetic (generators, exact
percentiles, the interval union, the matmul roofline, the FLOP count),
finding cells' files by name, a whole small run of each kind, and the
faults that must turn ``correct`` false."""

from __future__ import annotations

import json
import math
import shutil
import statistics

import numpy as np
import pytest
import torch

from bench import flops, harness, model, stats, trace
from bench.kinds import closed_chat, train_batches

from _small import CHAT, TRAIN, chat_inputs, run_small, train_inputs


# -- exact percentiles --------------------------------------------------------

@pytest.mark.parametrize("q", [0, 5, 50, 90, 95, 99, 100])
def test_percentile_is_the_inclusive_quantile(q):
    xs = list(np.random.default_rng(q).lognormal(0.0, 1.0, 257))
    cuts = statistics.quantiles(xs, n=100, method="inclusive")
    want = min(xs) if q == 0 else max(xs) if q == 100 else cuts[q - 1]
    assert stats.percentile(xs, q) == pytest.approx(want, rel=1e-12)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_of_one_and_of_none():
    assert stats.percentile([3.0], 90) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


# -- generators ---------------------------------------------------------------

def _sizes(clients, n, rounds=range(1, 4)):
    return [[(len(r.prompt), r.max_new, r.shared)
             for r in (clients.spec(c, k) for k in rounds)]
            for c in range(n)]


def test_chat_requests_same_seed_same_requests():
    _, traffic = chat_inputs()
    a = closed_chat.Clients(traffic, 7, 256)
    b = closed_chat.Clients(traffic, 7, 256)
    c = traffic["clients"]
    assert [[a.spec(i, k).prompt for k in range(4)] for i in range(c)] == \
        [[b.spec(i, k).prompt for k in range(4)] for i in range(c)]
    # drawn as needed: the order of the draws changes nothing
    a, b = (closed_chat.Clients(traffic, 7, 256) for _ in range(2))
    first = [a.next(i) for i in range(c)] + [a.next(i) for i in range(c)]
    later = [b.spec(i, 1) for i in range(c)] + [b.spec(i, 0)
                                                 for i in range(c)]
    assert [r.prompt for r in first] == \
        [r.prompt for r in later[c:] + later[:c]]


def test_chat_seeds_deal_the_same_client_sequences():
    traffic = harness.load_traffic("chat-c64")
    c = traffic["clients"]
    a = closed_chat.Clients(traffic, 1, 151936)
    b = closed_chat.Clients(traffic, 2 ** 31 + 5, 151936)
    assert a.spec(0, 1).prompt != b.spec(0, 1).prompt
    sa, sb = _sizes(a, c, range(4)), _sizes(b, c, range(4))
    assert sa != sb and sorted(sa) == sorted(sb)
    for k in range(4):
        assert sum(a.spec(i, k).shared for i in range(c)) == c // 2
    sp = traffic["system_prompt"]["tokens"]
    for r in (a.spec(i, k) for i in range(c) for k in range(1, 6)):
        assert 32 <= len(r.prompt) <= 768 and 16 <= r.max_new <= 256
        assert len(r.prompt) + r.max_new <= 1024
        assert (r.prompt[:sp] == a.system) == r.shared


def test_chat_round_zero_is_the_loop_in_flight():
    """Round 0 holds requests picked in proportion to their output
    lengths, each with part of its output already written: its prompt
    carries the written part, its ``max_new`` the rest."""

    traffic = harness.load_traffic("chat-c64")
    c = traffic["clients"]
    zero = closed_chat.round_sizes(traffic, 0)
    assert len(zero) == c and sum(s for _, _, s, _ in zero) == c // 2
    for plen, olen, _, done in zero:
        assert 0 <= done < olen and plen + olen <= 1024
    later = [o for k in range(1, 41)
             for _, o, _, _ in closed_chat.round_sizes(traffic, k)]
    mean = sum(later) / len(later)
    biased = sum(o * o for o in later) / sum(later)
    got = sum(o for _, o, _, _ in zero) / c
    assert abs(got - biased) < abs(got - mean)
    cl = closed_chat.Clients(traffic, 3, 151936)
    for i in range(c):
        plen, olen, _, done = zero[cl.deal[i]]
        r = cl.spec(i, 0)
        assert (len(r.prompt), r.max_new) == (plen + done, olen - done)


def test_train_batches_same_seed_and_document_ends():
    _, traffic = train_inputs()
    a = train_batches.batches(traffic, 128, 5, "cpu")
    b = train_batches.batches(traffic, 128, 5, "cpu")
    c = train_batches.batches(traffic, 128, 6, "cpu")
    assert a.shape == (8, 4, 64) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    flat = a.view(-1).numpy()
    ends = np.flatnonzero(flat == 0)
    gaps = np.diff(ends)
    assert len(ends) > 10 and gaps.min() >= 2 and gaps.max() <= 64
    assert ((flat >= 0) & (flat < 128)).all()
    assert len({bytes(x.numpy()) for x in a.view(-1, 64)}) == 32


# -- the interval union and gap names -----------------------------------------

def test_union_merges_overlaps_and_counts_busy_once():
    runs, busy = trace._union([(0, 10), (5, 12), (12, 13), (20, 25),
                               (21, 22)])
    assert runs == [[0, 13], [20, 25]] and busy == 18


def test_host_op_is_the_latest_covering_op():
    cpu = [("outer", 0, 100), ("a", 10, 20), ("inner", 30, 60),
           ("b", 70, 80)]
    starts = [s for _, s, _ in cpu]
    assert trace._host_op(cpu, starts, 45) == "inner"
    assert trace._host_op(cpu, starts, 65) == "outer"
    assert trace._host_op(cpu, starts, 150) == "host, outside any op"


def test_reduce_of_a_cpu_profile_has_matmuls_and_no_device_time():
    prof = trace.Profiler(torch.device("cpu"), shapes=True)
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    prof.start()
    a @ b
    torch.addmm(torch.zeros(4), a, b)
    torch.bmm(a[None].bfloat16(), b[None].bfloat16())
    prof.stop()
    sl = prof.reduce()
    assert sl.busy_s is None and sl.window_s > 0
    names = [m[0] for m in sl.matmuls]
    assert names == ["aten::mm", "aten::addmm", "aten::bmm"]
    assert sl.matmuls[2][2][:2] == ["c10::BFloat16", "c10::BFloat16"]


# -- the matmul roofline and the FLOP count -----------------------------------

def test_matmul_cost_of_each_op():
    mm = flops.matmul_cost("aten::mm", [[64, 128], [128, 32]],
                           ["c10::BFloat16"] * 2, False)
    assert mm == (2 * 64 * 128 * 32, 2 * (64 * 128 + 128 * 32 + 64 * 32),
                  989e12)
    addmm = flops.matmul_cost("aten::addmm", [[32], [64, 128], [128, 32],
                                              [], []],
                              ["float"] * 3 + ["Scalar"] * 2, False)
    assert addmm == (2 * 64 * 128 * 32,
                     4 * (32 + 64 * 128 + 128 * 32 + 64 * 32), 67e12)
    bmm = flops.matmul_cost("aten::bmm", [[3, 4, 5], [3, 5, 6]],
                            ["float", "float"], True)
    assert bmm == (2 * 3 * 4 * 5 * 6, 4 * (60 + 90 + 72), 495e12)
    assert flops.matmul_cost("aten::mm", [[2, 2], [2, 2]],
                             ["c10::BFloat16", "float"], False) is None
    assert flops.matmul_cost("aten::conv2d", [[2, 2], [2, 2]],
                             ["float", "float"], False) is None


def test_matmul_roofline_is_ideal_over_spent():
    big = ("aten::mm", [[8192, 8192], [8192, 8192]], ["c10::BFloat16"] * 2)
    ideal = 2 * 8192 ** 3 / 989e12
    assert flops.matmul_roofline([big + (2 * ideal,)], False) == \
        pytest.approx(50.0)
    gemv = ("aten::mm", [[1, 4096], [4096, 4096]], ["c10::BFloat16"] * 2)
    nbytes = 2 * (4096 + 4096 ** 2 + 4096)
    assert flops.matmul_roofline([gemv + (nbytes / 3.35e12 * 4,)], False) \
        == pytest.approx(25.0)
    assert flops.matmul_roofline([], False) is None


def test_causal_key_sum_and_forward_flops():
    assert flops.causal_key_sum(3, 7) == sum(p + 1 for p in range(3, 7))
    dims = model.Dims.of(chat_inputs()[0])
    assert flops.forward_flops(dims, 1000, 5, 15) == \
        2 * 1000 * 5 + 4 * dims.layers * dims.heads * dims.hd * 15


def test_train_flops_counts_forward_three_times():
    dims = model.Dims.of(train_inputs()[0])
    body = model.matmul_params(dims) - dims.vocab * dims.d
    S = 64
    fwd = 2 * body * S + 2 * dims.vocab * dims.d * (S - 1) + \
        4 * dims.layers * dims.heads * dims.hd * S * (S + 1) / 2
    assert train_batches.train_flops(dims, 4, S) == pytest.approx(
        3 * 4 * fwd)


def test_matmul_params_leave_out_an_untied_embedding():
    q = model.Dims.of(harness.load_config("qwen1.5-4b"))
    s = model.Dims.of(harness.load_config("smollm-135m"))
    assert model.param_count(q) == 3_950_369_280
    assert model.matmul_params(q) == model.param_count(q) - 151936 * 2560
    assert model.param_count(s) == model.matmul_params(s) == 134_515_008


# -- finding everything by name -----------------------------------------------

def test_benchmark_json_names_files_that_exist_and_agree():
    bj = harness.load_benchmark()
    have = harness.available()
    for cell in bj["workloads"]:
        assert cell["config"] in have["configs"]
        assert cell["traffic"] in have["traffic"]
        assert cell["name"] in have["limits"]
        kind = harness.load_traffic(cell["traffic"])["kind"]
        assert kind in have["kinds"]
    e2e = {m["name"] for m in bj["end_to_end"]}
    for m in bj["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == \
            (m["layer"], m["unit"], m["moves"])
        assert m["moves"] in e2e
    for c in bj["configs"]:
        conf = harness.load_config(c["name"])
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]


def test_new_files_alone_add_a_config_a_mix_and_a_metric(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = harness.available(bench)
    conf = harness.load_config("smollm-135m", bench)
    (bench / "configs" / "dummy-1m.json").write_text(json.dumps(conf))
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"kind": "train_batches", "batch": 1}))
    (bench / "limits" / "dummy-1m.dummy-mix.json").write_text("{}")
    (bench / "metrics" / "dummy_ms.train.py").write_text(
        'LAYER = "device"\nUNIT = "ms"\nMOVES = "train_tokens_per_s"\n\n\n'
        'def read(run):\n    return run.counters.get("dummy")\n')
    after = harness.available(bench)
    assert after["configs"] == sorted(before["configs"] + ["dummy-1m"])
    assert after["traffic"] == sorted(before["traffic"] + ["dummy-mix"])
    assert after["limits"] == sorted(before["limits"] +
                                     ["dummy-1m.dummy-mix"])
    assert after["metrics"] == sorted(before["metrics"] + ["dummy_ms.train"])
    assert harness.load_config("dummy-1m", bench) == conf
    assert harness.load_traffic("dummy-mix", bench)["kind"] == \
        "train_batches"
    metric = harness.load_metric("dummy_ms.train", bench)
    run = harness.Run(cell={"name": "dummy-1m.dummy-mix"}, conf=conf,
                      traffic={}, limits={}, seed=0, seconds=1.0,
                      trace=True, device=torch.device("cpu"), t_process=0.0)
    assert metric.read(run) is None
    run.counters["dummy"] = 2.5
    assert metric.read(run) == 2.5
    bj = harness.load_benchmark()
    bj["workloads"].append({"name": "dummy-1m.dummy-mix", "config":
                            "dummy-1m", "traffic": "dummy-mix", "chips": 1})
    bj["per_layer"].append({"name": "dummy_ms.train", "unit": "ms",
                            "workloads": ["dummy-1m.dummy-mix"]})
    assert harness.metrics_of(bj, run, bench) == \
        {"dummy_ms.train": {"value": 2.5, "unit": "ms"}}


# -- whole small runs ---------------------------------------------------------

def test_chat_run_end_to_end_and_traced():
    bj, run = run_small(CHAT)
    out = harness.result(bj, run)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"ttft_p90_ms", "itl_p95_ms",
                                   "serve_tokens_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["checks"]["max_logit_gap"]["limit"] == \
        harness.load_limits(CHAT)["max_logit_gap"]
    assert run.counters["requests_sent"] == run.attempted >= 4
    assert run.counters["tokens_generated"] > 0
    bj, run = run_small(CHAT, trace=True)
    out = harness.result(bj, run)
    # a CPU run has no device numbers: those metrics leave themselves out
    assert set(out["metrics"]) == {"tick_ms.chat", "prefill_ms.chat",
                                   "decode_ms.chat", "prefix_hit_share.chat"}
    assert run.slice.units > 0 and run.slice.matmuls
    assert out["metrics"]["prefix_hit_share.chat"]["value"] > 0


def test_train_run_end_to_end():
    bj, run = run_small(TRAIN)
    out = harness.result(bj, run)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    # the loss gap is read (run.info) but not compared: neither
    # the control nor a fault reads three times its sound runs' (PERF.md)
    assert set(out["checks"]) == {"grad_gap", "change_gap", "grad_diff"}
    assert set(run.info["readings"]) == {"loss_gap", "grad_gap",
                                         "change_gap", "grad_diff"}
    assert run.attempted == run.counters["steps"] > 0


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types
    assert "repro_torch" not in harness.FORBIDDEN_MODULES
    monkeypatch.setitem(sys.modules, "repro_torch_extra", types.ModuleType(
        "repro_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro.models", types.ModuleType("x"))
    assert harness.forbidden_loaded() == ["jax.numpy", "repro.models"]


# -- faults that must turn ``correct`` false ----------------------------------

def _altered_token(monkeypatch):
    from repro_torch.models.api import ModelAPI
    real = ModelAPI.decode_step

    def step(self, *a, **kw):
        logits, state = real(self, *a, **kw)
        return logits.roll(1, dims=-1), state
    monkeypatch.setattr(ModelAPI, "decode_step", step)


def _state_unchanged(monkeypatch):
    from repro_torch.models.api import ModelAPI
    real = ModelAPI.decode_step

    def step(self, params, state, *a, **kw):
        kept = {k: {n: t.clone() for n, t in e["kv"].items()}
                for k, e in state["blocks"].items()}
        logits, state = real(self, params, state, *a, **kw)
        for k, e in state["blocks"].items():
            for n, t in e["kv"].items():
                t.copy_(kept[k][n])
        return logits, state
    monkeypatch.setattr(ModelAPI, "decode_step", step)


def _half_batch(monkeypatch):
    """Every other slot left out of the decode step (no cache write),
    its logits the mean over the slots that ran."""

    from repro_torch.models.api import ModelAPI
    real = ModelAPI.decode_step

    def step(self, *a, active=None, **kw):
        active = active.clone()
        active[1::2] = False
        logits, state = real(self, *a, active=active, **kw)
        logits = logits.clone()
        logits[1::2] = logits[0::2].mean(0)
        return logits, state
    monkeypatch.setattr(ModelAPI, "decode_step", step)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch])
def test_chat_faults_turn_correct_false(monkeypatch, fault):
    fault(monkeypatch)
    bj, run = run_small(CHAT, seconds=2.0)
    assert harness.result(bj, run)["correct"] is False
    value, limit = run.checks["max_logit_gap"]
    assert value > limit


def _train_unchanged(monkeypatch):
    import repro_torch.runtime.train as tr
    real = tr.build_train_step

    def build(api, tcfg):
        step = real(api, tcfg)

        def same(state, batch):
            return state, step(state, batch)[1]
        return same
    monkeypatch.setattr(tr, "build_train_step", build)


def _train_half_batch(monkeypatch):
    import repro_torch.runtime.train as tr
    real = tr.build_train_step

    def build(api, tcfg):
        step = real(api, tcfg)

        def half(state, batch):
            B = batch["tokens"].shape[0]
            return step(state, {k: v[:B // 2] for k, v in batch.items()})
        return half
    monkeypatch.setattr(tr, "build_train_step", build)


@pytest.mark.parametrize("fault", [_train_unchanged, _train_half_batch])
def test_train_faults_turn_correct_false(monkeypatch, fault):
    fault(monkeypatch)
    bj, run = run_small(TRAIN)
    out = harness.result(bj, run)
    assert out["correct"] is False
    assert any(v > lim for v, lim in run.checks.values())


# -- the control --------------------------------------------------------------

def test_chat_control_reads_far_above_the_program():
    """The fp8 reference in the program's place reads several times the
    program's widest gap at a small size too, and is what the run judges
    (the chip's readings at the cell's size set the limit; PERF.md)."""

    bj, run = run_small(CHAT, control=True, layers=4, seconds=2.0)
    prog = run.info["program_gap"]
    ctl, limit = run.checks["max_logit_gap"]
    assert ctl > max(3 * prog, 1e-3)
    assert limit == harness.load_limits(CHAT)["max_logit_gap"]
    # a limit between the two readings: the program would pass it, the
    # run judged with the control does not
    run.checks["max_logit_gap"] = (ctl, (prog + ctl) / 2)
    assert harness.result(bj, run)["correct"] is False


def test_train_control_runs_are_judged_under_the_cells_limits(monkeypatch):
    """``control.train`` judges each planted run as the kind judges a
    run: a reading over its limit turns that run's ``correct`` false."""

    from bench import control
    from bench.reference import train as reference

    conf, traffic = train_inputs("float32")
    monkeypatch.setattr(harness, "load_config", lambda name, *a: conf)
    monkeypatch.setattr(harness, "load_traffic", lambda name, *a: traffic)
    real = reference.train_steps

    def train_steps(weights, dims, data, knobs, **kw):
        return real(weights, dims, data, knobs, rows_per_block=2, **kw)
    monkeypatch.setattr(reference, "train_steps", train_steps)
    out = control.train(harness.load_benchmark(), TRAIN, 5,
                        torch.device("cpu"))
    limits = harness.load_limits(TRAIN)
    for name in ("control", "half_batch", "unchanged"):
        over = any(out[name][k] > limits[k] for k in limits)
        assert out[name]["correct"] is (not over)
    assert out["unchanged"]["correct"] is False
    assert out["half_batch"]["correct"] is False


@pytest.mark.gpu
def test_chat_control_fails_its_limit_on_the_card(cuda_device):
    from bench import control

    bj = harness.load_benchmark()
    out = control.chat(bj, CHAT, 2 ** 31 + 101, bj["run_seconds"],
                       cuda_device)
    assert out["correct"] is False
    assert out["control"]["max_logit_gap"] > out["limit"]
    assert out["program"]["max_logit_gap"] <= out["limit"]


@pytest.mark.gpu
def test_train_control_fails_a_limit_on_the_card(cuda_device):
    from bench import control

    bj = harness.load_benchmark()
    out = control.train(bj, TRAIN, 2 ** 31 + 103, cuda_device)
    assert out["control"]["correct"] is False
    assert out["half_batch"]["correct"] is False
    assert out["unchanged"]["correct"] is False
    assert math.isfinite(out["reference_losses"][0])
