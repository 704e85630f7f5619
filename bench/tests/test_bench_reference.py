"""The plain reference against the program at small sizes on the CPU, in
float32: the paged serving steps' logits, the Server's served tokens
with paging and prefix sharing, and the training step's loss, first
gradient and parameters."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import model
from bench.kinds import closed_chat, train_batches
from bench.reference import decoder
from bench.reference.train import cosine_lr, train_steps

from _small import chat_inputs, train_inputs


def _program(conf, seed=3):
    from repro_torch.models.api import build_model

    dims = model.Dims.of(conf)
    api = build_model(model.program_config(conf, dims))
    weights = model.make_weights(dims, seed, torch.float32, "cpu")
    model.check_layout(api, weights)
    return dims, api, weights


def _ref_logits(weights, dims, seq):
    with decoder.exact_f32():
        (h,) = decoder.hidden(weights, dims, [torch.tensor(seq)])
        return h @ decoder.unembedding(weights, dims)


def test_paged_prefill_and_decode_logits_match_reference():
    from repro_torch.runtime.kv import PagedKVSpec

    conf, _ = chat_inputs("float32")
    dims, api, weights = _program(conf)
    params = model.program_tree(weights)
    spec = PagedKVSpec(n_pages=16, page_size=8, pages_per_slot=8)
    state = api.init_decode_state(2, 64, spec, dtype=torch.float32,
                                  device="cpu")
    table = torch.full((2, 8), -1, dtype=torch.int32)
    table[0, :4] = torch.tensor([5, 2, 9, 14])
    table[1, :5] = torch.tensor([7, 0, 3, 11, 1])
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, dims.vocab, 13).tolist(),
            rng.integers(1, dims.vocab, 20).tolist()]
    pos = [0, 0]
    T = 8
    got = [[], []]
    while any(p < len(s) for p, s in zip(pos, seqs)):
        tok = torch.zeros(2, T, dtype=torch.int32)
        n = [min(T, len(s) - p) for p, s in zip(pos, seqs)]
        for b in range(2):
            tok[b, :n[b]] = torch.tensor(seqs[b][pos[b]:pos[b] + n[b]])
        logits, state = api.prefill_step(params, state, tok,
                                         torch.tensor(pos),
                                         torch.tensor(n), table)
        for b in range(2):
            pos[b] += n[b]
            if n[b] and pos[b] == len(seqs[b]):
                got[b].append((pos[b] - 1, logits[b]))
    for _ in range(4):
        nxt = [int(g[-1][1].argmax()) for g in got]
        for b in range(2):
            seqs[b].append(nxt[b])
        logits, state = api.decode_step(
            params, state, torch.tensor(nxt, dtype=torch.int32)[:, None],
            torch.tensor(pos), table, active=torch.ones(2, dtype=torch.bool))
        for b in range(2):
            got[b].append((pos[b], logits[b]))
            pos[b] += 1
    for b in range(2):
        ref = _ref_logits(weights, dims, seqs[b])
        for p, lg in got[b]:
            torch.testing.assert_close(lg, ref[p], rtol=1e-4, atol=1e-4)


def test_server_tokens_with_paging_and_sharing_are_the_references():
    from repro_torch.runtime.serve import Server

    conf, traffic = chat_inputs("float32", layers=3)
    dims, api, weights = _program(conf)
    s = conf["serve"]
    server = Server(api, model.program_tree(weights), batch=s["slots"],
                    context=s["context"], prefill_chunk=s["prefill_chunk"],
                    paged=True, page_size=s["page_size"],
                    kv_pages=s["kv_pages"], share_prefix=True)
    clients = closed_chat.Clients(traffic, 9, dims.vocab)
    specs = [clients.spec(c, k) for k in range(3)
             for c in range(traffic["clients"])]
    reqs = []
    for spec in specs[:4]:
        reqs.append(server.submit(spec.prompt, spec.max_new))
    for _ in range(3):
        server.tick()
    for spec in specs[4:]:
        reqs.append(server.submit(spec.prompt, spec.max_new))
    server.run_until_drained()
    assert server.shared_tokens > 0
    sample = [closed_chat.Sent(spec, r, 0.0) for spec, r in
              zip(specs, reqs)]
    gap, _ = closed_chat.judge(weights, dims, sample, torch.device("cpu"))
    assert gap <= 1e-4


def test_judge_reads_served_and_control_gaps():
    """A request whose prompt is the first k ids and whose served tokens
    the rest (and one more): the judge's two gaps are the f32
    reference's, at the served tokens and at the fp8 reference's picks."""

    conf, traffic = chat_inputs("bfloat16", layers=3)
    dims = model.Dims.of(conf)
    weights = model.make_weights(dims, 5, torch.bfloat16, "cpu")
    ids = closed_chat.Clients(traffic, 5, dims.vocab).spec(0, 1).prompt
    k = len(ids) - 5
    served = ids[k:] + [7]
    with decoder.exact_f32():
        (h,) = decoder.hidden(weights, dims, [torch.tensor(ids)])
        ref = (h @ decoder.unembedding(weights, dims))[k - 1:]
        (h8,) = decoder.hidden(weights, dims, [torch.tensor(ids)], fp8=True)
        lg8 = (h8 @ decoder.unembedding(weights, dims, fp8=True))[k - 1:]
    best = ref.max(-1).values
    want = float((best - ref.gather(1, torch.tensor(served)[:, None])[:, 0])
                 .max())
    want8 = float((best - ref.gather(1, lg8.argmax(-1)[:, None])[:, 0])
                  .max())

    class Req:
        out = served
    sent = closed_chat.Sent(closed_chat.Spec(ids[:k], len(served), False),
                            Req(), 0.0)
    gap, cgap = closed_chat.judge(weights, dims, [sent],
                                  torch.device("cpu"), control=True)
    assert gap == pytest.approx(want, abs=1e-5) and want > 0
    assert cgap == pytest.approx(want8, abs=1e-5)


def test_fp8_round_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0, -3.0])
    y = decoder.fp8_round(x)
    assert y[3] == 448.0 and y[4] == -3.0 and y[2] == 1.125
    assert y[1] in (1.0, 1.125)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_the_program(steps):
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.train import (TrainConfig, TrainState,
                                           build_train_step)

    conf, traffic = train_inputs("float32")
    knobs = conf["train"]
    dims, api, weights = _program(conf, seed=8)
    data = train_batches.batches(traffic, dims.vocab, 8, "cpu")[:steps]
    step = build_train_step(api, TrainConfig(
        lr=knobs["lr"], warmup=knobs["warmup"],
        total_steps=knobs["total_steps"],
        weight_decay=knobs["weight_decay"], clip_norm=knobs["clip_norm"]))
    params = model.program_tree(weights)
    state = TrainState(params, adamw_init(params), None)
    losses = []
    for i in range(steps):
        state, m = step(state, {"tokens": data[i], "labels": data[i]})
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {k: v / 0.1 for k, v in model.flat_from_tree(
                state.opt.m, list(weights)).items()}
            first = {k: float(torch.linalg.vector_norm(v))
                     for k, v in grads.items()}
    ref = train_steps(weights, dims, data, knobs, rows_per_block=2,
                      keep_first=True)
    assert losses == pytest.approx(ref.losses, rel=1e-5)
    assert first == pytest.approx(ref.first_grad, rel=1e-4)
    for k, g in grads.items():
        torch.testing.assert_close(g, ref.first_grads[k], rtol=1e-3,
                                   atol=1e-6)
    after = model.flat_from_tree(state.params, list(weights))
    change = {k: float(torch.linalg.vector_norm(after[k] - weights[k]))
              for k in weights}
    assert change == pytest.approx(ref.change, rel=1e-3)
    checks = train_batches.compare(losses, first, change, ref, grads)
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap", "grad_diff"}
    assert max(checks.values()) < 1e-3


def test_cosine_lr_is_the_programs_schedule():
    from repro_torch.optim import cosine_schedule

    for warmup in (0, 10):
        sched = cosine_schedule(3e-3, warmup, 1000)
        for step in (1, 5, 10, 11, 500, 1000, 2000):
            assert cosine_lr(step, 3e-3, warmup, 1000) == pytest.approx(
                float(sched(torch.tensor(step))), rel=1e-6)
