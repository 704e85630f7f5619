"""Small configurations and mixes of the two cells' kinds, for CPU runs
of the harness."""

from __future__ import annotations

import time
from unittest import mock

import torch

from bench import harness

CHAT = "qwen1.5-4b.chat-c64"
TRAIN = "smollm-135m.train-2k"


def chat_inputs(dtype: str = "bfloat16", layers: int = 2):
    conf = harness.load_config("qwen1.5-4b")
    conf.update(hidden_size=64, intermediate_size=128,
                num_hidden_layers=layers, num_attention_heads=4,
                num_key_value_heads=4, head_dim=16, vocab_size=256,
                dtype=dtype)
    conf["serve"] = dict(conf["serve"], slots=4, context=128,
                         prefill_chunk=16, kv_pages=32)
    traffic = harness.load_traffic("chat-c64")
    traffic.update(clients=4, check_tokens=10 ** 6, profile_ticks=4,
                   prompt={"median": 24, "sigma": 0.9, "min": 4, "max": 64},
                   output={"median": 8, "sigma": 0.8, "min": 2, "max": 32},
                   system_prompt={"tokens": 16, "share": 0.5,
                                  "min_user_tokens": 4})
    return conf, traffic


def train_inputs(dtype: str = "bfloat16"):
    conf = harness.load_config("smollm-135m")
    conf.update(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                num_attention_heads=3, num_key_value_heads=1, head_dim=16,
                vocab_size=128, dtype=dtype)
    traffic = harness.load_traffic("train-2k")
    traffic.update(batch=4, seq=64, batches=8,
                   documents={"median": 16, "sigma": 1.0, "min": 2,
                              "max": 64, "eod_token": 0})
    return conf, traffic


class StepClock:
    """A host clock that moves ``step`` seconds a reading, so that a small
    run's window holds the same ticks or steps however busy the machine
    is."""

    def __init__(self, step: float = 0.02):
        self.t, self.step = time.perf_counter(), step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def run_small(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
              trace: bool = False, limits: dict | None = None,
              control: bool = False, **kw):
    """A CPU run of ``cell``'s kind at a small size: the harness with its
    look for a card skipped, on a :class:`StepClock`."""

    conf, traffic = (chat_inputs if cell == CHAT else train_inputs)(**kw)
    bench_json = harness.load_benchmark()
    run = harness.prepare(bench_json, cell, seed, seconds, trace,
                          torch.device("cpu"), time.perf_counter(),
                          conf=conf, traffic=traffic, limits=limits)
    run.info["control"] = control
    with mock.patch("time.perf_counter", StepClock()):
        harness.execute(run)
    return bench_json, run
