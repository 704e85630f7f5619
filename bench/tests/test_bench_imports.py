"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program: each checked in a fresh
interpreter, by the whole top-level name of every loaded module
(``repro_torch`` is not ``repro``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_HARNESS = """
import json, sys, time
import torch
from bench import control, flops, harness, model, run, stats, trace
import bench.reference.decoder, bench.reference.train
sys.path.insert(0, "bench/tests")
from _small import CHAT, TRAIN, run_small
have = harness.available()
for kind in have["kinds"]:
    harness.load_kind(kind)
for metric in have["metrics"]:
    harness.load_metric(metric)
bj, r = run_small(CHAT, seconds=0.5, trace=True)
harness.result(bj, r)
bj, r = run_small(TRAIN, seconds=0.5, trace=True)
harness.result(bj, r)
print(json.dumps(sorted(sys.modules)))
"""

_REFERENCE = """
import json, sys
import bench.reference.decoder, bench.reference.train
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(code: str) -> set[str]:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {m.split(".", 1)[0] for m in json.loads(
        out.stdout.strip().splitlines()[-1])}


def test_harness_and_a_run_of_each_kind_load_no_jax():
    tops = _loaded(_HARNESS)
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    tops = _loaded(_REFERENCE)
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
