"""The examples' torch twins (``examples/torch_*.py``) against the
reference examples, on the CPU.

Each reference example runs once as a subprocess (``JAX_PLATFORMS=cpu``,
its tuning cache and platform spec under ``tmp_path``), two at a time in
the background, while each twin runs in-process through its ``main``
with ``--device cpu`` where it takes the flag.  Then each twin's
deterministic output is held to its reference's: the model checker's
counts, times, picks and trail; the abstract platform's pick and the
swarm check; the reduction's pick against the port's own cost model and
its result against numpy; the fleet's job, shipping and node counts; the
serving driver's requests, tokens, ticks, prompts and paged line; the
training driver's steps, restart and tuned pick.  ``tune_distributed``'s
twin and reference run in-process under one spec installed into both
packages and the reference's device memory: the same picks, modeled
times and printed lines.  The kernel tunables search
each package's own launch lattice (the card's, the TPU's), so there only
the port's own model is the reference.
"""

import contextlib
import functools
import importlib.util
import io
import os
import re
import runpy
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import calibrate as jax_calibrate  # noqa: E402
from repro import tune as jax_tune  # noqa: E402
from repro.core import tpu_machine as J  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tpu_machine import (TPUWorkload,  # noqa: E402
                                          tune_distributed)
from repro_torch.kernels.tuned_reduction.ops import (cost_model,  # noqa: E402
                                                     tuning_space)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC, EXAMPLES = ROOT / "src", ROOT / "examples"
CPU = ["--device", "cpu"]
# the twins run here, each with the arguments it takes
TWINS = {"quickstart": [], "autotune_minimum": CPU, "fleet_rollout": CPU,
         "serve_batch": CPU, "train_smollm": CPU}
REFERENCES = tuple(TWINS)
# one set of platform constants for both packages' machine models
SPEC = {"peak_flops": 500e12, "hbm_bw": 2.0e12, "link_bw": 40e9,
        "links": 4, "dci_bw": 20e9, "dispatch_us": 10.0}
REL = 1e-9


def twin(name: str):
    path = EXAMPLES / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference(name: str, tmp: Path) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               REPRO_TUNE_CACHE=str(tmp / f"{name}.jax_cache.json"),
               REPRO_PLATFORM_SPEC=str(tmp / f"{name}.jax_spec.json"))
    proc = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py")],
                          env=env, cwd=tmp, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _run_twin(name: str, tmp: Path) -> str:
    """``main(argv)`` of the twin with stdout captured, on its own cache
    and spec path; the process-wide cache and spec restored after."""

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp / f"{name}.cache.json"))
        mp.setenv("REPRO_TORCH_PLATFORM_SPEC", str(tmp / f"{name}.spec.json"))
        prev_cache = set_default_cache(None)
        prev_spec = calibrate.set_platform_spec(None)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                twin(name).main(TWINS[name])
        finally:
            set_default_cache(prev_cache)
            calibrate.set_platform_spec(prev_spec)
    return buf.getvalue()


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """{name: (reference stdout, twin stdout)}."""

    tmp = tmp_path_factory.mktemp("examples")
    with ThreadPoolExecutor(2) as pool:
        refs = {n: pool.submit(_reference, n, tmp) for n in REFERENCES}
        twins = {n: _run_twin(n, tmp) for n in TWINS}
        return {n: (refs[n].result(), twins[n]) for n in TWINS}


def _untimed(text: str) -> list[str]:
    """The lines with wall-clock times blanked."""

    text = re.sub(r"\(\d+\.\d+s\)|\[\d+\.\d+s\]", "(s)", text)
    text = re.sub(r"\(\d+\.\d+ ms for the whole plan\)", "(ms)", text)
    return text.splitlines()


def _line(text: str, prefix: str) -> str:
    (line,) = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    return line


def test_quickstart(outputs):
    ref, got = outputs["quickstart"]
    assert _untimed(got) == _untimed(ref)
    assert "terminates at time 69 (explored 98 states)" in got
    for engine, cfg in (("explorer", "{'WG': 16, 'TS': 4}"),
                        ("swarm", "{'WG': 16, 'TS': 4}"),
                        ("sweep", "{'WG': 4, 'TS': 4}")):
        assert f"engine={engine:9s} T_min=  24 config={cfg}" in got
    assert "(trail of 131 transitions replays OK)" in got
    assert "(hit, stats={'hits': 1, 'misses': 1, 'entries': 1})" in got


def test_autotune_minimum(outputs):
    ref, got = outputs["autotune_minimum"]
    for prefix in ("[1/2] abstract-platform: tuned (sweep) t_min=131224 "
                   "config={'WG': 128, 'TS': 8192}",
                   "abstract platform: optimal WG=128 TS=8192 "
                   "model_time=131224",
                   "swarm sanity (size=64): swarm t=276 vs exhaustive "
                   "t=276"):
        assert _line(got, prefix[:20]).startswith(prefix)
        assert _line(ref, prefix[:20]).startswith(prefix)
    # the port's pick: the argmin of its own cost model over its lattice
    m = re.search(r"^reduction kernel: WG=(\d+) TS=(\d+) modeled ([\d.]+) "
                  r"us  \((\d+) configs, cache miss\)$", got, re.M)
    assert m is not None, got
    n = 1 << 20
    costs = [cost_model(c, n=n) for c in tuning_space(n)]
    pick = {"WG": int(m.group(1)), "TS": int(m.group(2))}
    assert cost_model(pick, n=n) == min(costs)
    assert int(m.group(4)) == len(costs)
    # the kernel's result is the data's minimum, and the reference's
    x = np.random.default_rng(0).integers(-2**31, 2**31 - 1, n,
                                          dtype=np.int64).astype(np.int32)
    want = int(x.min())
    assert f"tuned kernel result {want} == plain {want}  ✓ (WG=" \
        f"{pick['WG']} TS={pick['TS']} from cache)" in got
    assert f"tuned kernel result {want} == oracle {want}" in ref


def test_fleet_rollout(outputs):
    ref, got = outputs["fleet_rollout"]
    for text in (ref, got):
        lines = text.splitlines()
        assert lines[0].startswith("[calibrate] probed cpu/cpu hash=")
        # one progress line a job (the pool's threads may print two
        # lines run together)
        assert sorted(map(int, re.findall(r"\[(\d+)/12\] ", text))) == \
            list(range(1, 13))
        assert "[1/12] paper.minimum-16: tuned (sweep) t_min=24 config=" \
            "{'WG': 4, 'TS': 4}" in text
        assert "plan 'fleet-warmup-smoke': 12 jobs — 0 hits, 12 tuned, " \
            "0 forced, 0 failed" in text
        assert "shipped 12 entries; node merged 12 added / 0 kept" in text
        assert "from cache with 0 engine runs (result[0,0]=128.0)" in text
        assert text.rstrip().endswith(
            "re-warmup on node: plan 'fleet-warmup-smoke': 12 jobs — 12 "
            "hits, 0 tuned, 0 forced, 0 failed")
    # the node resolves the config the warm-up picked for that job
    warm = re.search(r"kernels\.matmul_tuned: tuned \(grid\) t_min=[\d.e+-]+ "
                     r"config=(\{.*\}) \[", got).group(1)
    node = re.search(r"matmul_tuned resolved (\{.*\}) from cache", got)
    assert eval(node.group(1)) == eval(warm)
    assert "from repro_torch 1.0.0 on" in got


def test_serve_batch(outputs):
    ref, got = outputs["serve_batch"]
    served = "served 10 requests / 60 tokens in 18 engine ticks"
    for text in (ref, got):
        assert [ln.startswith(served) for ln in text.splitlines()
                if ln.startswith("served")] == [True, True]
    assert _line(got, "  paged kv:") == _line(ref, "  paged kv:") == \
        "  paged kv: page=8 pool=32 pages peak_used=8 peak_active=4 " \
        "deferrals=0"

    def prompts(text):
        return re.findall(r"^  (req\d+: prompt=\[[\d, ]+\])\.\.\.", text,
                          re.M)

    assert prompts(got) == prompts(ref) and len(prompts(ref)) == 6


def test_train_smollm(outputs):
    ref, got = outputs["train_smollm"]
    pats = [r"^\[tune\] config: microbatches=(\d+) remat=(\w+) "
            r"fsdp=(\w+) modeled step=[\d.]+ ms \(engine=grid, cache "
            r"tuned\)$",
            r"^\[inject\] simulated pod failure at step 120$",
            r"^steps=220 wall=[\d.]+s mean_step=[\d.]+ms restarts=1 "
            r"stragglers=\d+$",
            r"^loss: first=[\d.]+ last=[\d.]+ min=[\d.]+$"]
    for text in (got, ref):
        for pat in pats:
            assert re.search(pat, text, re.M), (pat, text)
    # the pick is the port's machine model's for one device of the data
    # sheet's memory (the reference prices one v5e chip)
    cfg = get_config("smollm-135m").reduced()
    api = build_model(cfg)
    w = TPUWorkload(params=api.param_count(), active_params=api.param_count(),
                    layers=cfg.n_layers, d_model=cfg.d_model, seq=64,
                    global_batch=16, vocab=cfg.vocab)
    best, _, _ = tune_distributed(w, chips_per_pod=1)
    got_pick = re.search(pats[0], got, re.M).groups()
    assert got_pick == (str(best.microbatches), best.remat, str(best.fsdp))
    first, last = map(float, re.search(r"^loss: first=([\d.]+) last=([\d.]+)",
                                       got, re.M).groups())
    assert last < first


@pytest.fixture
def shared_spec(tmp_path):
    jprev = jax_calibrate.set_platform_spec(jax_calibrate.PlatformSpec(
        **SPEC))
    prev = calibrate.set_platform_spec(calibrate.PlatformSpec(**SPEC))
    jcache = jax_tune.set_default_cache(jax_tune.TuningCache(
        tmp_path / "jax.json"))
    cache = set_default_cache(TuningCache(tmp_path / "port.json"))
    yield
    jax_calibrate.set_platform_spec(jprev)
    calibrate.set_platform_spec(prev)
    jax_tune.set_default_cache(jcache)
    set_default_cache(cache)


def test_tune_distributed_under_one_spec(shared_spec, capsys):
    # and one device memory: the reference's default (the port's is the
    # H100's 80 GB)
    module = twin("tune_distributed")
    hbm = J.DistributedTunable.__dataclass_fields__["hbm_bytes"].default
    module.DistributedTunable = functools.partial(module.DistributedTunable,
                                                  hbm_bytes=hbm)
    cells = module.main([])
    got = capsys.readouterr().out
    ns = runpy.run_path(str(EXAMPLES / "tune_distributed.py"))
    want = capsys.readouterr().out
    assert got == want
    assert "3 jobs — 0 hits, 3 tuned, 0 forced, 0 failed" in got
    ref_cells = []
    for (arch, pods, tb), job in zip(ns["tunables"], ns["report"].results):
        best = tb.to_config(job.best_config)
        base = ns["step_time"](tb.workload, ns["TPUConfig"](dp=16, tp=16,
                                                            pods=pods))
        ref_cells.append((arch, pods, best, tb.decomposition(best), base))
    assert len(cells) == len(ref_cells) == 3
    for cell, (arch, pods, best, t, base) in zip(cells, ref_cells):
        assert (cell["arch"], cell["pods"]) == (arch, pods)
        c = cell["config"]
        assert (c.tp, c.dp, c.microbatches, c.remat, c.fsdp,
                c.compress_pod_grads) == (best.tp, best.dp, best.microbatches,
                                          best.remat, best.fsdp,
                                          best.compress_pod_grads)
        for key in ("total", "compute", "memory", "exposed_collective"):
            assert cell["modeled"][key] == pytest.approx(t[key], rel=REL)
        assert cell["baseline"]["total"] == pytest.approx(base["total"],
                                                          rel=REL)


@pytest.mark.parametrize("name", ["autotune_minimum", "fleet_rollout",
                                  "serve_batch", "train_smollm"])
def test_twins_without_a_card_raise(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin(name).main([])
