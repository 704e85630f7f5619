"""``python -m repro_torch.launch.dryrun`` and ``launch.perf`` on the
CPU: one production cell through the CLI (a fake world of 256 ranks made
for the cell), one ``run_variant`` line appended to a log, and importing
the drivers starts no process group."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def test_dryrun_cli_one_cell(tmp_path):
    out = tmp_path / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--single-pod",
         "--no-blocks", "--out", str(out)], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    [rec] = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["n_devices"] == 256 and "block" not in rec
    assert rec["cost"]["flops"] > 0 and rec["memory"]["peak_hbm_bytes"] > 0
    assert "[16x16] smollm-135m" in proc.stdout
    assert "1 cells, 0 failed" in proc.stdout


def test_perf_run_variant_appends_a_line(tmp_path):
    from repro_torch.launch.perf import run_variant
    log = tmp_path / "results" / "perf_log.jsonl"
    a = run_variant("smollm-135m", "long_500k", "skip", out_path=str(log))
    b = run_variant("smollm-135m", "decode_32k", "base", out_path=str(log))
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines == [a, b]
    assert a["status"] == "skipped" and a["compute_ms"] == 0
    assert b["status"] == "ok", b["reason"]
    assert b["dominant"] in ("compute", "memory", "collective")
    assert b["settings"]["counts"] == "all_trips"
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_importing_the_drivers_starts_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.perf\n"
            "import repro_torch.launch.cells, repro_torch.launch.mesh\n"
            "import repro_torch.distribute.pipeline\n"
            "assert not dist.is_initialized()\n"
            "import sys; assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
