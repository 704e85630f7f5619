"""The benchmark's harness: finds a cell's configuration, traffic mix,
limits and per-layer metrics by name, runs the mix's kind against the
program, and builds the one result line.

Everything a cell needs is found by name under ``bench/``:

* ``configs/<config>.json``   the configuration, as it is run
* ``traffic/<traffic>.json``  the mix; its ``kind`` names the generator
  and driver ``kinds/<kind>.py``
* ``limits/<cell>.json``      the limit of each number ``correct``
  compares
* ``metrics/<metric>.py``     one per-layer metric: ``LAYER``, ``UNIT``,
  ``MOVES`` and ``read(run)``, which returns a number or None

so a later cell, mix or metric is added as new files and new entries in
``BENCHMARK.json``, without an edit to a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str, bench: Path = BENCH) -> dict:
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


def load_config(name: str, bench: Path = BENCH) -> dict:
    return _json("configs", name, bench)


def load_traffic(name: str, bench: Path = BENCH) -> dict:
    return _json("traffic", name, bench)


def load_limits(cell: str, bench: Path = BENCH) -> dict:
    return _json("limits", cell, bench)


def _module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[label] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str, bench: Path = BENCH) -> ModuleType:
    return _module(bench / "kinds" / f"{kind}.py", f"bench_kind_{kind}")


def load_metric(name: str, bench: Path = BENCH) -> ModuleType:
    mod = _module(bench / "metrics" / f"{name}.py",
                  "bench_metric_" + name.replace(".", "_").replace("-", "_"))
    for attr in ("LAYER", "UNIT", "MOVES", "read"):
        if not hasattr(mod, attr):
            raise AttributeError(f"metric {name} has no {attr}")
    return mod


def available(bench: Path = BENCH) -> dict[str, list[str]]:
    """Every configuration, mix, kind, limits file and metric found under
    ``bench``, by name."""

    def names(sub, suffix):
        d = bench / sub
        return sorted(p.name[:-len(suffix)] for p in d.glob(f"*{suffix}")
                      if p.is_file() and not p.name.startswith("_"))

    return {"configs": names("configs", ".json"),
            "traffic": names("traffic", ".json"),
            "limits": names("limits", ".json"),
            "kinds": names("kinds", ".py"),
            "metrics": names("metrics", ".py")}


def applies(entry: dict, cell: str) -> bool:
    """Is a metric entry reported in ``cell``?"""

    return "workloads" not in entry or cell in entry["workloads"]


@dataclass
class Run:
    """One run of one cell: its inputs, and what its kind measured."""

    cell: dict
    conf: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float                    # perf_counter at process start
    setup_s: float | None = None
    window_s: float | None = None
    e2e: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    slice: Any = None                   # bench.trace.Slice of a traced run
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    info: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return (bool(self.checks) and self.attempted > 0
                and self.failed == 0
                and all(math.isfinite(v) and v <= lim
                        for v, lim in self.checks.values()))


def find_cell(bench_json: dict, name: str) -> dict:
    for cell in bench_json["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench_json['workloads']]}")


def prepare(bench_json: dict, cell_name: str, seed: int, seconds: float,
            trace: bool, device, t_process: float, bench: Path = BENCH,
            conf: dict | None = None, traffic: dict | None = None,
            limits: dict | None = None) -> Run:
    """The run's inputs, by name (tests pass their own small ones)."""

    cell = find_cell(bench_json, cell_name)
    return Run(cell=cell,
               conf=conf if conf is not None
               else load_config(cell["config"], bench),
               traffic=traffic if traffic is not None
               else load_traffic(cell["traffic"], bench),
               limits=limits if limits is not None
               else load_limits(cell_name, bench),
               seed=seed % 2 ** 63, seconds=seconds, trace=trace,
               device=device, t_process=t_process)


def execute(run: Run, bench: Path = BENCH) -> None:
    load_kind(run.traffic["kind"], bench).run(run)


def metrics_of(bench_json: dict, run: Run, bench: Path = BENCH) -> dict:
    """The cell's end-to-end metrics (untraced run) or per-layer ones
    (traced run), each ``{"value", "unit"}``; a per-layer reader that
    finds nothing leaves its metric out."""

    name = run.cell["name"]
    out = {}
    if not run.trace:
        for m in bench_json["end_to_end"]:
            if applies(m, name):
                if m["name"] not in run.e2e:
                    raise KeyError(f"{run.traffic['kind']} measured no "
                                   f"{m['name']}")
                out[m["name"]] = {"value": run.e2e[m["name"]],
                                  "unit": m["unit"]}
        return out
    for m in bench_json["per_layer"]:
        if applies(m, name):
            value = load_metric(m["name"], bench).read(run)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(run: Run) -> dict:
    import torch

    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    if run.trace and run.slice is not None and run.slice.busy_s is not None:
        info["busy_s"] = run.slice.busy_s
        info["window_s"] = run.slice.window_s
    if "power_limit_w" in run.info:
        info["power_limit_w"] = run.info["power_limit_w"]
    return info


def result(bench_json: dict, run: Run, bench: Path = BENCH) -> dict:
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics_of(bench_json, run, bench),
           "device": device_info(run)}
    sl = run.slice
    if run.trace and sl is not None and sl.busy_s is not None:
        out["breakdown"] = {"device_ops": sl.top_ops,
                            "idle_gaps": sl.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (``repro_torch`` is not ``repro``)."""

    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi``, or None."""

    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


__all__ = ["BENCH", "ROOT", "Run", "available", "applies", "device_info",
           "execute", "find_cell", "forbidden_loaded", "load_benchmark",
           "load_config", "load_kind", "load_limits", "load_metric",
           "load_traffic", "metrics_of", "power_limit_w", "prepare",
           "result"]
