"""Modeled-vs-measured trajectory: is the cost model still honest? (the
port's copy of ``repro.calibrate.trajectory``)

"Tuning the Tuner" argues the tuner's own search quality must be
measured over time, not assumed.  The measure engine already produces
the raw material on every run: the *modeled pick* (the cost model's
argmin) and the *measured pick* (the wall-clock winner), each with its
measured time.  This module distills that into one scalar per tunable —

    gap = modeled_pick.measured / measured_pick.measured  (>= 1.0)

the factor of real time the cost model's pick leaves on the table
(1.0 = the model agreed with the hardware) — and appends a run record
to ``BENCH_calibration_torch.json`` (its own file and ``kind``: the
reference's trajectory is never read or written), an append-over-runs
artifact.
A drifting gap means either the cost model or the kernels regressed;
the trajectory makes that visible before it silently mistunes a fleet.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Mapping, Sequence

from .spec import CalibrationError, get_platform_spec

TRAJECTORY_KIND = "repro_torch.calibrate/trajectory"
TRAJECTORY_SCHEMA = 1
TRAJECTORY_PATH = "BENCH_calibration_torch.json"


def gap_from_stats(stats: Mapping[str, Any]) -> dict[str, Any]:
    """One trajectory record from a measure-engine ``stats`` dict
    (needs ``modeled_pick`` and ``measured_pick``)."""

    try:
        modeled = stats["modeled_pick"]
        measured = stats["measured_pick"]
    except KeyError:
        raise CalibrationError(
            "stats have no modeled_pick/measured_pick — the trajectory "
            "needs a measure-engine result") from None
    best_us = float(measured["measured"])
    model_us = float(modeled["measured"])
    return {
        "modeled_config": dict(modeled["config"]),
        "measured_config": dict(measured["config"]),
        "modeled_pick_measured_us": model_us,
        "best_measured_us": best_us,
        "gap": model_us / best_us if best_us > 0 else 1.0,
        "agree": dict(modeled["config"]) == dict(measured["config"]),
        "candidates": len(stats.get("candidates", ())),
    }


def measure_gap(tunable, *, top_k: int = 4, repeats: int = 3,
                label: str | None = None) -> dict[str, Any]:
    """Run the measure engine on ``tunable`` (uncached — the trajectory
    wants today's hardware, not last week's entry) and distill the gap.
    ``label`` overrides the record's ``tunable`` name (two shapes of the
    same tunable need distinct trajectory rows)."""

    from ..tune.engines import get_engine
    result = get_engine("measure").run(tunable, top_k=top_k,
                                       repeats=repeats)
    rec = gap_from_stats(result.stats)
    rec["tunable"] = label or getattr(tunable, "name",
                                      type(tunable).__name__)
    return rec


def load_trajectory(path: str | os.PathLike = TRAJECTORY_PATH
                    ) -> dict[str, Any]:
    """The on-disk trajectory doc; a fresh empty one when the file is
    missing or unparseable, :class:`CalibrationError` when the file is
    some OTHER artifact (never silently clobber foreign data)."""

    p = Path(path).expanduser()
    try:
        doc = json.loads(p.read_text())
    except (OSError, ValueError):
        return {"kind": TRAJECTORY_KIND, "schema": TRAJECTORY_SCHEMA,
                "runs": []}
    if not isinstance(doc, Mapping) or doc.get("kind") != TRAJECTORY_KIND:
        raise CalibrationError(
            f"{p} exists but is not a calibration trajectory "
            f"(kind={doc.get('kind') if isinstance(doc, Mapping) else '?'!r})")
    if doc.get("schema") != TRAJECTORY_SCHEMA:
        raise CalibrationError(
            f"stale trajectory schema {doc.get('schema')!r} in {p} "
            f"(current {TRAJECTORY_SCHEMA})")
    out = dict(doc)
    out["runs"] = list(doc.get("runs", ()))
    return out


def append_run(records: Sequence[Mapping[str, Any]], *,
               path: str | os.PathLike = TRAJECTORY_PATH,
               extra: Mapping[str, Any] | None = None) -> dict[str, Any]:
    """Append one run (a list of per-tunable gap records) to the
    trajectory artifact at ``path`` (atomic replace); returns the run
    doc that was written."""

    from ..tune.artifact import provenance_meta
    spec = get_platform_spec()
    meta = provenance_meta()
    run = {
        "meta": meta,
        # created_utc predates the shared provenance block; kept as a
        # top-level key (same value) for existing trajectory readers
        "created_utc": meta["created_utc"],
        "platform": {"backend": spec.backend,
                     "device_kind": spec.device_kind},
        "source": spec.source,
        "calibration": spec.calibration_hash(),
        "tunables": [dict(r) for r in records],
    }
    if extra:
        run.update(dict(extra))
    doc = load_trajectory(path)
    doc["runs"].append(run)

    p = Path(path).expanduser()
    if p.parent != Path("."):
        p.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(p.parent) or ".",
                               prefix=p.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return run


def run_trajectory(tunables: Sequence[Any], *,
                   path: str | os.PathLike = TRAJECTORY_PATH,
                   top_k: int = 4, repeats: int = 3,
                   extra: Mapping[str, Any] | None = None
                   ) -> dict[str, Any]:
    """Measure the modeled-vs-measured gap for every tunable and append
    the run to the trajectory artifact; items are Tunables or
    ``(label, tunable)`` pairs.  Returns the run doc."""

    records = []
    for item in tunables:
        label, tb = item if isinstance(item, tuple) else (None, item)
        records.append(measure_gap(tb, top_k=top_k, repeats=repeats,
                                   label=label))
    return append_run(records, path=path, extra=extra)


__all__ = ["TRAJECTORY_KIND", "TRAJECTORY_SCHEMA", "TRAJECTORY_PATH",
           "gap_from_stats", "measure_gap", "load_trajectory",
           "append_run", "run_trajectory"]
