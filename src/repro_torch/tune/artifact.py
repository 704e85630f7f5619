"""Portable tuning-cache artifacts — ship tuned configs to a fleet (the
port's copy of ``repro.tune.artifact``).

An *artifact* is a schema-versioned JSON bundle of
:class:`~repro_torch.tune.TuningCache` entries, grouped by the platform
fingerprint each entry was tuned for
(:func:`repro_torch.tune.cache.platform_fingerprint`: ``cuda`` and the
card's name, or ``cpu``), so one bundle can carry configs for a
heterogeneous fleet and every node hits only the keys that match its own
platform.

Lifecycle: ``warmup`` a cache from a :class:`~repro_torch.tune.plan.TuningPlan`
on one machine (or per platform), :func:`export_artifact` it, ship the
file, :func:`merge_artifact` it into each node's cache.  Merging is
conflict-aware: the default ``prefer_measured`` policy never lets a
cost-model-only entry overwrite a wall-clock-measured one, and between
equals the newer entry wins.

The schema number and the ``kind`` string are the reference's, so a
bundle written by either package loads in the other; its entries keep
their own platform fingerprints, so an entry tuned elsewhere never
answers a lookup on this platform.  :func:`provenance_meta` (also stamped
into every trace by :func:`repro_torch.obs.trace.export_trace`) names
``repro_torch`` as the tool.
"""

from __future__ import annotations

import json
import os
import platform as _platform
import tempfile
import time
from pathlib import Path
from typing import Any, Mapping

ARTIFACT_SCHEMA = 1
ARTIFACT_KIND = "repro.tune/cache-artifact"

MERGE_POLICIES = ("prefer_measured", "prefer_newer", "keep_existing")

_PROVENANCE_RANK = {"modeled": 0, "measured": 1}


class ArtifactError(ValueError):
    """The file is not a usable cache artifact (wrong kind/schema)."""


def provenance_meta() -> dict[str, Any]:
    """Who/where/when/with-what built this document: the host, its
    machine and Python, the tool (``repro_torch <version>``) and the UTC
    creation time."""

    from .. import __version__ as tool_version
    return {
        "host": _platform.node() or "unknown",
        "machine": _platform.machine(),
        "python": _platform.python_version(),
        "tool": f"repro_torch {tool_version}",
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def platform_key(platform: Mapping[str, Any] | None) -> str:
    """Stable string key for a platform fingerprint document."""

    pf = platform or {}
    return f"{pf.get('backend', 'unknown')}/{pf.get('device_kind', 'unknown')}"


def _entry_platform(entry: Mapping[str, Any]) -> dict[str, Any]:
    return dict((entry.get("fingerprint") or {}).get("platform") or {})


def export_artifact(cache, path: str | os.PathLike, *,
                    platform: str | None = None) -> dict[str, Any]:
    """Write ``cache``'s entries as a portable bundle; returns the bundle.

    ``platform`` filters to one platform — either a full key
    (``"cuda/NVIDIA H100 80GB HBM3"``) or just the backend (``"cuda"``,
    ``"cpu"``).  ``None`` exports everything (a heterogeneous-fleet
    bundle).
    """

    platforms: dict[str, dict[str, Any]] = {}
    skipped = 0
    for key, entry in cache.entries.items():
        pf = _entry_platform(entry)
        pk = platform_key(pf)
        if platform is not None and platform not in (pk, pf.get("backend")):
            skipped += 1
            continue
        group = platforms.setdefault(pk, {"platform": pf, "entries": {}})
        group["entries"][key] = entry
    bundle = {
        "kind": ARTIFACT_KIND,
        "schema": ARTIFACT_SCHEMA,
        "created": time.time(),
        "meta": provenance_meta(),
        "source": str(getattr(cache, "path", "")),
        "entry_count": sum(len(g["entries"]) for g in platforms.values()),
        "skipped": skipped,
        "platforms": platforms,
    }
    out = Path(path).expanduser()
    out.parent.mkdir(parents=True, exist_ok=True)
    # atomic replace (as TuningCache.save): a crash mid-export must not
    # leave a truncated bundle to ship fleet-wide
    fd, tmp = tempfile.mkstemp(dir=str(out.parent), prefix=out.name,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(bundle, f, indent=1, sort_keys=True, default=str)
        os.replace(tmp, out)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return bundle


def load_artifact(path: str | os.PathLike) -> dict[str, Any]:
    """Read + validate a bundle; raises :class:`ArtifactError` on a file
    that is not an artifact or carries a different schema version."""

    p = Path(path).expanduser()
    try:
        bundle = json.loads(p.read_text())
    except (OSError, ValueError) as e:
        raise ArtifactError(f"{p}: not readable as a cache artifact ({e})")
    if not isinstance(bundle, dict) or bundle.get("kind") != ARTIFACT_KIND:
        raise ArtifactError(f"{p}: not a {ARTIFACT_KIND} bundle")
    if bundle.get("schema") != ARTIFACT_SCHEMA:
        raise ArtifactError(
            f"{p}: artifact schema {bundle.get('schema')!r} != supported "
            f"{ARTIFACT_SCHEMA}; re-export from a matching version")
    return bundle


def _incoming_wins(mine: Mapping[str, Any], theirs: Mapping[str, Any],
                   policy: str) -> bool:
    if policy == "keep_existing":
        return False
    if policy == "prefer_measured":
        rank = lambda e: _PROVENANCE_RANK.get(e.get("provenance", "modeled"), 0)
        if rank(theirs) != rank(mine):
            return rank(theirs) > rank(mine)
    # prefer_newer, or same provenance under prefer_measured
    return float(theirs.get("created", 0)) > float(mine.get("created", 0))


def merge_artifact(cache, path: str | os.PathLike, *,
                   policy: str = "prefer_measured") -> dict[str, Any]:
    """Merge a bundle into ``cache`` (in memory — call ``cache.save()``
    to persist); returns a report dict.

    Policies: ``prefer_measured`` (default — measured provenance beats
    modeled, ties broken newer-wins), ``prefer_newer`` (timestamp only),
    ``keep_existing`` (only fill holes).

    The bundle's provenance ``meta`` (exporting host, timestamp, tool
    version) comes back in the report and is stamped onto every entry
    the merge takes as ``origin``, so ``ls --json`` can answer "where
    did this config come from" long after the bundle file is gone.
    """

    if policy not in MERGE_POLICIES:
        raise ValueError(f"unknown merge policy {policy!r}; "
                         f"one of {', '.join(MERGE_POLICIES)}")
    bundle = load_artifact(path)
    meta = bundle.get("meta")
    report = {"added": 0, "replaced": 0, "kept": 0,
              "platforms": sorted(bundle.get("platforms", {})),
              "policy": policy, "meta": meta}
    for group in bundle.get("platforms", {}).values():
        for key, entry in group.get("entries", {}).items():
            mine = cache.entries.get(key)
            incoming = dict(entry)
            # relayed bundles (warm -> node A -> re-export -> node B)
            # keep the ORIGINAL tuning host: only stamp entries that
            # don't already carry their provenance
            if meta is not None and "origin" not in incoming:
                incoming["origin"] = meta
            if mine is None:
                cache.put_entry(key, incoming)
                report["added"] += 1
            elif _incoming_wins(mine, entry, policy):
                cache.put_entry(key, incoming)
                report["replaced"] += 1
            else:
                report["kept"] += 1
    return report


__all__ = ["ARTIFACT_SCHEMA", "ARTIFACT_KIND", "MERGE_POLICIES",
           "ArtifactError", "platform_key", "provenance_meta",
           "export_artifact", "load_artifact", "merge_artifact"]
