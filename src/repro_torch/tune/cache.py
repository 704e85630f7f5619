"""Persistent tuned-configuration cache (the port's copy of
``repro.tune.cache``, with its own store).

:class:`TuningCache` stores ``TuneResult``s on disk keyed by

* the tunable's :meth:`fingerprint` (problem identity + shape),
* the platform (:func:`platform_fingerprint`: the card's name and compute
  capability and the torch version — a configuration tuned on an H100 is
  not one tuned for the plain versions on a CPU),
* the engine name and the engine arguments that change the answer.

The key is the SHA-256 of the canonical JSON of that document.  The store
is one JSON file (atomic replace on write), by default
``~/.cache/repro_torch/tune_cache.json`` or ``$REPRO_TORCH_TUNE_CACHE``.
Writes are deferred: ``put`` only marks the store dirty, and the file is
rewritten on :meth:`save` or at interpreter exit.  Entries carry a
``provenance`` — ``"modeled"`` or ``"measured"`` (the ``measure`` engine).
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Mapping

import torch

from ..core.autotuner import TuneResult

_SCHEMA = 1
_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
_DEFAULT_PATH = "~/.cache/repro_torch/tune_cache.json"


def platform_fingerprint() -> dict[str, str]:
    """The platform a tuned config is valid for: the backend ("cuda"
    when a card is present, else "cpu"), the card's name and compute
    capability, the torch version, and the calibration id (the literal
    ``"default"``: the port's cost models use data-sheet constants)."""

    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        fp = {"backend": "cuda",
              "device_kind": torch.cuda.get_device_name(0),
              "capability": f"{major}.{minor}"}
    else:
        fp = {"backend": "cpu", "device_kind": "cpu", "capability": ""}
    fp["torch"] = torch.__version__
    fp["calibration"] = "default"
    return fp


def tunable_fingerprint(tunable) -> dict[str, Any]:
    """The tunable's own identity; falls back to name + lattice values
    for objects that don't implement ``fingerprint()``."""

    fp = getattr(tunable, "fingerprint", None)
    if callable(fp):
        return dict(fp())
    space = tunable.space()
    return {"tunable": getattr(tunable, "name", type(tunable).__name__),
            "space": {p.name: list(p.values) for p in space.params}}


def cache_key(tunable, engine: str,
              params: Mapping[str, Any] | None = None
              ) -> tuple[str, dict[str, Any]]:
    """(sha256 hex key, the fingerprint document it hashes).

    ``params`` carries engine arguments that change the answer
    (``use_measure``, ``budget``, ``repeats``, ...) so runs with
    different search settings get distinct entries."""

    doc = {"schema": _SCHEMA,
           "tunable": tunable_fingerprint(tunable),
           "platform": platform_fingerprint(),
           "engine": engine}
    if params:
        doc["params"] = dict(params)
    blob = json.dumps(doc, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest(), doc


class TuningCache:
    """On-disk map: cache key -> tuned config + t_min (+ provenance)."""

    def __init__(self, path: str | os.PathLike | None = None):
        if path is None:
            path = os.environ.get(_ENV_VAR, _DEFAULT_PATH)
        self.path = Path(path).expanduser()
        self.hits = 0
        self.misses = 0
        self._entries: dict[str, dict[str, Any]] = {}
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            doc = json.loads(self.path.read_text())
            if doc.get("schema") == _SCHEMA:
                self._entries = dict(doc.get("entries", {}))
        except (OSError, ValueError):
            self._entries = {}

    @property
    def dirty(self) -> bool:
        """True when in-memory entries have not been flushed to disk."""

        return self._dirty

    def _mark_dirty(self) -> None:
        # the strong registration keeps this cache alive until flushed,
        # so deferred puts survive the object going out of scope
        self._dirty = True
        _dirty_caches.add(self)

    def save(self) -> None:
        """Flush pending entries to disk (atomic replace)."""

        self.path.parent.mkdir(parents=True, exist_ok=True)
        doc = {"schema": _SCHEMA, "entries": self._entries}
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True, default=str)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._dirty = False
        _dirty_caches.discard(self)

    def get(self, key: str) -> dict[str, Any] | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        return entry

    def put(self, key: str, result: TuneResult,
            fingerprint: Mapping[str, Any] | None = None) -> None:
        witness = None
        if result.witness is not None:
            w = result.witness
            witness = {"time": w.time, "config": dict(w.config),
                       "trail": list(w.trail), "depth": w.depth}
        # full result provenance minus the bulky grid trace
        stats = {k: v for k, v in result.stats.items() if k != "trace"}
        self._entries[key] = {
            "best_config": dict(result.best_config),
            "t_min": result.t_min,
            "engine": result.engine,
            "oracle_calls": result.oracle_calls,
            "elapsed_s": result.elapsed_s,
            "stats": stats,
            "witness": witness,
            "created": time.time(),
            "provenance": result.stats.get("provenance", "modeled"),
            "fingerprint": dict(fingerprint) if fingerprint else None,
        }
        self._mark_dirty()

    def __contains__(self, key: str) -> bool:
        return key in self._entries


# every dirty cache, flushed at interpreter exit so deferred puts are
# never lost on a normal shutdown; the reference is STRONG on purpose
# (save() releases it)
_dirty_caches: "set[TuningCache]" = set()


@atexit.register
def _flush_dirty_caches() -> None:                     # pragma: no cover
    for cache in list(_dirty_caches):
        if cache.dirty:
            try:
                cache.save()
            except OSError:
                pass


_default_cache: TuningCache | None = None


def default_cache() -> TuningCache:
    """Process-wide cache (path from $REPRO_TORCH_TUNE_CACHE, else
    ``~/.cache/repro_torch/tune_cache.json``), created on first use."""

    global _default_cache
    if _default_cache is None:
        _default_cache = TuningCache()
    return _default_cache


def set_default_cache(cache: TuningCache | None) -> TuningCache | None:
    """Swap the process-wide cache (tests point it at a temp dir);
    returns the previous one."""

    global _default_cache
    prev = _default_cache
    _default_cache = cache
    return prev


__all__ = ["TuningCache", "cache_key", "tunable_fingerprint",
           "platform_fingerprint", "default_cache", "set_default_cache"]
