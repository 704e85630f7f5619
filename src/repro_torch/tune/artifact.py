"""Provenance of tuning artifacts (the port's copy of the first part of
``repro.tune.artifact``).

:func:`provenance_meta` says who, where, when and with what a document
was built; :func:`repro_torch.obs.trace.export_trace` stamps it into
every trace.  :func:`platform_key` is the stable string key of a
platform fingerprint (:func:`repro_torch.tune.cache.platform_fingerprint`).
Exporting and merging cache bundles is not ported yet (ROADMAP queue 1,
item 8).
"""

from __future__ import annotations

import platform as _platform
import time
from typing import Any, Mapping


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


__all__ = ["provenance_meta", "platform_key"]
