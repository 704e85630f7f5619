"""Measured platform specification — the constants every cost model
prices against (the port's copy of ``repro.calibrate.spec``).

The paper's premise is model-checking a *faithful* platform model; a
model is only as faithful as its constants.  :class:`PlatformSpec` is
the single source of those constants — peak FLOP/s, memory bandwidth,
interconnect bandwidth, dispatch latency — either the **defaults**
(NVIDIA H100 SXM data-sheet numbers, the ones
:mod:`repro_torch.kernels.common` states for the kernels' bounds) or
**calibrated** values persisted as a schema-versioned JSON artifact.
The probes that fit them are not ported yet (ROADMAP queue 1, item 10).

Not to be confused with :class:`repro_torch.core.platform.PlatformSpec`
(the abstract Promela NP/GMT platform): that one parameterizes the
*process model*, this one carries the *physical device* numbers that the
serving cost models divide by.

Resolution order (:func:`get_platform_spec`):

1. an explicitly installed spec (:func:`set_platform_spec` — tests and
   benches use this),
2. a calibration artifact on disk (``$REPRO_TORCH_PLATFORM_SPEC`` or
   ``~/.cache/repro_torch/platform_spec.json``; the reference's own
   artifact and variable are never read) whose schema is current and
   whose backend/device match the running process,
3. :data:`DEFAULT_SPEC` (the H100 data-sheet constants).

:meth:`PlatformSpec.calibration_hash` is mixed into the tuning-cache
platform fingerprint (:func:`repro_torch.tune.cache.platform_fingerprint`)
so configs tuned under calibrated constants never collide with
default-constant entries.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from dataclasses import asdict, dataclass, field, replace
from pathlib import Path
from typing import Any, Mapping

import torch

from ..kernels.common import BF16_FLOPS, HBM_BYTES_PER_S

SPEC_SCHEMA = 1
SPEC_KIND = "repro_torch.calibrate/platform-spec"
_ENV_VAR = "REPRO_TORCH_PLATFORM_SPEC"
_DEFAULT_PATH = "~/.cache/repro_torch/platform_spec.json"

# the constants that identify a calibration (everything a cost model
# divides by); probe metadata is provenance, not identity
_FITTED_FIELDS = ("peak_flops", "hbm_bw", "link_bw", "links", "dci_bw",
                  "dispatch_us")


class CalibrationError(ValueError):
    """The file is not a usable calibration artifact (wrong kind or a
    stale schema version)."""


def device_fingerprint() -> dict[str, str]:
    """Backend + card of the running process (``"cuda"`` and the card's
    name, or ``"cpu"`` without a card: the same values as
    :func:`repro_torch.tune.cache.platform_fingerprint`'s device part,
    local so calibrate imports nothing of tune)."""

    if torch.cuda.is_available():
        return {"backend": "cuda",
                "device_kind": torch.cuda.get_device_name(0)}
    return {"backend": "cpu", "device_kind": "cpu"}


@dataclass(frozen=True)
class PlatformSpec:
    """Fitted (or default) device constants + probe provenance."""

    peak_flops: float            # FLOP/s per device (bf16 tensor cores)
    hbm_bw: float                # main-memory bytes/s per device
    link_bw: float = 25e9        # bytes/s per NVLink 4 link, each way
    links: int = 18              # NVLink 4 links per H100 SXM
    dci_bw: float = 50e9         # bytes/s to another node, per device
    # a modeling assumption, not a measurement: the host's cost of one
    # dispatch (the probe that fits it is ROADMAP item 10)
    dispatch_us: float = 50.0
    source: str = "default"      # "default" | "calibrated"
    backend: str = ""            # "cuda" or "cpu": where the probes ran
    device_kind: str = ""        # the card's name
    created: float = 0.0         # unix time of the calibration run
    # raw probe sweeps + which constants were actually fitted (an
    # unfittable probe — e.g. the collective probe on one device —
    # leaves its constant at the default and is absent from "fitted")
    probes: Mapping[str, Any] = field(default_factory=dict)
    schema: int = SPEC_SCHEMA

    @property
    def ici_bw(self) -> float:
        """Aggregate interconnect bandwidth (links x per-link)."""

        return self.links * self.link_bw

    @property
    def dispatch_s(self) -> float:
        """Dispatch latency in seconds (cost models work in seconds)."""

        return self.dispatch_us * 1e-6

    def calibration_hash(self) -> str:
        """Short stable id of the fitted constants; the literal string
        ``"default"`` for the uncalibrated spec, so default-constant
        cache fingerprints stay byte-identical across hosts."""

        if self.source == "default":
            return "default"
        doc = {f: getattr(self, f) for f in _FITTED_FIELDS}
        doc["backend"] = self.backend
        doc["device_kind"] = self.device_kind
        blob = json.dumps(doc, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def constants(self) -> dict[str, float]:
        """The fitted constants as a plain dict (CLI/bench reporting)."""

        return {f: getattr(self, f) for f in _FITTED_FIELDS}

    # -- JSON round-trip ----------------------------------------------------

    def to_json(self) -> dict[str, Any]:
        doc = asdict(self)
        doc["probes"] = dict(self.probes)
        doc["kind"] = SPEC_KIND
        return doc

    @classmethod
    def from_json(cls, doc: Mapping[str, Any]) -> "PlatformSpec":
        if doc.get("kind") != SPEC_KIND:
            raise CalibrationError(
                f"not a platform-spec artifact (kind="
                f"{doc.get('kind')!r}, want {SPEC_KIND!r})")
        if doc.get("schema") != SPEC_SCHEMA:
            raise CalibrationError(
                f"stale platform-spec schema {doc.get('schema')!r} "
                f"(current {SPEC_SCHEMA}); calibrate again")
        fields = {k: v for k, v in doc.items() if k != "kind"}
        return cls(**fields)

    def save(self, path: str | os.PathLike) -> Path:
        """Write the spec as a JSON artifact (atomic replace)."""

        path = Path(path).expanduser()
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                                   prefix=path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def matches_device(self) -> bool:
        """Does this calibration describe the running process's device?"""

        dev = device_fingerprint()
        return (self.backend == dev["backend"]
                and self.device_kind == dev["device_kind"])


def load_spec(path: str | os.PathLike) -> PlatformSpec:
    """Load a calibration artifact; :class:`CalibrationError` on a
    foreign file or a stale schema, ``OSError`` when missing."""

    text = Path(path).expanduser().read_text()
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise CalibrationError(f"unparseable platform spec {path}: {e}")
    if not isinstance(doc, Mapping):
        raise CalibrationError(f"platform spec {path} is not a JSON object")
    return PlatformSpec.from_json(doc)


# NVIDIA H100 SXM data sheet (dense rates, 700 W): 989 TFLOP/s bf16 on
# the tensor cores, 3.35 TB/s HBM3, 18 NVLink 4 links at 25 GB/s each
# way; the node-to-node rate is one 400 Gb/s InfiniBand port a GPU, as a
# DGX H100 has (no cost model of the port reads the link fields yet)
DEFAULT_SPEC = PlatformSpec(peak_flops=BF16_FLOPS, hbm_bw=HBM_BYTES_PER_S,
                            link_bw=25e9, links=18, dci_bw=50e9,
                            dispatch_us=50.0, source="default",
                            backend="cuda", device_kind="NVIDIA H100 SXM")


def spec_path(path: str | os.PathLike | None = None) -> Path:
    """The calibration-artifact location: explicit ``path``, else
    ``$REPRO_TORCH_PLATFORM_SPEC``, else
    ``~/.cache/repro_torch/platform_spec.json``."""

    if path is None:
        path = os.environ.get(_ENV_VAR, _DEFAULT_PATH)
    return Path(path).expanduser()


_active_spec: PlatformSpec | None = None
_loaded: tuple[Path, PlatformSpec | None] | None = None


def set_platform_spec(spec: PlatformSpec | None) -> PlatformSpec | None:
    """Install ``spec`` as the process-wide platform spec (``None``
    re-enables disk/default resolution); returns the previous override
    so callers can restore it."""

    global _active_spec, _loaded
    prev = _active_spec
    _active_spec = spec
    _loaded = None                    # force a re-read on next resolve
    return prev


def get_platform_spec() -> PlatformSpec:
    """Resolve the active platform spec (see module docstring for the
    order).  A disk artifact is only honored when its schema is current
    AND it was calibrated on this process's backend/device — a spec
    fitted on one card must not price CPU runs."""

    global _loaded
    if _active_spec is not None:
        return _active_spec
    path = spec_path()
    if _loaded is not None and _loaded[0] == path:
        return _loaded[1] or DEFAULT_SPEC
    resolved: PlatformSpec | None = None
    try:
        spec = load_spec(path)
        if spec.matches_device():
            resolved = spec
    except (OSError, CalibrationError):
        resolved = None
    _loaded = (path, resolved)
    return resolved or DEFAULT_SPEC


def calibration_hash() -> str:
    """The active spec's calibration id (``"default"`` when running on
    defaults) — the value the tuning-cache platform fingerprint mixes
    in."""

    return get_platform_spec().calibration_hash()


def calibrated_replace(spec: PlatformSpec, **fitted: Any) -> PlatformSpec:
    """A copy of ``spec`` with fitted constants applied and the source
    flipped to ``"calibrated"`` (probe helpers build through here)."""

    return replace(spec, source="calibrated", created=time.time(), **fitted)


__all__ = ["PlatformSpec", "CalibrationError", "DEFAULT_SPEC", "SPEC_SCHEMA",
           "SPEC_KIND", "load_spec", "spec_path", "get_platform_spec",
           "set_platform_spec", "calibration_hash", "calibrated_replace",
           "device_fingerprint"]
