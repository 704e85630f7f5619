"""Platform calibration: the device constants the cost models price
against (the port's copy of ``repro.calibrate``, its spec part).

:class:`PlatformSpec` holds them — the H100 data-sheet defaults, or a
calibrated artifact — every serving cost model resolves them through
:func:`get_platform_spec`, and the tuning cache keys on
:func:`calibration_hash`.  The probes that fit a spec, the
modeled-vs-measured trajectory and the CLI are not ported yet (ROADMAP
queue 1, item 10).
"""

from .spec import (DEFAULT_SPEC, SPEC_KIND, SPEC_SCHEMA, CalibrationError,
                   PlatformSpec, calibrated_replace, calibration_hash,
                   device_fingerprint, get_platform_spec, load_spec,
                   set_platform_spec, spec_path)

__all__ = ["PlatformSpec", "CalibrationError", "DEFAULT_SPEC", "SPEC_SCHEMA",
           "SPEC_KIND", "load_spec", "spec_path", "get_platform_spec",
           "set_platform_spec", "calibration_hash", "calibrated_replace",
           "device_fingerprint"]
