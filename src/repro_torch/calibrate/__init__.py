"""Platform calibration: measured device constants for the cost models
(the port's copy of ``repro.calibrate``).

The paper model-checks a *faithful* platform model; faithfulness starts
with the constants.  This package measures them: ERT-style probes
(:mod:`.probes`) fit peak FLOP/s, memory bandwidth, dispatch latency
and (several cards) link bandwidth into a schema-versioned
:class:`PlatformSpec` artifact (:mod:`.spec`), every cost model resolves
its constants through :func:`get_platform_spec`, the tuning cache keys
on :func:`calibration_hash`, and :mod:`.trajectory` tracks the
modeled-vs-measured gap per tunable over time.

CLI: ``python -m repro_torch.calibrate run|show|export``.
"""

from .probes import (collective_bw_sweep, dispatch_latency_sweep,
                     ensure_calibrated, fit_bandwidth, fit_dispatch_us,
                     fit_link_bw, fit_peak_flops, matmul_flops_sweep,
                     memory_bw_sweep, run_calibration)
from .spec import (DEFAULT_SPEC, SPEC_KIND, SPEC_SCHEMA, CalibrationError,
                   PlatformSpec, calibrated_replace, calibration_hash,
                   device_fingerprint, get_platform_spec, load_spec,
                   set_platform_spec, spec_path)
from .trajectory import (TRAJECTORY_PATH, append_run, gap_from_stats,
                         load_trajectory, measure_gap, run_trajectory)

__all__ = [
    # spec + resolver
    "PlatformSpec", "CalibrationError", "DEFAULT_SPEC", "SPEC_SCHEMA",
    "SPEC_KIND", "load_spec", "spec_path", "get_platform_spec",
    "set_platform_spec", "calibration_hash", "calibrated_replace",
    "device_fingerprint",
    # probes
    "matmul_flops_sweep", "memory_bw_sweep", "dispatch_latency_sweep",
    "collective_bw_sweep", "fit_peak_flops", "fit_bandwidth",
    "fit_dispatch_us", "fit_link_bw", "run_calibration",
    "ensure_calibrated",
    # trajectory
    "TRAJECTORY_PATH", "gap_from_stats", "measure_gap",
    "load_trajectory", "append_run", "run_trajectory",
]
