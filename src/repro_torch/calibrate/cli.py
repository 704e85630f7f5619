"""``python -m repro_torch.calibrate`` — run/show/export the platform spec
(the port's copy of ``repro.calibrate.cli``, with its exit codes).

::

    python -m repro_torch.calibrate run             # probe (or load) + save
    python -m repro_torch.calibrate run --force     # always re-probe
    python -m repro_torch.calibrate run --quick     # test-sized (CPU)
    python -m repro_torch.calibrate show            # active spec
    python -m repro_torch.calibrate export out.json # copy the artifact

``run`` is load-or-probe: a schema-current artifact for this device
makes the second invocation a pure artifact load (``probes_run: 0``,
``status: "loaded"``), which ``--json`` shows.  Errors (a missing or
foreign artifact) exit with code 1.
"""

from __future__ import annotations

import argparse
import json
import sys

from .probes import ensure_calibrated
from .spec import (DEFAULT_SPEC, CalibrationError, get_platform_spec,
                   load_spec, set_platform_spec, spec_path)


def _fmt_constants(spec) -> str:
    default = DEFAULT_SPEC.constants()
    lines = [f"{'constant':<12} {'value':>14} {'default':>14}  note"]
    units = {"peak_flops": "FLOP/s", "hbm_bw": "B/s", "link_bw": "B/s",
             "dci_bw": "B/s", "links": "", "dispatch_us": "us"}
    fitted = set((spec.probes or {}).get("fitted", ()))
    for name, value in spec.constants().items():
        note = "fitted" if name in fitted else (
            "default" if value == default[name] else "set")
        lines.append(f"{name:<12} {value:>14.4g} {default[name]:>14.4g}"
                     f"  {note} {units[name]}")
    return "\n".join(lines)


def _cmd_run(args) -> int:
    spec, probed = ensure_calibrated(
        args.spec, force=args.force, quick=args.quick)
    n_probes = 0
    if probed:
        probes = spec.probes or {}
        n_probes = sum(1 for k in ("matmul", "triad", "dispatch",
                                   "collective") if probes.get(k))
    out = {"status": "calibrated" if probed else "loaded",
           "probes_run": n_probes,
           "path": str(spec_path(args.spec)),
           "calibration": spec.calibration_hash(),
           "backend": spec.backend, "device_kind": spec.device_kind,
           "constants": spec.constants()}
    if args.json:
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        print(f"[calibrate] {out['status']} ({n_probes} probes) "
              f"-> {out['path']}")
        print(f"[calibrate] device: {spec.backend}/{spec.device_kind} "
              f"hash={out['calibration']}")
        print(_fmt_constants(spec))
    return 0


def _cmd_show(args) -> int:
    prev = None
    if args.spec is not None:
        # explicit path: show THAT artifact, not the resolution chain
        prev = set_platform_spec(load_spec(spec_path(args.spec)))
    try:
        spec = get_platform_spec()
        if args.json:
            print(json.dumps({
                "source": spec.source,
                "calibration": spec.calibration_hash(),
                "backend": spec.backend, "device_kind": spec.device_kind,
                "created": spec.created,
                "constants": spec.constants()}, indent=1, sort_keys=True))
        else:
            print(f"[calibrate] source={spec.source} "
                  f"hash={spec.calibration_hash()} "
                  f"device={spec.backend}/{spec.device_kind}")
            print(_fmt_constants(spec))
    finally:
        if args.spec is not None:
            set_platform_spec(prev)
    return 0


def _cmd_export(args) -> int:
    spec = load_spec(spec_path(args.spec))
    out = spec.save(args.out)
    print(f"[calibrate] exported {spec.calibration_hash()} -> {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calibrate",
        description="measure/inspect the platform calibration artifact")
    ap.add_argument("--spec", default=None, metavar="PATH",
                    help="artifact path (default: $REPRO_TORCH_PLATFORM_SPEC "
                         "or ~/.cache/repro_torch/platform_spec.json)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="probe the device (or load a "
                                       "current artifact) and save")
    p_run.add_argument("--force", action="store_true",
                       help="re-probe even if a valid artifact exists")
    p_run.add_argument("--quick", action="store_true",
                       help="small ladders on a CPU (seconds, not "
                            "minutes); a card takes its own")
    p_run.add_argument("--json", action="store_true",
                       help="machine-readable status on stdout")
    p_run.set_defaults(fn=_cmd_run)

    p_show = sub.add_parser("show", help="print the active spec")
    p_show.add_argument("--json", action="store_true")
    p_show.set_defaults(fn=_cmd_show)

    p_exp = sub.add_parser("export", help="copy the artifact to a path")
    p_exp.add_argument("out", help="destination file")
    p_exp.set_defaults(fn=_cmd_export)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, CalibrationError) as e:
        print(f"[calibrate] error: {e}", file=sys.stderr)
        return 1


__all__ = ["main"]
