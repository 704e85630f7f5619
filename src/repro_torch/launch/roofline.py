"""Roofline analysis over dry-run records (the port's copy of
``repro.launch.roofline``).

Per (arch × shape × mesh) cell:

    compute_term    = flops_per_device / peak_flops
    memory_term     = hbm_bytes_per_device / hbm_bw
    collective_term = collective_bytes_per_device / (links × link_bw)

priced with the live :func:`~repro_torch.calibrate.get_platform_spec`
(by default the H100 SXM data sheet: 989 TFLOP/s bf16, 3.35 TB/s HBM3,
18 NVLink 4 links at 25 GB/s), so a calibration artifact reprices the
terms.  The collective term charges the sum of collective payloads over
the device's links: one uniform link rate, whatever the mesh's mapping
onto nodes.

Composition: the reference's records count a scan body once (XLA's cost
analysis), so its totals are ``module + (trips − 1) × block`` with the
block-level lowering shipped alongside each cell (and ``enc_block`` for
the enc-dec arch).  The port's records run every block eagerly and are
marked ``settings["counts"] == "all_trips"``: their module counts are
the totals and are not composed again.

MODEL_FLOPS = 6·N·D for dense training (N params, D tokens), 6·N_active·D
for MoE, 2·N·D for pure forward (prefill), 2·N_active·B for one decode
step.  The ratio MODEL_FLOPS / counted FLOPs measures how much of the
compute is "useful": remat recompute, attention (excluded from 6ND by
convention), MoE dispatch and padding all show up here.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from ..calibrate.spec import DEFAULT_SPEC, get_platform_spec
from ..configs import SHAPES, get_config

# data-sheet aliases of the port's DEFAULT_SPEC (H100 SXM); analyze()
# resolves the live constants through get_platform_spec()
PEAK_FLOPS = DEFAULT_SPEC.peak_flops   # bf16 FLOP/s per device
HBM_BW = DEFAULT_SPEC.hbm_bw           # bytes/s per device
LINK_BW = DEFAULT_SPEC.link_bw         # bytes/s per NVLink link
LINKS = DEFAULT_SPEC.links             # links per device


def active_params(arch: str) -> int:
    """Parameters touched per token (MoE: top-k experts + shared)."""

    from ..models.api import build_model
    cfg = get_config(arch)
    total = build_model(cfg).param_count()
    if cfg.moe is None:
        return total
    m = cfg.moe
    # expert params per MoE layer
    per_expert = 3 * cfg.d_model * cfg.d_ff
    n_moe_layers = cfg.n_layers // m.every
    expert_total = n_moe_layers * m.num_experts * per_expert
    expert_active = n_moe_layers * m.top_k * per_expert
    return total - expert_total + expert_active


def model_flops(arch: str, shape_name: str) -> float:
    shape = SHAPES[shape_name]
    n_act = active_params(arch)
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch


def _scaled(rec: dict, key_path: tuple[str, ...],
            trips_minus_1_blocks: list[tuple[dict, int]]) -> float:
    def get(d, path):
        for k in path:
            d = d.get(k, {}) if isinstance(d, dict) else {}
        return d if isinstance(d, (int, float)) else 0.0

    total = get(rec, key_path)
    for blk, extra_trips in trips_minus_1_blocks:
        total += extra_trips * get(blk, key_path)
    return total


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    hlo_flops_per_dev: float = 0.0
    hbm_bytes_per_dev: float = 0.0
    coll_bytes_per_dev: float = 0.0
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    peak_hbm_gib: float = 0.0
    step_time_s: float = 0.0          # max of the three terms
    mfu: float = 0.0                  # model_flops/(devices*peak*step_time)
    note: str = ""

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.compute_s*1e3:.2f} | {self.memory_s*1e3:.2f} | "
                f"{self.collective_s*1e3:.2f} | {self.dominant} | "
                f"{self.useful_ratio:.2f} | {self.mfu*100:.1f}% |")


def _composition(rec: dict) -> list[tuple[dict, int]]:
    """The (block record, extra trips) pairs a record's totals need: none
    for the port's all-trips counts."""

    if rec.get("settings", {}).get("counts") == "all_trips":
        return []
    comp = []
    for key in ("block", "enc_block"):
        blk = rec.get(key)
        if blk and blk.get("status") == "ok":
            comp.append((blk, max(0, blk["settings"]["trips"] - 1)))
    return comp


def analyze(rec: dict, *, spec=None) -> Roofline:
    r = Roofline(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                 status=rec["status"])
    if rec["status"] != "ok":
        r.note = rec.get("reason", "")
        return r
    if spec is None:
        spec = get_platform_spec()

    comp = _composition(rec)
    n_dev = rec.get("n_devices", 256)
    r.hlo_flops_per_dev = _scaled(rec, ("cost", "flops"), comp)
    r.hbm_bytes_per_dev = _scaled(rec, ("cost", "bytes_accessed"), comp)
    # the records' shapes are per-device shards already
    r.coll_bytes_per_dev = _scaled(rec, ("collectives", "total_bytes"),
                                   comp)

    r.compute_s = r.hlo_flops_per_dev / spec.peak_flops
    r.memory_s = r.hbm_bytes_per_dev / spec.hbm_bw
    r.collective_s = r.coll_bytes_per_dev / spec.ici_bw
    terms = {"compute": r.compute_s, "memory": r.memory_s,
             "collective": r.collective_s}
    r.dominant = max(terms, key=terms.get)
    r.step_time_s = max(terms.values())

    r.model_flops = model_flops(rec["arch"], rec["shape"])
    total = r.hlo_flops_per_dev * n_dev
    r.useful_ratio = r.model_flops / total if total else 0.0
    if r.step_time_s > 0:
        r.mfu = r.model_flops / (n_dev * spec.peak_flops * r.step_time_s)
    r.peak_hbm_gib = rec.get("memory", {}).get("peak_hbm_bytes", 0) / 2**30
    return r


def analyze_file(path: str) -> list[Roofline]:
    with open(path) as f:
        records = json.load(f)
    return [analyze(rec) for rec in records]


def what_moves_it(r: Roofline) -> str:
    """One-sentence lever on the dominant term (per-cell heuristic)."""

    if r.dominant == "compute":
        if r.useful_ratio < 0.5:
            return ("compute is mostly non-model work (remat/attention/"
                    "dispatch): relax remat policy or cut dispatch/"
                    "mask overheads")
        return "compute-bound at high useful ratio: already near roofline"
    if r.dominant == "memory":
        return ("HBM-bound: raise arithmetic intensity — bigger per-device "
                "batch, fuse CE/softmax, drop f32 intermediates")
    return ("collective-bound: reshard to cut the dominant collective "
            "(FSDP vs TP trade, gradient compression on the pod axis, "
            "overlap via microbatching)")


__all__ = ["analyze", "analyze_file", "Roofline", "model_flops",
           "active_params", "what_moves_it", "PEAK_FLOPS", "HBM_BW",
           "LINK_BW", "LINKS"]
