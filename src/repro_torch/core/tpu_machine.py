"""Abstract multi-GPU machine model for distributed-configuration
tuning (the port's copy of ``repro.core.tpu_machine``, names kept so
that a reference plan's ``tpu.distributed`` job resolves).

This is the paper's "Abstract Platform" (§3.1) re-instantiated for a
GPU cluster: instead of devices/units/PEs with a GMT memory ratio, the
platform is nodes ("pods") x GPUs ("chips") with three resources per GPU
— tensor-core FLOP/s, HBM bandwidth and the NVLink aggregate
(``ici_bw`` of the platform spec) — plus the node-to-node link
(``dci_bw``).  Every constant comes from the port's
:func:`~repro_torch.calibrate.spec.get_platform_spec`: the NVIDIA H100
SXM data sheet (989 TFLOP/s bf16, 3.35 TB/s, 18 NVLink 4 links of
25 GB/s, one 400 Gb/s InfiniBand port a GPU) or a calibration artifact
fitted on the card.

``TPUWorkload`` captures one training step analytically; the modeled
step time plays the role of the paper's model ``time`` variable, and
the search over :class:`TPUConfig` lattices runs through the same
engines (``repro_torch.tune.tune`` on a :class:`DistributedTunable`, or
``tune_distributed`` below).

The default platform is 256 GPUs in one domain: NVIDIA's DGX H100
SuperPOD NVLink Switch System joins up to 256 H100s all to all, the
counterpart of the reference's 256-chip pod.  Device memory defaults to
the H100's 80 GB (``HBM_BYTES``); the training driver passes the card's
own ``torch.cuda.get_device_properties(dev).total_memory``.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, ClassVar, Mapping

from ..calibrate.spec import DEFAULT_SPEC, get_platform_spec
from .search_space import Param, SearchSpace

# Data-sheet aliases (H100 SXM), stated once in calibrate.spec.DEFAULT_SPEC.
# The models below resolve LIVE constants via get_platform_spec() so a
# calibration artifact (python -m repro_torch.calibrate run) reprices
# them; these names remain for callers that want the uncalibrated numbers.
PEAK_FLOPS = DEFAULT_SPEC.peak_flops
HBM_BW = DEFAULT_SPEC.hbm_bw
ICI_BW = DEFAULT_SPEC.ici_bw
DCI_BW = DEFAULT_SPEC.dci_bw
# device memory of one H100 SXM (NVIDIA data sheet: 80 GB HBM3)
HBM_BYTES = 80e9


@dataclass(frozen=True)
class TPUWorkload:
    """One training step of a stacked-layer LM (analytic)."""

    params: int                      # total parameter count
    active_params: int               # per-token touched params (MoE)
    layers: int
    d_model: int
    seq: int
    global_batch: int
    vocab: int
    dtype_bytes: int = 2
    flops_const: float = 6.0         # 6 = fwd+bwd

    # -- repro_torch.tune Tunable protocol (default 256-GPU single-domain
    # target; use .tunable() to pin a different platform) -----------------

    name: ClassVar[str] = "tpu.workload"

    def tunable(self, *, chips_per_pod: int = 256, pods: int = 1,
                hbm_bytes: float = HBM_BYTES) -> "DistributedTunable":
        return DistributedTunable(self, chips_per_pod=chips_per_pod,
                                  pods=pods, hbm_bytes=hbm_bytes)

    def space(self) -> SearchSpace:
        return self.tunable().space()

    def cost(self, cfg: Mapping[str, Any]) -> float:
        return self.tunable().cost(cfg)

    def fingerprint(self) -> dict[str, Any]:
        return self.tunable().fingerprint()


@dataclass(frozen=True)
class TPUConfig:
    """A tuning-parameter configuration (the WG/TS analogue)."""

    dp: int                          # data-parallel ways (per pod)
    tp: int                          # tensor-parallel ways
    pods: int = 1
    microbatches: int = 1
    remat: str = "full"              # none | dots | full
    compress_pod_grads: bool = False
    fsdp: bool = False               # shard params over dp (ZeRO-3-ish)


def step_time(w: TPUWorkload, c: TPUConfig, *, overlap: float = 0.7,
              spec=None) -> dict[str, float]:
    """Modeled per-step time decomposition (seconds).

    overlap: fraction of collective time hidden under compute (async
    collectives + microbatch pipelining).  ``spec`` pins the platform
    constants (a :class:`repro_torch.calibrate.PlatformSpec`); ``None``
    resolves the active one (calibrated when an artifact exists)."""

    if spec is None:
        spec = get_platform_spec()
    chips = c.dp * c.tp * c.pods
    tokens = w.seq * w.global_batch

    # -- compute ------------------------------------------------------------
    remat_mult = {"none": 1.0, "dots": 1.15, "full": 4.0 / 3.0}[c.remat]
    flops = w.flops_const * w.active_params * tokens * remat_mult
    compute = flops / (chips * spec.peak_flops)

    # -- memory -------------------------------------------------------------
    # weights re-streamed once per microbatch (fwd) + once (bwd);
    # activations in/out once; optimizer state touched once.
    w_bytes = w.params * w.dtype_bytes / (c.tp * (c.dp if c.fsdp else 1))
    act_bytes = tokens // (c.dp * c.pods) * w.d_model * w.dtype_bytes \
        * w.layers * (4 if c.remat == "none" else 2)
    opt_bytes = w.params * 12 / (c.tp * (c.dp if c.fsdp else 1))
    hbm = (w_bytes * (c.microbatches + 1) + act_bytes + opt_bytes) \
        / spec.hbm_bw

    # -- collectives ----------------------------------------------------------
    # DP gradient all-reduce (ring): 2*(n-1)/n * bytes; FSDP swaps it for
    # reduce-scatter + all-gather (same volume, half latency exposure).
    grad_bytes = w.params * w.dtype_bytes / c.tp
    dp_ways = c.dp
    dp_ar = 2 * (dp_ways - 1) / max(dp_ways, 1) * grad_bytes / spec.ici_bw
    # TP per-layer activation collectives (2 all-reduces/layer fwd+bwd)
    tp_bytes = (tokens // (c.dp * c.pods)) * w.d_model * w.dtype_bytes
    tp_ar = (4 * (c.tp - 1) / max(c.tp, 1) * tp_bytes * w.layers /
             max(c.microbatches, 1) * c.microbatches) / spec.ici_bw \
        if c.tp > 1 else 0.0
    # node-axis gradient reduction over the node link (compressible)
    pod_bytes = grad_bytes * (0.25 if c.compress_pod_grads else 1.0)
    pod_ar = 2 * (c.pods - 1) / max(c.pods, 1) * pod_bytes / spec.dci_bw \
        if c.pods > 1 else 0.0

    collective = dp_ar + tp_ar + pod_ar
    exposed = collective * (1.0 - overlap * min(1.0, c.microbatches / 2))
    total = max(compute, hbm) + exposed
    return {"compute": compute, "memory": hbm, "collective": collective,
            "exposed_collective": exposed, "total": total,
            "chips": chips}


def hbm_fits(w: TPUWorkload, c: TPUConfig, *, hbm_bytes: float = HBM_BYTES
             ) -> bool:
    # FSDP shards parameters/optimizer over the dp axes of every pod
    chips = c.tp * ((c.dp * c.pods) if c.fsdp else 1)
    resident = w.params * (w.dtype_bytes + 8 + 4) / chips
    act = (w.seq * w.global_batch // (c.dp * c.pods)) * w.d_model * \
        w.dtype_bytes * (w.layers if c.remat == "none" else 2)
    return resident + act < hbm_bytes * 0.9


def config_space(chips_per_pod: int = 256, pods: int = 1) -> SearchSpace:
    tps = [t for t in (1, 2, 4, 8, 16, 32) if chips_per_pod % t == 0]
    space = SearchSpace(params=[
        Param("tp", tuple(tps)),
        Param("microbatches", (1, 2, 4, 8)),
        Param("remat", ("none", "dots", "full")),
        Param("fsdp", (False, True)),
        Param("compress_pod_grads", ((False, True) if pods > 1
                                     else (False,))),
    ])
    return space


@dataclass(frozen=True)
class DistributedTunable:
    """``repro_torch.tune`` Tunable: the distributed-training
    configuration lattice for one workload on a nodes × GPUs platform.
    Infeasible (memory-overflowing) points cost ``inf``."""

    workload: TPUWorkload
    chips_per_pod: int = 256
    pods: int = 1
    hbm_bytes: float = HBM_BYTES
    name: ClassVar[str] = "tpu.distributed"

    def __post_init__(self):
        # step-time decompositions computed during the search, so callers
        # (tune_distributed's ranked list) don't price the lattice twice
        object.__setattr__(self, "_decompositions", {})

    def space(self) -> SearchSpace:
        return config_space(self.chips_per_pod, self.pods)

    def to_config(self, cfg: Mapping[str, Any]) -> TPUConfig:
        return TPUConfig(dp=self.chips_per_pod // cfg["tp"], tp=cfg["tp"],
                         pods=self.pods, microbatches=cfg["microbatches"],
                         remat=cfg["remat"], fsdp=cfg["fsdp"],
                         compress_pod_grads=cfg["compress_pod_grads"])

    def cost(self, cfg: Mapping[str, Any]) -> float:
        c = self.to_config(cfg)
        if not hbm_fits(self.workload, c, hbm_bytes=self.hbm_bytes):
            return float("inf")
        t = step_time(self.workload, c)
        self._decompositions[c] = t
        return t["total"]

    def decomposition(self, c: TPUConfig) -> dict[str, float]:
        t = self._decompositions.get(c)
        return t if t is not None else step_time(self.workload, c)

    def fingerprint(self) -> dict[str, Any]:
        return {"tunable": self.name, "workload": asdict(self.workload),
                "chips_per_pod": self.chips_per_pod, "pods": self.pods,
                "hbm_bytes": self.hbm_bytes}


def tune_distributed(w: TPUWorkload, *, chips_per_pod: int = 256,
                     pods: int = 1, hbm_bytes: float = HBM_BYTES):
    """Sweep the config lattice through the machine model (via the
    ``repro_torch.tune`` grid engine); returns (best TPUConfig, best step
    decomposition, ranked list)."""

    from ..tune import tune as _tune
    tb = DistributedTunable(w, chips_per_pod=chips_per_pod, pods=pods,
                            hbm_bytes=hbm_bytes)
    res = _tune(tb, engine="grid", cache=None, keep_trace=True)
    ranked = []
    for total, cfg in res.stats["trace"]:
        if math.isfinite(total):
            c = tb.to_config(cfg)
            ranked.append((total, c, tb.decomposition(c)))
    if not ranked:
        raise RuntimeError("no feasible configuration fits HBM")
    ranked.sort(key=lambda r: r[0])
    return ranked[0][1], ranked[0][2], ranked


def workload_from_arch(arch: str, shape_name: str) -> TPUWorkload:
    from ..configs import SHAPES, get_config
    from ..launch.roofline import active_params
    from ..models.api import build_model
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    api = build_model(cfg)
    return TPUWorkload(params=api.param_count(),
                       active_params=active_params(arch),
                       layers=cfg.n_layers, d_model=cfg.d_model,
                       seq=shape.seq_len, global_batch=shape.global_batch,
                       vocab=cfg.vocab)


__all__ = ["HBM_BYTES", "TPUWorkload", "TPUConfig", "DistributedTunable",
           "step_time", "hbm_fits", "config_space", "tune_distributed",
           "workload_from_arch"]
