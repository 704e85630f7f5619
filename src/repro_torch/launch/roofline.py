"""Roofline helpers (the port's copy of part of
``repro.launch.roofline``): the parameters a token touches, which the
distributed machine model (:mod:`repro_torch.core.tpu_machine`) prices.
The rest of the reference's roofline reads compiled-artifact records and
is not ported yet."""

from __future__ import annotations

from ..configs import get_config


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


__all__ = ["active_params"]
