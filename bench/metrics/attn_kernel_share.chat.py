"""The share of the decode phase's attention layers that went through the
paged decode kernel: the ``attn_kernel_calls`` counter of the
``Server``'s ``decode`` phase (``repro_torch.kernels.paged_decode``, one
call a layer a step, however many splits it launches) ÷ (layers × the
decode steps of the traced window).  A program without the counter, or a
run off the card (where the kernel never runs), reports nothing."""

from bench.metrics._spans import step_phases

LAYER = "attention (models/attention.py)"
UNIT = "%"
MOVES = "itl_p95_ms"


def read(run):
    if not step_phases(run):
        return None
    phase = run.spans.get("decode")
    if not phase or not phase["count"] or "attn_kernel_calls" not in phase:
        return None
    layers = run.conf["num_hidden_layers"]
    return 100.0 * phase["attn_kernel_calls"] / (layers * phase["count"])
