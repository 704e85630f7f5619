"""The model path of the port: PSpec parameter trees, attention
(full-sequence through the CUDA flash kernel, cached decode and chunked
prefill over contiguous KV rings or a paged pool, cross attention), the
SSD and MoE layers, the layer stacks of every family and the model
API."""

from .api import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]
