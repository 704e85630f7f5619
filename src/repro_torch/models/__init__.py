"""The dense decoder of the port: PSpec parameter trees, attention
(full-sequence through the CUDA flash kernel, cached decode and chunked
prefill over contiguous KV rings or a paged pool), the layer stack and
the model API."""

from .api import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]
