"""Assigned architecture config: llama32_vision_90b (see registry.py for the spec)."""
from .registry import llama32_vision_90b as CONFIG  # noqa: F401
