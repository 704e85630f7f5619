"""Assigned architecture config: qwen3_32b (see registry.py for the spec)."""
from .registry import qwen3_32b as CONFIG  # noqa: F401
