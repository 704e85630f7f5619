"""Assigned architecture config: qwen15_4b (see registry.py for the spec)."""
from .registry import qwen15_4b as CONFIG  # noqa: F401
