"""Assigned architecture config: llama4_maverick (see registry.py for the spec)."""
from .registry import llama4_maverick as CONFIG  # noqa: F401
