"""Assigned architecture config: mamba2_27b (see registry.py for the spec)."""
from .registry import mamba2_27b as CONFIG  # noqa: F401
