"""Assigned architecture config: smollm_135m (see registry.py for the spec)."""
from .registry import smollm_135m as CONFIG  # noqa: F401
