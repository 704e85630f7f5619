"""Assigned architecture config: minitron_8b (see registry.py for the spec)."""
from .registry import minitron_8b as CONFIG  # noqa: F401
