"""Assigned architecture config: hymba_15b (see registry.py for the spec)."""
from .registry import hymba_15b as CONFIG  # noqa: F401
