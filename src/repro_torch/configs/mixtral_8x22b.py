"""Assigned architecture config: mixtral_8x22b (see registry.py for the spec)."""
from .registry import mixtral_8x22b as CONFIG  # noqa: F401
