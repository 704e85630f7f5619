"""Assigned architecture config: whisper_medium (see registry.py for the spec)."""
from .registry import whisper_medium as CONFIG  # noqa: F401
