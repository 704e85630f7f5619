"""Data pipeline substrate (the port's copy of ``repro.data``)."""

from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
