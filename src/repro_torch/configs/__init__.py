"""Architecture configs: the schema and the registry of the ten assigned
architectures, as plain data."""
from .base import SHAPES, ArchConfig, MoECfg, SSMCfg, ShapeSpec, supports
from .registry import ARCHS, get_config

__all__ = ["SHAPES", "ArchConfig", "MoECfg", "SSMCfg", "ShapeSpec",
           "supports", "ARCHS", "get_config"]
