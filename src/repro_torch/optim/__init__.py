"""Optimizer substrate (the port's copy of ``repro.optim``)."""

from .adamw import (OptState, adamw_init, adamw_update, cosine_schedule,
                    global_norm)
from .compression import compress_int8, decompress_int8, ef_compress_grads

__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "compress_int8", "decompress_int8",
           "ef_compress_grads"]
