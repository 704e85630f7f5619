"""Checkpoint substrate (the port's copy of ``repro.checkpoint``): async
save, retention, atomic commit, restore onto a template's devices."""

from .store import (CheckpointManager, available_steps, load_checkpoint,
                    save_checkpoint)

__all__ = ["CheckpointManager", "available_steps", "load_checkpoint",
           "save_checkpoint"]
