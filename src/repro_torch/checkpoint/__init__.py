"""Checkpoints of the port; counterpart of ``repro.checkpoint``."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
