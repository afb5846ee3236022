"""Model code of the port; counterpart of ``repro.models``.  Ported so far:
the configuration dataclasses and the block-sparse attention of
``transformer.py``."""
from .config import ModelConfig, MoEConfig, SparseFFNConfig, SSMConfig

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "SparseFFNConfig"]
