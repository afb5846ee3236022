"""Data of the port; counterpart of ``repro.data``."""
from .pipeline import DataConfig, MemmapCorpus, SyntheticLM

__all__ = ["DataConfig", "MemmapCorpus", "SyntheticLM"]
