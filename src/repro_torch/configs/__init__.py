"""Architecture registry of the port; counterpart of ``repro.configs`` for
the configurations ported so far.  ``get(name)`` returns the full config,
``get_smoke(name)`` a reduced same-family config for CPU tests."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import gemma3_12b

_MODULES = {"gemma3-12b": gemma3_12b}

ARCH_NAMES = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE
