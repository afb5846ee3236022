"""Architecture registry of the port; counterpart of ``repro.configs`` for
the ten architectures (the paper's own SpMM workload is
``configs.paper_spmm``, outside the registry as in the reference).
``get(name)`` returns the full config, ``get_smoke(name)`` a reduced
same-family config for CPU tests."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (gemma3_12b, kimi_k2_1t_a32b, llama3_2_1b, olmoe_1b_7b,
               phi3_mini_3_8b, phi4_mini_3_8b, qwen2_vl_72b, rwkv6_3b,
               whisper_tiny, zamba2_2_7b)

_MODULES = {
    "olmoe-1b-7b": olmoe_1b_7b,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "llama3.2-1b": llama3_2_1b,
    "gemma3-12b": gemma3_12b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "whisper-tiny": whisper_tiny,
    "zamba2-2.7b": zamba2_2_7b,
    "rwkv6-3b": rwkv6_3b,
    "qwen2-vl-72b": qwen2_vl_72b,
}

ARCH_NAMES = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE
