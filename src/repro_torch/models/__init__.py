"""Model code of the port; counterpart of ``repro.models``: the
configuration dataclasses and shape cells, the param specs (``params``),
the layers, the transformer blocks, the MoE (``moe``: router, one-hot, sort
and SpMM dispatch, the pinned half), the Mamba-2 / SSD mixer (``ssm``), the
RWKV-6 mixers (``rwkv``), the chunked LM loss and ``Model``."""
from .config import (SHAPES, ModelConfig, MoEConfig, ShapeCell,
                     SparseFFNConfig, SSMConfig)
from .layers import SparsePattern, rmsnorm, sparse_matmul, sparse_mlp_apply
from .model import Model
from .transformer import SparseFFN, ffn_apply, sparse_patterns

__all__ = ["SHAPES", "Model", "ModelConfig", "MoEConfig", "SSMConfig",
           "ShapeCell", "SparseFFNConfig", "SparseFFN", "SparsePattern",
           "ffn_apply", "rmsnorm", "sparse_matmul", "sparse_mlp_apply",
           "sparse_patterns"]
