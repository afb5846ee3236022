"""Model code of the port; counterpart of ``repro.models``.  Ported so far:
the configuration dataclasses, the block-sparse attention of
``transformer.py``, and the sparse FFN (``layers.py``'s ``SparsePattern``,
``sparse_matmul``, ``sparse_mlp_apply``; ``transformer.SparseFFN``)."""
from .config import ModelConfig, MoEConfig, SparseFFNConfig, SSMConfig
from .layers import SparsePattern, rmsnorm, sparse_matmul, sparse_mlp_apply
from .transformer import SparseFFN, ffn_apply, sparse_patterns

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "SparseFFNConfig",
           "SparseFFN", "SparsePattern", "ffn_apply", "rmsnorm",
           "sparse_matmul", "sparse_mlp_apply", "sparse_patterns"]
