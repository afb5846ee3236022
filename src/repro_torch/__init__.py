"""PyTorch + CUDA port of the adaptive SpMV/SpMM library.

The front door is ``repro_torch.api`` (re-exported here): ``sparse(csr) @ x``
plans on the matrix statistics, picks one of the paper's four kernels and
runs it through the hand-written Hopper kernels on a CUDA device, or through
the plain ``"torch"`` backend for ``device="cpu"``.  ``sddmm`` and
``sparse_chain`` run the graph-attention pair over the same plans, and
``sparse_attention`` block-sparse attention over a pattern spec.
"""
from .api import (AttentionMask, AttentionSpec, PlanCache, SelectorThresholds,
                  SparseAttention, SparseMatrix, TileGeometry, __all__,
                  attention_plan, bigbird, build_mask, cache_stats,
                  clear_cache, dense_attention, from_block_mask,
                  scoped_plan_cache, sddmm, sliding_window, sparse,
                  sparse_attention, sparse_chain, use_backend)
