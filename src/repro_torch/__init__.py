"""PyTorch + CUDA port of the adaptive SpMV/SpMM library.

The front door is ``repro_torch.api`` (re-exported here): ``sparse(csr) @ x``
plans on the matrix statistics, picks one of the paper's four kernels and
runs it through the hand-written Hopper kernels on a CUDA device, or through
the plain ``"torch"`` backend for ``device="cpu"``.  ``sddmm`` and
``sparse_chain`` run the graph-attention pair over the same plans, and
``sparse_attention`` block-sparse attention over a pattern spec.
``A @ x`` is differentiable in ``x`` and a ``with_values`` stream, and
``pattern_matmul`` is the sparse-weight training entry (``models.layers``,
``train``).
"""
from .api import (AttentionMask, AttentionSpec, PlanCache, SelectorThresholds,
                  SparseAttention, SparseMatrix, TileGeometry, __all__,
                  attention_plan, bigbird, build_mask, cache_stats,
                  clear_cache, dense_attention, from_block_mask,
                  pattern_matmul, scoped_plan_cache, sddmm, sliding_window,
                  sparse, sparse_attention, sparse_chain, use_backend)
