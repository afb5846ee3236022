"""PyTorch + CUDA port of the adaptive SpMV/SpMM library.

The front door is ``repro_torch.api`` (re-exported here): ``sparse(csr) @ x``
plans on the matrix statistics, picks one of the paper's four kernels and
runs it through the hand-written Hopper kernels on a CUDA device, or through
the plain ``"torch"`` backend for ``device="cpu"``.  ``sddmm`` and
``sparse_chain`` run the graph-attention pair over the same plans.
"""
from .api import (PlanCache, SelectorThresholds, SparseMatrix, TileGeometry,
                  cache_stats, clear_cache, sddmm, sparse, sparse_chain,
                  use_backend)

__all__ = ["SparseMatrix", "sparse", "sddmm", "sparse_chain", "use_backend",
           "cache_stats", "clear_cache", "PlanCache", "SelectorThresholds",
           "TileGeometry"]
