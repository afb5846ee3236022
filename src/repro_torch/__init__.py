"""PyTorch + CUDA port of the adaptive SpMV/SpMM library.

The front door is ``repro_torch.api`` (re-exported here): ``sparse(csr) @ x``
plans on the matrix statistics, picks one of the paper's four kernels and
runs it through the hand-written Hopper kernels on a CUDA device, or through
the plain ``"torch"`` backend for ``device="cpu"``.
"""
from .api import (PlanCache, SelectorThresholds, SparseMatrix, TileGeometry,
                  cache_stats, clear_cache, sparse, use_backend)

__all__ = ["SparseMatrix", "sparse", "use_backend", "cache_stats",
           "clear_cache", "PlanCache", "SelectorThresholds", "TileGeometry"]
