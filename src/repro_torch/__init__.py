"""PyTorch + CUDA port of the adaptive SpMV/SpMM library.

The front door is ``repro_torch.api`` (re-exported here): ``sparse(csr) @ x``
plans on the matrix statistics, picks one of the paper's four kernels and
runs it through the hand-written Hopper kernels on a CUDA device, or through
the plain ``"torch"`` backend for ``device="cpu"``.  ``sddmm`` and
``sparse_chain`` run the graph-attention pair over the same plans, and
``sparse_attention`` block-sparse attention over a pattern spec.
``A @ x`` is differentiable in ``x`` and a ``with_values`` stream, and
``pattern_matmul`` is the sparse-weight training entry (``models.layers``,
``train``).  The offline half of the paper's split: ``calibrate_backend``
fits the selector's thresholds to measured kernel times, the ``autotune_*``
tuners fit the nnz quota and the fuse gates (``kernels/tune.py``), and
``A.finalize(n)`` freezes a plan into a ``PlanArtifact`` whose ``execute``
does no host work (a CUDA graph can capture it).  The guardrails
(``core/guardrails.py``): ``sparse(validate=)``, ``sentinel=`` on a call,
and a counted ladder from the card's kernels to the plain ones, read by
``health()``.  ``sparse(csr, mesh=...)`` (or a ``use_mesh`` scope) shards
the matrix over a device mesh (``core/shard.py``, ``launch/mesh.py``).
"""
from . import api
from .api import (AttentionMask, AttentionSpec, PlanArtifact, PlanBuilder,
                  PlanCache, SelectorThresholds, SparseAttention, SparseMatrix,
                  TileGeometry, attention_plan, autotune_attention,
                  autotune_chain, autotune_geometry, autotune_overlap,
                  autotune_quant, bigbird, build_mask,
                  cache_stats, calibrate, calibrate_backend, clear_cache,
                  dense_attention, execute, from_block_mask, pattern_matmul,
                  scoped_plan_cache, sddmm, sliding_window, sparse,
                  sparse_attention, sparse_chain, use_backend, use_mesh)
from .api import (configure_guardrails, health,  # noqa: F401 (re-export)
                  reset_health)

__all__ = [
    "api", "sparse", "SparseMatrix", "pattern_matmul", "use_backend",
    "use_mesh",
    "calibrate", "calibrate_backend", "cache_stats", "clear_cache",
    "PlanArtifact", "PlanBuilder", "PlanCache", "SelectorThresholds",
    # beyond the reference's top level: the rest of the facade
    "TileGeometry", "execute", "sddmm", "sparse_chain", "AttentionMask",
    "AttentionSpec", "SparseAttention", "attention_plan", "bigbird",
    "build_mask", "dense_attention", "from_block_mask", "scoped_plan_cache",
    "sliding_window", "sparse_attention", "health", "reset_health",
    "configure_guardrails", "autotune_geometry", "autotune_overlap",
    "autotune_quant", "autotune_chain", "autotune_attention",
]
