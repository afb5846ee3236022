"""Block-sparse attention (DESIGN.md §10); counterpart of
``repro.attention``.

Pattern builders compile symbolic window specs into block masks and
token-level CSR patterns; the module layer routes them through
``PlanBuilder`` / ``PlanCache`` into the softmax attention chain (K7/K8, or
K9/K10 with a per-edge bias, on the card).  Reach it through
``repro_torch.api``.
"""
from .module import (SparseAttention, attention_plan, scoped_plan_cache,
                     sparse_attention, spec_mask)
from .patterns import (PATTERN_KINDS, AttentionMask, AttentionSpec, bigbird,
                       build_mask, dense_attention, expected_band_blocks,
                       from_block_mask, sliding_window)

__all__ = [
    "AttentionMask", "AttentionSpec", "PATTERN_KINDS", "SparseAttention",
    "attention_plan", "bigbird", "build_mask", "dense_attention",
    "expected_band_blocks", "from_block_mask", "scoped_plan_cache",
    "sliding_window", "sparse_attention", "spec_mask",
]
