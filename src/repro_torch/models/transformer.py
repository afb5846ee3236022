"""Transformer blocks; counterpart of ``repro.models.transformer``.  Ported
so far: the block-sparse attention of the ``block_sparse`` pattern
(DESIGN.md §10), ``_block_sparse_spec`` and ``_block_sparse_attention``."""
from __future__ import annotations

import torch

from .config import ModelConfig


def _block_sparse_spec(cfg: ModelConfig, seq: int, causal: bool):
    """The attention mask spec a block_sparse config implies at this
    sequence length: token window → block band (BigBird when global/random
    blocks are configured), dense-fallback blocks when no window is set.
    Specs are frozen and hashable, so every layer/head/call at one seq
    shares a single PlanCache entry."""
    from ..attention import bigbird, dense_attention, sliding_window
    block = cfg.attn_block or 64
    if cfg.window > 0:
        wb = -(-cfg.window // block)  # token window, ceil to blocks
        if cfg.attn_global_blocks or cfg.attn_random_blocks:
            return bigbird(seq, wb, cfg.attn_global_blocks,
                           cfg.attn_random_blocks, block=block, causal=causal)
        return sliding_window(seq, wb, block=block, causal=causal)
    return dense_attention(seq, block=block, causal=causal)


def _block_sparse_attention(qt, kt, vt, cfg: ModelConfig, causal: bool):
    """Train/prefill attention through the sparse-softmax chain (DESIGN.md
    §10).  qt (B, H, S, hd), kt/vt (B, Hk, S, hd) → (B, H, S, hd); GQA
    repeats each KV head in place (``jnp.repeat(..., axis=1)`` in the
    reference, so ``repeat_interleave`` here), and the spec's plan is built
    once and shared across the whole (B, H) fan-out."""
    from ..attention import sparse_attention
    b, h, s, hd = qt.shape
    hk = kt.shape[1]
    if h != hk:
        rep = h // hk
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    spec = _block_sparse_spec(cfg, s, causal)
    out = sparse_attention(spec, qt.to(torch.float32), kt.to(torch.float32),
                           vt.to(torch.float32))
    return out.to(qt.dtype)
