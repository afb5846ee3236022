"""Attention pattern builders: window specs → block masks → CSR patterns;
counterpart of ``repro.attention.patterns``.

A frozen :class:`AttentionSpec` names a block-sparse pattern symbolically —
sliding window, causal sliding window, BigBird-style window+global+random,
an explicit block mask, or dense — and :func:`build_mask` compiles it into
an :class:`AttentionMask`: the boolean block mask, the token-granularity
``CSR`` (on the CPU) that ``plan()`` consumes, and block-level stats.

Everything here is host-side numpy and deterministic: BigBird's random
blocks come from the same ``np.random.default_rng(seed)`` draws as the
reference, so both packages build element-equal masks for one spec.
Causality is enforced at token granularity: diagonal blocks of a causal mask
keep only their lower triangle, so no kernel applies a runtime causal mask.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.formats import CSR, _csr

#: spec kinds build_mask understands
PATTERN_KINDS = ("sliding_window", "bigbird", "dense", "block_mask")


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Symbolic description of one block-sparse attention pattern.

    ``window`` counts *blocks* on each side of the diagonal (the diagonal
    block is always included, so ``window=0`` is block-diagonal attention).
    ``n_global`` marks the first ``n_global`` block rows/columns fully
    attended (BigBird's global tokens); ``n_random`` adds that many seeded
    random blocks per block row.  ``block_mask`` carries an explicit
    (nb, nb) boolean mask for ``kind="block_mask"`` (a tuple of tuples, so
    the spec stays hashable — it is part of the plan cache's key).
    """

    kind: str
    seq: int
    block: int = 64
    window: int = 1
    causal: bool = False
    n_global: int = 0
    n_random: int = 0
    seed: int = 0
    block_mask: tuple = ()

    def __post_init__(self):
        if self.kind not in PATTERN_KINDS:
            raise ValueError(f"unknown pattern kind {self.kind!r}; "
                             f"expected one of {PATTERN_KINDS}")
        if self.seq < 1:
            raise ValueError(f"seq must be >= 1, got {self.seq}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.n_global < 0 or self.n_random < 0:
            raise ValueError("n_global/n_random must be >= 0")

    @property
    def n_blocks(self) -> int:
        return -(-self.seq // self.block)


def sliding_window(seq: int, window: int, *, block: int = 64,
                   causal: bool = False) -> AttentionSpec:
    """Band attention: each block row attends ``window`` blocks each side of
    the diagonal (``causal=True`` keeps only the past side, trimmed to the
    token-level lower triangle)."""
    return AttentionSpec("sliding_window", seq, block=block, window=window,
                         causal=causal)


def bigbird(seq: int, window: int, n_global: int, n_random: int, *,
            block: int = 64, seed: int = 0,
            causal: bool = False) -> AttentionSpec:
    """BigBird-style pattern: sliding window + ``n_global`` global block
    rows/cols + ``n_random`` seeded random blocks per block row."""
    return AttentionSpec("bigbird", seq, block=block, window=window,
                         causal=causal, n_global=n_global,
                         n_random=n_random, seed=seed)


def dense_attention(seq: int, *, block: int = 64,
                    causal: bool = False) -> AttentionSpec:
    """Dense fallback: every block active (causal trims the upper
    triangle)."""
    return AttentionSpec("dense", seq, block=block, window=0, causal=causal)


def from_block_mask(block_mask, seq: int, *, block: int = 64,
                    causal: bool = False) -> AttentionSpec:
    """Wrap an explicit (nb, nb) boolean block mask as a spec (hashable)."""
    bm = np.asarray(block_mask, dtype=bool)
    nb = -(-seq // block)
    if bm.shape != (nb, nb):
        raise ValueError(f"block_mask shape {bm.shape} != ({nb}, {nb}) "
                         f"for seq={seq}, block={block}")
    return AttentionSpec("block_mask", seq, block=block, causal=causal,
                         block_mask=tuple(tuple(bool(x) for x in row)
                                          for row in bm))


# ---------------------------------------------------------------------------
# mask compilation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionMask:
    """A compiled pattern: the (nb, nb) boolean block mask, the exact
    token-granularity CSR the planner consumes, and block-level stats."""

    spec: AttentionSpec
    csr: CSR
    block_mask: np.ndarray          # (nb, nb) bool
    nnz_blocks: int
    stats: dict                     # blocks/row mean, cv, density

    @property
    def seq(self) -> int:
        return self.spec.seq


def _block_mask(spec: AttentionSpec) -> np.ndarray:
    nb = spec.n_blocks
    if spec.kind == "block_mask":
        bm = np.array(spec.block_mask, dtype=bool)
    elif spec.kind == "dense":
        bm = np.ones((nb, nb), dtype=bool)
    else:  # sliding_window / bigbird share the band core
        i = np.arange(nb)[:, None]
        j = np.arange(nb)[None, :]
        d = j - i
        lo = -spec.window
        hi = 0 if spec.causal else spec.window
        bm = (d >= lo) & (d <= hi)
        if spec.kind == "bigbird":
            g = min(spec.n_global, nb)
            bm[:g, :] = True
            bm[:, :g] = True
            if spec.n_random:
                # the reference's draws, row by row: sample without
                # replacement among the still-inactive blocks of the row
                # (past-only when causal)
                rng = np.random.default_rng(spec.seed)
                for r in range(nb):
                    limit = (r + 1) if spec.causal else nb
                    off = np.flatnonzero(~bm[r, :limit])
                    if off.size:
                        take = min(spec.n_random, off.size)
                        bm[r, rng.choice(off, size=take, replace=False)] = True
    if spec.causal:
        bm &= (np.arange(nb)[:, None] - np.arange(nb)[None, :]) >= 0
    return bm


def _token_csr(spec: AttentionSpec, bm: np.ndarray) -> CSR:
    """Expand the block mask to an exact token-level CSR: entries only where
    query ``i`` < seq, key ``j`` < seq, the covering block is active, and
    (when causal) ``j <= i``.  Column indices within a row are sorted.

    Vectorised per block row (the reference loops over tokens): every query
    of a block row shares that row's sorted key list, and under causality
    query ``i`` keeps its prefix of keys ``<= i``."""
    s, b = spec.seq, spec.block
    counts = np.zeros(s, dtype=np.int64)
    pieces: list[np.ndarray] = []
    for br in range(bm.shape[0]):
        q = np.arange(br * b, min((br + 1) * b, s))
        jb = np.flatnonzero(bm[br])
        keys = (jb[:, None] * b + np.arange(b)[None, :]).ravel()
        keys = keys[keys < s]
        if spec.causal:
            keep = keys[None, :] <= q[:, None]
        else:
            keep = np.ones((q.size, keys.size), dtype=bool)
        counts[q] = keep.sum(axis=1)
        pieces.append(np.broadcast_to(keys, keep.shape)[keep])
    indptr = np.zeros(s + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    indices = (np.concatenate(pieces).astype(np.int32) if pieces
               else np.zeros(0, np.int32))
    data = np.ones(indices.shape[0], dtype=np.float32)
    return _csr(indptr, indices, data, (s, s), "cpu")


def build_mask(spec: AttentionSpec) -> AttentionMask:
    """Compile a spec into its block mask + token CSR + block stats."""
    bm = _block_mask(spec)
    if not bm.any():
        raise ValueError(f"spec {spec.kind!r} produced an empty mask "
                         f"(seq={spec.seq}, block={spec.block})")
    blocks_per_row = bm.sum(axis=1).astype(np.float64)
    mean = float(blocks_per_row.mean())
    cv = float(blocks_per_row.std() / mean) if mean > 0 else 0.0
    stats = {
        "n_blocks": int(spec.n_blocks),
        "nnz_blocks": int(bm.sum()),
        "blocks_per_row_mean": mean,
        "blocks_per_row_cv": cv,
        "block_density": float(bm.mean()),
    }
    return AttentionMask(spec=spec, csr=_token_csr(spec, bm), block_mask=bm,
                         nnz_blocks=int(bm.sum()), stats=stats)


# ---------------------------------------------------------------------------
# closed forms (test oracles)
# ---------------------------------------------------------------------------

def expected_band_blocks(nb: int, window: int, *, causal: bool = False) -> int:
    """Closed-form active-block count of a (possibly causal) sliding-window
    band on an ``nb x nb`` block grid with ``window`` blocks per side."""
    w = min(window, nb - 1)
    if causal:
        # full rows have w+1 blocks; the first w rows are truncated
        return nb * (w + 1) - w * (w + 1) // 2
    return nb * (2 * w + 1) - w * (w + 1)
