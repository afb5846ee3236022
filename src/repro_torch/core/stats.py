"""Low-cost sparse-matrix statistics driving the adaptive selector (paper
§2.2); counterpart of ``repro.core.stats``.

The selection rules read ``avg_row``, ``stdv_row`` and ``cv = stdv_row /
avg_row``, all O(M) over the indptr: no pass over the nonzeros is needed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .formats import CSR, host


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    m: int
    k: int
    nnz: int
    avg_row: float      # mean nonzeros per row
    stdv_row: float     # std of nonzeros per row
    cv: float           # stdv_row / avg_row (0 if avg_row == 0)
    max_row: int
    empty_rows: int
    density: float


def balanced_tile_span(csr: CSR, tile: int) -> int:
    """Max rows any fixed-``tile`` nnz quota spans, from the indptr alone
    (no substrate build).  Empty-row gaps inflate it without adding work."""
    indptr = host(csr.indptr)
    m = csr.shape[0]
    nnz = int(indptr[-1]) if len(indptr) else 0
    if nnz == 0 or m == 0:
        return 1
    # row of nnz index i == searchsorted(indptr, i, "right") - 1, resolved
    # only at the O(nnz/tile) tile-boundary offsets
    starts = np.arange(0, nnz, max(1, tile), dtype=np.int64)
    ends = np.minimum(starts + tile, nnz) - 1
    row_of = lambda idx: np.searchsorted(indptr, idx, side="right") - 1  # noqa: E731
    return int((row_of(ends) - row_of(starts) + 1).max())


def matrix_stats(csr: CSR) -> MatrixStats:
    indptr = host(csr.indptr)
    lens = np.diff(indptr).astype(np.float64)
    m, k = csr.shape
    nnz = int(indptr[-1])
    avg = float(lens.mean()) if m else 0.0
    std = float(lens.std()) if m else 0.0
    return MatrixStats(
        m=m,
        k=k,
        nnz=nnz,
        avg_row=avg,
        stdv_row=std,
        cv=(std / avg) if avg > 0 else 0.0,
        max_row=int(lens.max()) if m else 0,
        empty_rows=int((lens == 0).sum()),
        density=nnz / float(max(m * k, 1)),
    )
