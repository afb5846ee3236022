"""R-MAT recursive matrix generator (Chakrabarti et al., SDM'04); counterpart
of ``repro.core.rmat``.

Each edge drops into a quadrant recursively with probabilities (a, b, c, d);
(0.57, 0.19, 0.19) is the Graph500 Kronecker setting (heavily skewed rows),
(0.25, 0.25, 0.25) is Erdos-Renyi-like.  The numpy draws are made in the
same order as the reference generator's, so one seed gives the identical
CSR in both packages.  Host-side numpy; the CSR is then moved to ``device``.
"""
from __future__ import annotations

import numpy as np

from .formats import CSR, csr_from_coo


def rmat(
    scale: int,
    edge_factor: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    m: int | None = None,
    k: int | None = None,
    *,
    device="cpu",
) -> CSR:
    """Generate an R-MAT sparse matrix of ``edge_factor * m`` edges
    (duplicates summed).

    scale        log2 of the (square) dimension.
    edge_factor  average nonzeros per row.
    a,b,c        quadrant probabilities (d = 1-a-b-c).
    m, k         optional rectangular crop of the 2^scale square.
    """
    n = 1 << scale
    m = n if m is None else m
    k = n if k is None else k
    nnz = edge_factor * m
    if 1.0 - a - b - c < -1e-9 or min(a, b, c) < 0:
        raise ValueError(f"quadrant probabilities must be >= 0 and sum to "
                         f"<= 1, got a={a}, b={b}, c={c}")
    rng = np.random.default_rng(seed)

    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for _ in range(scale):
        r = rng.random(nnz)
        # quadrant 0=a (0,0), 1=b (0,1), 2=c (1,0), 3=d (1,1): the count of
        # cumulative edges r passes (the reference's np.select, vectorised)
        quad = (r >= a).astype(np.int64) + (r >= a + b) + (r >= a + b + c)
        rows = (rows << 1) | (quad >> 1)
        cols = (cols << 1) | (quad & 1)
    keep = (rows < m) & (cols < k)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return csr_from_coo(rows, cols, vals, (m, k), device=device)


def rmat_suite(seed: int = 0, *, device="cpu") -> dict[str, CSR]:
    """The paper's 27-matrix micro-benchmark (§2.1.2-§2.1.3): scales 10, 12
    and 14 x edge factors 4, 16 and 64 x three skews, seeds counted up
    from ``seed`` in the reference's order, so each matrix is the
    reference's element for element."""
    suite: dict[str, CSR] = {}
    skews = {"uniform": (0.25, 0.25, 0.25), "mild": (0.45, 0.22, 0.22),
             "skewed": (0.57, 0.19, 0.19)}
    for scale in (10, 12, 14):
        for ef in (4, 16, 64):
            for skew_name, (a, b, c) in skews.items():
                name = f"rmat_s{scale}_e{ef}_{skew_name}"
                suite[name] = rmat(scale, ef, a, b, c, seed=seed, device=device)
                seed += 1
    return suite


def rmat_suite_small(seed: int = 0, *, device="cpu") -> dict[str, CSR]:
    """Reduced R-MAT suite for CI-speed tests (2 scales x 2 edge factors x
    2 skews)."""
    suite: dict[str, CSR] = {}
    skews = {"uniform": (0.25, 0.25, 0.25), "skewed": (0.57, 0.19, 0.19)}
    for scale in (6, 8):
        for ef in (4, 16):
            for skew_name, (a, b, c) in skews.items():
                name = f"rmat_s{scale}_e{ef}_{skew_name}"
                suite[name] = rmat(scale, ef, a, b, c, seed=seed, device=device)
                seed += 1
    return suite
