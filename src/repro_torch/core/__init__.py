"""Host-side core of the port: formats, statistics, selector, registry, the
``"torch"`` backend, the plan cache and plan/execute."""
from .formats import (BSR, BUILD_COUNTS, CSR, ELL, BalancedCOO, bsr_to_dense,
                      csr_from_coo, csr_from_dense, csr_to_balanced,
                      csr_to_bsr, csr_to_ell, reset_build_counts,
                      row_ids_from_indptr)
from .rmat import rmat, rmat_suite_small
from .selector import (SelectorThresholds, TileGeometry, default_thresholds,
                       load_thresholds, save_thresholds, select_kernel)
from .stats import MatrixStats, balanced_tile_span, matrix_stats
