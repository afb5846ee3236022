"""Host-side core of the port: formats, statistics, selector and its
calibration, the registry, the ``"torch"`` backend, the plan cache and
plan / finalize / execute.  Unlike the reference's package, this one does
not re-export the ``plan()`` function: ``repro_torch.core.plan`` stays the
module (``repro_torch.core.plan.plan``, or ``repro_torch.api.sparse``)."""
from .formats import (BSR, BUILD_COUNTS, CSR, ELL, BalancedCOO, bsr_to_dense,
                      csr_from_coo, csr_from_dense, csr_to_balanced,
                      csr_to_bsr, csr_to_ell, reset_build_counts,
                      row_ids_from_indptr)
from .plan import PlanArtifact, PlanBuilder, PlanMeta, SparsePlan, execute
from .registry import MATMUL_KERNELS, backends_for
from .rmat import rmat, rmat_suite, rmat_suite_small
from .selector import (PreparedMatrix, SelectorThresholds, TileGeometry,
                       adaptive_spmm, calibrate, default_thresholds,
                       load_thresholds, save_thresholds, select_kernel,
                       select_partition)
from .stats import MatrixStats, balanced_tile_span, matrix_stats
from .shard import ShardSpec, make_shard_spec
from .spmm import spmm_nb_pr_trainable
