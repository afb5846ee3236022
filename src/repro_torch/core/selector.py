"""Adaptive kernel selection (paper §2.2, Fig. 4) and threshold persistence;
counterpart of ``repro.core.selector``.

Decision tree from three low-cost statistics (avg_row, cv, N):

  1. Insight 1 — N picks the reduction style: parallel reduction for SpMV and
     small-N SpMM (N <= n_threshold), sequential for larger N.
  2. Insight 2 — on the sequential side, workload balancing pays off when
     row lengths are skewed: cv > sr_cv.
  3. Insight 3 — on the parallel side, short rows (avg_row < pr_avg_row) are
     the workload-balancing trigger.

Thresholds are data: the JSON schema (versions 1-5) is the reference
package's, read and written unchanged, so one calibration file serves both
packages.  Its geometry table is keyed by backend, and each entry is
validated under the rules of the backend its key names.  ``calibrate`` fits
the three cutoffs to measured kernel times by grid search (paper §2.2),
scoring a candidate by its geomean slowdown against the fastest kernel
(§3.2, ``slowdown_vs_oracle``).  ``PreparedMatrix`` and ``adaptive_spmm``
are the reference's deprecated front doors, shims over ``api.sparse``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Callable

import numpy as np

from .formats import CSR
from .stats import MatrixStats

#: environment variable naming a calibrated-thresholds JSON file to auto-load
THRESHOLDS_ENV = "REPRO_THRESHOLDS"

#: largest nnz quota a Hopper K1 tile may hold: the kernel stages one tile's
#: rows, cols and f32 vals (12 B each) in the 48 KiB of static shared memory
HOPPER_MAX_TILE = 4096


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """One point of the NB kernels' tuning space.

    ``tile`` is the nnz quota per BalancedCOO tile (the paper's warp quota),
    ``wb`` the TPU fused kernel's output-block row height and ``tile_n`` its
    dense-column block width.  The Hopper kernels read only ``tile`` (one
    CTA or one warp per tile); ``wb`` and ``tile_n`` ride along so the JSON
    shape stays the reference's."""

    tile: int = 512
    wb: int = 64
    tile_n: int = 128

    def validate(self, backend: str = "hopper") -> "TileGeometry":
        """Raise ``ValueError`` unless the geometry suits ``backend``.

        Every backend keeps the reference's TPU alignment rules — wb a
        multiple of 8 (sublanes), tile_n a multiple of 128 (lanes) — so the
        reference reads every file the port writes.  Hopper adds
        tile <= HOPPER_MAX_TILE, for K1's shared-memory staging."""
        if self.tile < 1:
            raise ValueError(f"tile must be >= 1, got {self.tile}")
        if backend == "hopper" and self.tile > HOPPER_MAX_TILE:
            raise ValueError(f"tile must be <= {HOPPER_MAX_TILE} on hopper, "
                             f"got {self.tile}")
        if self.wb < 8 or self.wb % 8:
            raise ValueError(f"wb must be a positive multiple of 8 "
                             f"(sublanes), got {self.wb}")
        if self.tile_n < 128 or self.tile_n % 128:
            raise ValueError(f"tile_n must be a positive multiple of 128 "
                             f"(lanes), got {self.tile_n}")
        return self

    def as_tuple(self) -> tuple:
        return (int(self.tile), int(self.wb), int(self.tile_n))


#: upper edges of the dense-width buckets geometry entries key on
N_BUCKET_EDGES = (1, 4, 32, 128)


def n_bucket(n: "int | None") -> str:
    """Coarse dense-width bucket label for geometry keys (``None`` is the
    wildcard bucket)."""
    if n is None:
        return "any"
    for edge in N_BUCKET_EDGES:
        if n <= edge:
            return f"n{edge}"
    return "nbig"


def geometry_key(backend: str, fingerprint: str, n: "int | None") -> str:
    """Key of one geometry entry: backend x pattern x N-bucket."""
    return f"{backend}|{fingerprint[:12]}|{n_bucket(n)}"


def _key_backend(key: str) -> str:
    return key.split("|", 1)[0]


@dataclasses.dataclass(frozen=True)
class SelectorThresholds:
    n_threshold: int = 4        # N <= this → parallel reduction (paper: 4)
    pr_avg_row: float = 32.0    # PR side: avg_row < this → workload-balance
    sr_cv: float = 0.5          # SR side: cv > this → workload-balance
    # the sharded backend (core/shard.py): cv > partition_cv shards by
    # nonzeros, else by rows (select_partition); psum plans take the
    # overlapped ring from N >= overlap_min_n (kernels/tune.py::
    # autotune_overlap).  Nothing tunes max_win (the spill window's guard)
    partition_cv: float = 1.0
    max_win: int = 4096
    overlap_min_n: int = 512
    # the gates, measured by kernels/tune.py (autotune_quant / _chain /
    # _attention): a coded plan from N >= quant_min_n, the fused chain from
    # N >= chain_fuse_min_n, fused attention from seq >= attn_fuse_min_seq
    quant_min_n: int = 1
    chain_fuse_min_n: int = 1
    attn_fuse_min_seq: int = 1
    # sorted ((geometry_key, (tile, wb, tile_n)), ...) — hashable, so the
    # thresholds can key the plan cache
    geometries: tuple = ()

    # -- geometry table -----------------------------------------------------
    def geometry_for(self, fingerprint: str, n: "int | None",
                     backend: str) -> "TileGeometry | None":
        """The stored geometry for (pattern, N, backend): the exact N-bucket
        first, the wildcard entry second."""
        if not self.geometries:
            return None
        table = dict(self.geometries)
        for key in (geometry_key(backend, fingerprint, n),
                    geometry_key(backend, fingerprint, None)):
            if key in table:
                return TileGeometry(*table[key])
        return None

    def with_geometry(self, key: str, geom: TileGeometry) -> "SelectorThresholds":
        table = dict(self.geometries)
        table[key] = geom.validate(_key_backend(key)).as_tuple()
        return dataclasses.replace(self, geometries=tuple(sorted(table.items())))

    # -- persistence (the reference's DESIGN.md §4 schema) ------------------
    def to_json(self) -> str:
        """Serialise with the lowest schema version that holds every field
        that differs from its default (v1 ⊂ v2 ⊂ ... ⊂ v5)."""
        d = {"version": 1,
             "n_threshold": int(self.n_threshold),
             "pr_avg_row": float(self.pr_avg_row),
             "sr_cv": float(self.sr_cv),
             "partition_cv": float(self.partition_cv)}
        version = 1
        if self.geometries or self.max_win != 4096 or self.overlap_min_n != 512:
            version = 2
        if self.quant_min_n != 1:
            version = 3
        if self.chain_fuse_min_n != 1:
            version = 4
        if self.attn_fuse_min_seq != 1:
            version = 5
        d["version"] = version
        if version >= 2:
            d["max_win"] = int(self.max_win)
            d["overlap_min_n"] = int(self.overlap_min_n)
            d["geometries"] = {k: list(v) for k, v in self.geometries}
        if version >= 3:
            d["quant_min_n"] = int(self.quant_min_n)
        if version >= 4:
            d["chain_fuse_min_n"] = int(self.chain_fuse_min_n)
        if version >= 5:
            d["attn_fuse_min_seq"] = int(self.attn_fuse_min_seq)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SelectorThresholds":
        d = json.loads(text)
        if d.get("version", 1) not in (1, 2, 3, 4, 5):
            raise ValueError(f"unsupported thresholds version {d.get('version')!r}")
        geoms = tuple(sorted((str(k), tuple(int(x) for x in v))
                             for k, v in d.get("geometries", {}).items()))
        th = cls(n_threshold=int(d["n_threshold"]),
                 pr_avg_row=float(d["pr_avg_row"]),
                 sr_cv=float(d["sr_cv"]),
                 partition_cv=float(d.get("partition_cv", 1.0)),
                 max_win=int(d.get("max_win", 4096)),
                 overlap_min_n=int(d.get("overlap_min_n", 512)),
                 quant_min_n=int(d.get("quant_min_n", 1)),
                 chain_fuse_min_n=int(d.get("chain_fuse_min_n", 1)),
                 attn_fuse_min_seq=int(d.get("attn_fuse_min_seq", 1)),
                 geometries=geoms)
        return th.validate()

    def validate(self) -> "SelectorThresholds":
        """Reject nonsensical thresholds (negative cutoffs, NaN/inf) and
        geometries invalid for their backend with ``ValueError``."""
        if self.n_threshold < 0:
            raise ValueError(f"n_threshold must be >= 0, got {self.n_threshold}")
        for name in ("pr_avg_row", "sr_cv", "partition_cv"):
            v = float(getattr(self, name))
            if not np.isfinite(v):
                raise ValueError(f"{name} must be finite, got {v!r}")
            if v < 0:
                raise ValueError(f"{name} must be >= 0, got {v!r}")
        for name in ("max_win", "overlap_min_n", "quant_min_n",
                     "chain_fuse_min_n", "attn_fuse_min_seq"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        for key, vals in self.geometries:
            if len(vals) != 3:
                raise ValueError(f"geometry {key!r} must be (tile, wb, "
                                 f"tile_n), got {vals!r}")
            TileGeometry(*vals).validate(_key_backend(key))
        return self


def save_thresholds(th: SelectorThresholds, path: str) -> None:
    with open(path, "w") as f:
        f.write(th.to_json() + "\n")


def load_thresholds(path: str) -> SelectorThresholds:
    with open(path) as f:
        return SelectorThresholds.from_json(f.read())


def default_thresholds() -> SelectorThresholds:
    """Thresholds from ``$REPRO_THRESHOLDS`` when set and readable, else the
    built-in defaults (a corrupt file warns).  Read per call."""
    path = os.environ.get(THRESHOLDS_ENV)
    if path:
        try:
            return load_thresholds(path)
        except (OSError, ValueError, KeyError) as e:
            warnings.warn(f"could not load thresholds from {path!r}: {e}; "
                          "using the defaults", stacklevel=2)
    return SelectorThresholds()


def select_kernel(stats: MatrixStats, n: int,
                  th: SelectorThresholds = SelectorThresholds()) -> str:
    """Paper Fig. 4: map (sparsity stats, N) to one of the four kernels."""
    if n <= th.n_threshold:
        return "nb_pr" if stats.avg_row < th.pr_avg_row else "rs_pr"
    return "nb_sr" if stats.cv > th.sr_cv else "rs_sr"


def select_partition(stats: MatrixStats,
                     th: SelectorThresholds = SelectorThresholds()) -> str:
    """Partitioner of the sharded backend (DESIGN.md §4.1): the CV rule one
    level up — uniform rows shard by rows (``"row"``), skewed rows by
    nonzeros (``"nnz"``, the BalancedCOO tile split)."""
    return "nnz" if stats.cv > th.partition_cv else "row"


# ---------------------------------------------------------------------------
# deprecated front doors: thin shims over the repro_torch.api facade
# ---------------------------------------------------------------------------

class PreparedMatrix:
    """Deprecated: use ``repro_torch.api.sparse``, which builds substrates
    lazily, per the selected kernel, instead of both eagerly.  Wraps the
    facade's ``SparseMatrix`` so the legacy ``.ell`` / ``.balanced`` /
    ``.stats`` accessors keep working (each builds its substrate on first
    touch)."""

    def __init__(self, matrix):
        from ..api import SparseMatrix
        if not isinstance(matrix, SparseMatrix):  # a bare PlanBuilder
            matrix = SparseMatrix(matrix)
        self._matrix = matrix

    @classmethod
    def from_csr(cls, csr: CSR, tile: int = 512, *,
                 device=None) -> "PreparedMatrix":
        """``device=None`` is the card, as for ``sparse()``."""
        warnings.warn("PreparedMatrix.from_csr is deprecated; use "
                      "repro_torch.api.sparse (lazy substrates, cached plans)",
                      DeprecationWarning, stacklevel=2)
        from ..api import sparse
        return cls(sparse(csr, tile=tile, device=device))

    @property
    def _plan(self):
        return self._matrix.plan

    @property
    def csr(self) -> CSR:
        return self._matrix.plan.csr

    @property
    def stats(self) -> MatrixStats:
        return self._matrix.stats

    @property
    def ell(self):
        return self._matrix.plan.substrate("ell")

    @property
    def balanced(self):
        return self._matrix.plan.substrate("balanced")


def adaptive_spmm(prep, x, th: SelectorThresholds = SelectorThresholds(),
                  impl: str | None = None, *, device=None):
    """Deprecated: ``repro_torch.api.sparse(csr) @ x`` replaces it.
    ``prep`` is a ``PreparedMatrix`` or a CSR (planned on ``device``, the
    card for None); ``impl`` overrides the rule (oracle / ablation mode)."""
    warnings.warn("adaptive_spmm is deprecated; use repro_torch.api.sparse "
                  "(m = sparse(csr); m @ x)", DeprecationWarning, stacklevel=2)
    from ..api import sparse
    m = (prep._matrix if isinstance(prep, PreparedMatrix)
         else sparse(prep, device=device))
    return m.with_thresholds(th).matmul(x, impl=impl)


# ---------------------------------------------------------------------------
# offline calibration (paper §2.2 method, §3.2 metric)
# ---------------------------------------------------------------------------

def slowdown_vs_oracle(stats: dict, ns: tuple, times: dict,
                       th: SelectorThresholds) -> float:
    """The paper's §3.2 loss of ``th``: the geometric mean over (matrix, N)
    of the time of the kernel ``th`` selects over the fastest kernel's.
    ``stats`` maps a matrix name to its ``MatrixStats``, ``times`` a
    ``(name, n, kernel)`` to seconds."""
    from .registry import MATMUL_KERNELS
    ratios = []
    for mname, st in stats.items():
        for n in ns:
            chosen = times[(mname, n, select_kernel(st, n, th))]
            oracle = min(times[(mname, n, k)] for k in MATMUL_KERNELS)
            ratios.append(chosen / oracle)
    return float(np.exp(np.mean(np.log(ratios))))


def calibrate(
    matrices: dict,
    ns: tuple,
    time_fn: "Callable[[str, object, int], float] | None" = None,
    times: dict | None = None,
    # 1 << 30 = "never switch to sequential reduction": the PR/SR crossover
    # of the paper's Insight 1 may not exist on a backend, and the grid may
    # learn that
    n_grid: tuple = (2, 4, 8, 1 << 30),
    avg_grid: tuple = (8.0, 16.0, 32.0, 64.0),
    cv_grid: tuple = (0.25, 0.5, 1.0, 2.0),
    save_to: str | None = None,
) -> tuple[SelectorThresholds, dict]:
    """Re-derive the thresholds for a backend by grid search against
    measured kernel times (paper §2.2): either ``time_fn(kernel_name, plan,
    n) -> seconds`` over ``plan(csr)`` of each matrix, or the precomputed
    ``times[(matrix_name, n, kernel_name)] -> seconds``.

    Returns ``(best thresholds, report)``; the report's
    ``geomean_slowdown_vs_oracle`` is the winner's §3.2 loss
    (``slowdown_vs_oracle``) and ``times`` every measurement, keyed
    ``"name|n=N|kernel"``.  ``save_to`` persists the winner as JSON for
    ``$REPRO_THRESHOLDS``."""
    from .plan import plan
    from .registry import MATMUL_KERNELS

    plans = {k: plan(v) for k, v in matrices.items()}
    if times is None:
        if time_fn is None:
            raise ValueError("calibrate needs time_fn or times")
        times = {}
        for mname, p in plans.items():
            for n in ns:
                for kname in MATMUL_KERNELS:
                    times[(mname, n, kname)] = time_fn(kname, p, n)
    stats = {k: p.stats for k, p in plans.items()}
    best, best_loss = None, np.inf
    for nt in n_grid:
        for ag in avg_grid:
            for cg in cv_grid:
                th = SelectorThresholds(nt, ag, cg)
                loss = slowdown_vs_oracle(stats, ns, times, th)
                if loss < best_loss:
                    best, best_loss = th, loss
    report = {
        "geomean_slowdown_vs_oracle": best_loss,
        "times": {f"{m}|n={n}|{k}": t for (m, n, k), t in times.items()},
    }
    if save_to is not None:
        save_thresholds(best, save_to)
    return best, report
