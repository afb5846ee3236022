"""K1 — nnz-balanced (VSR) SpMM on Hopper, and the host-side prep of the
reference's VSR kernels; counterpart of ``repro.kernels.vsr``.

``spmm_vsr_fused`` replaces the TPU kernel
``src/repro/kernels/vsr.py::_vsr_fused_kernel``: ``Y = A·X`` over the
BalancedCOO slabs, padding rows (``rows == M``) dropped, sums in f32, result
cast to ``x.dtype``.  Its CUDA source is ``repro_torch/csrc/vsr.cu``:

* bound — bytes: per nonzero 12 B of substrate plus one gathered dense row of
  X, against 2·N flops;
* design — one CTA per (tile, column block), the paper's equal work per
  warp; the tile is staged in shared memory; lane groups walk runs of
  nonzeros while lanes own dense columns (one coalesced X-row load, the
  paper's VDL); row sums flush with ``atomicAdd`` into a zeroed Y, the
  paper's boundary resolution.  The TPU's visit schedule and one-hot MXU
  matmul are not needed: CTAs run concurrently.

``plan_windows`` / ``plan_visits`` are the reference's host-side prep of the
spill and fused TPU paths (the spill kernels are still to be ported); they
return the reference's arrays element for element.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core import registry
from ..core.formats import BalancedCOO, host
from ..core.selector import HOPPER_MAX_TILE, TileGeometry

from . import _build, _common

#: launches of the K1 kernel since process start (or the last reset)
LAUNCHES = {"vsr_spmm": 0}


def plan_windows(bal: BalancedCOO, *, max_win: int | None = None
                 ) -> tuple[np.ndarray, int]:
    """Per-tile first row (``row_base``) and the largest row window ``WIN``
    any tile spans, padded to a multiple of 8 — the spill path's prep.
    Sentinel entries do not count; ``max_win`` warns on a pathological
    span."""
    rows = host(bal.rows)
    m = bal.shape[0]
    valid = rows < m
    any_valid = valid.any(axis=1)
    first = np.where(any_valid, rows[:, 0], m).astype(np.int32)
    last = np.where(any_valid, np.where(valid, rows, -1).max(axis=1), 0)
    span = int(np.maximum(last - first + 1, 1).max()) if len(rows) else 1
    win = -(-span // 8) * 8
    if max_win is not None and win > max_win:
        warnings.warn(
            f"VSR spill window {win} exceeds max_win={max_win} (one tile "
            f"spans {span} rows — likely an empty-row gap)", stacklevel=2)
    return first, win


def plan_visits(bal: BalancedCOO, wb: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (tile, output-block) visit schedule of the TPU fused path:
    ``(visit_tile, visit_block, visit_start)``, each ``(V,)`` int32, with
    ``visit_block`` non-decreasing, one visit per (tile, ``wb``-row block) a
    tile touches, and a dummy visit (borrowing its neighbour's tile) for
    every block no tile touches."""
    rows = host(bal.rows)
    m = bal.shape[0]
    mb = max(1, -(-m // wb))
    n_tiles, t = rows.shape
    tids = np.repeat(np.arange(n_tiles, dtype=np.int64), t)
    rf = rows.reshape(-1)
    valid = rf < m
    keys = np.unique(tids[valid] * mb + rf[valid] // wb)
    vt = (keys // mb).astype(np.int32)
    vb = (keys % mb).astype(np.int32)
    covered = np.zeros(mb, bool)
    covered[vb] = True
    missing = np.nonzero(~covered)[0].astype(np.int32)
    if len(missing):
        vt = np.concatenate([vt, np.zeros(len(missing), np.int32)])
        vb = np.concatenate([vb, missing])
        dummy = np.concatenate([np.zeros(len(vt) - len(missing), bool),
                                np.ones(len(missing), bool)])
        order = np.argsort(vb, kind="stable")
        vt, vb, dummy = vt[order], vb[order], dummy[order]
        real_idx = np.nonzero(~dummy)[0]
        if len(real_idx):
            pos = np.searchsorted(real_idx, np.nonzero(dummy)[0])
            pos = np.minimum(pos, len(real_idx) - 1)
            vt[dummy] = vt[real_idx[pos]]
    vs = np.ones(len(vb), np.int32)
    if len(vb) > 1:
        vs[1:] = (vb[1:] != vb[:-1]).astype(np.int32)
    return vt, vb, vs


def spmm_vsr_plain(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    """K1's plain PyTorch version: every product, one f32 segment sum."""
    x2 = x[:, None] if x.ndim == 1 else x
    m = bal.shape[0]
    p = (bal.vals.reshape(-1, 1).float()
         * x2.index_select(0, bal.cols.reshape(-1)).float())
    y = torch.zeros((m + 1, x2.shape[1]), dtype=torch.float32, device=x2.device)
    y.index_add_(0, bal.rows.reshape(-1), p)
    y = y[:m].to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def spmm_vsr_fused(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    """K1: ``Y = A·X`` over the BalancedCOO slabs.  CPU operands take the
    plain version; CUDA operands launch the kernel or raise."""
    if _common.on_cpu("vsr_spmm", bal.rows, bal.cols, bal.vals, x):
        return spmm_vsr_plain(bal, x)
    x2 = x[:, None] if x.ndim == 1 else x
    _common.check_operands("vsr_spmm", (bal.rows, bal.cols), bal.vals, x2)
    m, k = bal.shape
    n = x2.shape[1]
    if x2.shape[0] != k:
        raise ValueError(f"vsr_spmm: x has {x2.shape[0]} rows, A has {k} columns")
    if bal.tile > HOPPER_MAX_TILE:
        raise ValueError(f"vsr_spmm: tile {bal.tile} > {HOPPER_MAX_TILE} "
                         "does not fit the kernel's shared-memory staging")
    if -(-n // 128) > 65535:
        raise ValueError(f"vsr_spmm: N={n} exceeds the launch grid")
    y = torch.zeros((m, n), dtype=torch.float32, device=x2.device)
    if y.numel():
        err = _build.lib().repro_vsr_spmm(
            bal.rows.data_ptr(), bal.cols.data_ptr(), bal.vals.data_ptr(),
            _common.is_bf16(bal.vals), x2.data_ptr(), _common.is_bf16(x2),
            y.data_ptr(), bal.n_tiles, bal.tile, m, n, _common.stream_of(x2))
        _build.check(err, "vsr_spmm")
        LAUNCHES["vsr_spmm"] += 1
    y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


# ---------------------------------------------------------------------------
# registry: the Hopper kernels of the nnz-balanced logical pair.  nb_sr and
# nb_pr share K1; x of shape (K,) takes K2, as in the reference's _pallas_nb.
# ---------------------------------------------------------------------------

def _prep_windows(bal: BalancedCOO, *,
                  geometry: TileGeometry | None = None) -> dict:
    """Prep hook of the Hopper NB entries.  The reference's hook builds the
    TPU row windows and visit schedule; the Hopper kernels need neither and
    size nothing by a tile's row span (so ``max_win`` is not taken).  What
    is left is to check the plan's geometry against the Hopper rules at plan
    time; the kernels take no per-matrix opts."""
    (geometry or TileGeometry()).validate("hopper")
    return {}


def _hopper_nb(bal: BalancedCOO, x: torch.Tensor):
    x = x.contiguous()
    if x.ndim == 1:
        from .spmv import spmv_vsr_fused
        return spmv_vsr_fused(bal, x)
    return spmm_vsr_fused(bal, x)


registry.register("nb_pr", "hopper", "balanced", _hopper_nb, prep=_prep_windows)
registry.register("nb_sr", "hopper", "balanced", _hopper_nb, prep=_prep_windows)
