"""K2 — VSR SpMV (N = 1) on Hopper; counterpart of ``repro.kernels.spmv``.

``spmv_vsr_fused`` replaces the TPU kernel
``src/repro/kernels/spmv.py::_spmv_fused_kernel``: ``y = A·x`` over the
BalancedCOO slabs by the paper's segmented scan, sums in f32, result cast to
``x.dtype``.  Its CUDA source is ``repro_torch/csrc/spmv.cu``:

* bound — bytes: 12 B of substrate and one gathered element of x per
  nonzero, against 2 flops;
* design — one warp per tile (equal nonzeros per warp); each 32-nonzero
  chunk runs a ``__shfl_up_sync`` segmented inclusive scan keyed on row id
  (Fig. 2(e)); the run reaching lane 31 carries into the next chunk, and
  each run's end adds its sum into a zeroed y with ``atomicAdd``.
"""
from __future__ import annotations

import torch

from ..core.formats import BalancedCOO

from . import _build, _common

#: launches of the K2 kernel since process start (or the last reset)
LAUNCHES = {"vsr_spmv": 0}


def spmv_vsr_plain(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    """K2's plain PyTorch version: products, one f32 segment sum."""
    m = bal.shape[0]
    p = bal.vals.reshape(-1).float() * x.index_select(0, bal.cols.reshape(-1)).float()
    y = torch.zeros(m + 1, dtype=torch.float32, device=x.device)
    y.index_add_(0, bal.rows.reshape(-1), p)
    return y[:m].to(x.dtype)


def spmv_vsr_fused(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    """K2: ``y = A·x`` for ``x`` of shape (K,).  CPU operands take the plain
    version; CUDA operands launch the kernel or raise."""
    if x.ndim != 1:
        raise ValueError(f"vsr_spmv is the N=1 path; x has shape {tuple(x.shape)}")
    if _common.on_cpu("vsr_spmv", bal.rows, bal.cols, bal.vals, x):
        return spmv_vsr_plain(bal, x)
    _common.check_operands("vsr_spmv", (bal.rows, bal.cols), bal.vals, x)
    m, k = bal.shape
    if x.shape[0] != k:
        raise ValueError(f"vsr_spmv: x has {x.shape[0]} rows, A has {k} columns")
    y = torch.zeros(m, dtype=torch.float32, device=x.device)
    if m:
        err = _build.lib().repro_vsr_spmv(
            bal.rows.data_ptr(), bal.cols.data_ptr(), bal.vals.data_ptr(),
            _common.is_bf16(bal.vals), x.data_ptr(), _common.is_bf16(x),
            y.data_ptr(), bal.n_tiles, bal.tile, m, _common.stream_of(x))
        _build.check(err, "vsr_spmv")
        LAUNCHES["vsr_spmv"] += 1
    return y.to(x.dtype)
