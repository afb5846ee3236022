"""K3 — CSC row-split SpMM on the ELL substrate, on Hopper; counterpart of
``repro.kernels.csc``.

``spmm_csc`` replaces the TPU kernel ``src/repro/kernels/csc.py::_csc_kernel``:
``Y = A·X`` over ELL ``(M, W)`` cols/vals, sums in f32, result cast to
``x.dtype``.  Its CUDA source is ``repro_torch/csrc/csc.cu``:

* bound — bytes: 8 B of ELL per stored slot (padding included) plus one
  gathered dense row of X per slot, against 2·N flops;
* design — the paper's §2.1.3: a CTA owns TM whole rows and a block of
  dense columns, stages its rows' (TM, TW) cols/vals slab in shared memory
  with coalesced loads, and each thread walks the cached slab for one
  (row, column) pair.  The width loop stays in the CTA, so each output is
  written once, without atomics: the result is deterministic.  One kernel
  serves rs_sr and rs_pr.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..core.formats import ELL

from . import _build, _common

#: launches of the K3 kernel since process start (or the last reset)
LAUNCHES = {"csc_spmm": 0}


def spmm_csc_plain(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """K3's plain PyTorch version: the sequential walk over the width, one
    gathered (M, N) slab per ELL column, f32 sums."""
    x2 = x[:, None] if x.ndim == 1 else x
    y = torch.zeros((ell.shape[0], x2.shape[1]), dtype=torch.float32,
                    device=x2.device)
    for j in range(ell.width):
        y += ell.vals[:, j, None].float() * x2.index_select(0, ell.cols[:, j]).float()
    y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def spmm_csc(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """K3: ``Y = A·X`` on the ELL substrate.  CPU operands take the plain
    version; CUDA operands launch the kernel or raise."""
    if _common.on_cpu("csc_spmm", ell.cols, ell.vals, x):
        return spmm_csc_plain(ell, x)
    x2 = x[:, None] if x.ndim == 1 else x
    _common.check_operands("csc_spmm", (ell.cols,), ell.vals, x2)
    m, k = ell.shape
    n = x2.shape[1]
    if x2.shape[0] != k:
        raise ValueError(f"csc_spmm: x has {x2.shape[0]} rows, A has {k} columns")
    if -(-n // 128) > 65535:
        raise ValueError(f"csc_spmm: N={n} exceeds the launch grid")
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if y.numel():
        err = _build.lib().repro_csc_spmm(
            ell.cols.data_ptr(), ell.vals.data_ptr(), _common.is_bf16(ell.vals),
            x2.data_ptr(), _common.is_bf16(x2), y.data_ptr(), m, ell.width, n,
            _common.stream_of(x2))
        _build.check(err, "csc_spmm")
        LAUNCHES["csc_spmm"] += 1
    y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def _hopper_rs(ell: ELL, x: torch.Tensor):
    return spmm_csc(ell, x.contiguous())


registry.register("rs_sr", "hopper", "ell", _hopper_rs)
registry.register("rs_pr", "hopper", "ell", _hopper_rs)
