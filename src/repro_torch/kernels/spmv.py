"""K2 and K5 — VSR SpMV (N = 1) on Hopper; counterpart of
``repro.kernels.spmv``.

``spmv_vsr_fused`` replaces the TPU kernel
``src/repro/kernels/spmv.py::_spmv_fused_kernel``: ``y = A·x`` over the
BalancedCOO slabs by the paper's segmented scan, sums in f32, result cast to
``x.dtype``.  Its CUDA source is ``repro_torch/csrc/spmv.cu``, whose warp
kernel also serves K1's pr design:

* bound — bytes: 12 B of substrate and one gathered element of x per
  nonzero, against 2 flops;
* design — one warp per tile (equal nonzeros per warp); a lane takes 4
  adjacent slots of a 128-slot step by 16-byte loads (the next step's
  issued first) and gathers x at its 4 columns before any arithmetic; runs
  keyed on the row, summed in the lane and then by one ``__shfl_up_sync``
  segmented scan across the warp (Fig. 2(e)); a run no other tile adds to
  is stored, the tile's first and last runs add into a zeroed y by
  ``atomicAdd`` (so the slab's rows must be non-decreasing).

``spmv_vsr`` is the spill-and-combine variant (the parity reference): K5
replaces ``src/repro/kernels/spmv.py::_spmv_kernel`` (same source file) and
stores each run's sum into the tile's ``(WIN,)`` window of an ``(n_tiles,
WIN)`` partials buffer at the clamped ``row - row_base``; the combine is
``vsr.spill_combine``.  Bound: K2's bytes plus 4·WIN B of partials a tile.
Design: K2's, with runs keyed on the clamped window row and each window
entry written once, untouched rows as 0.

Quantized value slabs (the TPU kernels' quant branches, ``spmv.py:134-143``
and ``:38-46``): K2 and K5 also take int8 or ``float8_e4m3fn`` codes with
``scales``, one f32 scale a tile; a lane reads its 4 codes by one 4-byte
load and multiplies them by its warp's tile scale.  The plain versions
decode first.  ``VALUE_LAUNCHES`` counts each kernel's launches by value
type.
"""
from __future__ import annotations

import torch

from ..core.formats import BalancedCOO

from . import _build, _common
from .vsr import (VALUE_KINDS, SpillWindows, _combine, _given_or_planned,
                  decoded, spill_combine_plain, spill_partials_plain)

#: launches of the K2 and K5 kernels since process start (or the last reset)
LAUNCHES = {"vsr_spmv": 0, "vsr_spmv_spill": 0}
#: K2's and K5's launches by the value type of the slab they read
VALUE_LAUNCHES = {k: dict.fromkeys(VALUE_KINDS, 0) for k in LAUNCHES}


def reset_counts() -> None:
    """Set ``VALUE_LAUNCHES`` to 0 (``reset_launch_counts`` calls it)."""
    for counts in VALUE_LAUNCHES.values():
        counts.update(dict.fromkeys(counts, 0))


def spmv_vsr_plain(bal: BalancedCOO, x: torch.Tensor,
                   scales: torch.Tensor | None = None) -> torch.Tensor:
    """K2's plain PyTorch version: products, one f32 segment sum (a coded
    slab decoded by ``scales`` first)."""
    bal = decoded(bal, scales)
    m = bal.shape[0]
    p = bal.vals.reshape(-1).float() * x.index_select(0, bal.cols.reshape(-1)).float()
    y = torch.zeros(m + 1, dtype=torch.float32, device=x.device)
    y.index_add_(0, bal.rows.reshape(-1), p)
    return y[:m].to(x.dtype)


def spmv_vsr_fused(bal: BalancedCOO, x: torch.Tensor, *,
                   scales: torch.Tensor | None = None) -> torch.Tensor:
    """K2: ``y = A·x`` for ``x`` of shape (K,); a slab of codes takes its
    per-tile ``scales``.  CPU operands take the plain version; CUDA operands
    launch the kernel or raise."""
    if x.ndim != 1:
        raise ValueError(f"vsr_spmv is the N=1 path; x has shape {tuple(x.shape)}")
    if _common.on_cpu("vsr_spmv", bal.rows, bal.cols, bal.vals, x):
        return spmv_vsr_plain(bal, x, scales)
    _common.check_operands("vsr_spmv", (bal.rows, bal.cols), bal.vals, x,
                           coded=True, scales=scales)
    m, k = bal.shape
    if x.shape[0] != k:
        raise ValueError(f"vsr_spmv: x has {x.shape[0]} rows, A has {k} columns")
    y = torch.zeros(m, dtype=torch.float32, device=x.device)
    if m:
        err = _build.lib().repro_vsr_spmv(
            bal.rows.data_ptr(), bal.cols.data_ptr(), bal.vals.data_ptr(),
            _common.value_code(bal.vals),
            _common.scales_ptr(bal.vals, scales), x.data_ptr(),
            _common.is_bf16(x), y.data_ptr(), bal.n_tiles, bal.tile, m,
            _common.stream_of(x))
        _build.check(err, "vsr_spmv")
        LAUNCHES["vsr_spmv"] += 1
        VALUE_LAUNCHES["vsr_spmv"][_common.value_type(bal.vals)] += 1
    return y.to(x.dtype)


def spmv_vsr_partials(bal: BalancedCOO, x: torch.Tensor,
                      row_base: torch.Tensor, win: int, *,
                      scales: torch.Tensor | None = None) -> torch.Tensor:
    """K5 alone: the (n_tiles, WIN) f32 partials of ``x`` (K,); a slab of
    codes takes its per-tile ``scales``.  CPU operands take the plain
    version; CUDA operands launch the kernel or raise."""
    if x.ndim != 1:
        raise ValueError(f"vsr_spmv_spill is the N=1 path; x has shape "
                         f"{tuple(x.shape)}")
    if _common.on_cpu("vsr_spmv_spill", bal.rows, bal.cols, bal.vals, x,
                      row_base):
        return spill_partials_plain(bal, x[:, None], row_base, win,
                                    scales)[..., 0]
    _common.check_operands("vsr_spmv_spill", (bal.rows, bal.cols), bal.vals, x,
                           coded=True, scales=scales)
    m, k = bal.shape
    if x.shape[0] != k:
        raise ValueError(f"vsr_spmv_spill: x has {x.shape[0]} rows, A has "
                         f"{k} columns")
    if (row_base.dtype != torch.int32 or row_base.shape != (bal.n_tiles,)
            or not row_base.is_contiguous() or win < 1):
        raise ValueError("vsr_spmv_spill: row_base must be contiguous int32 "
                         f"({bal.n_tiles},) and win >= 1")
    part = torch.empty((bal.n_tiles, win), dtype=torch.float32, device=x.device)
    if part.numel():
        err = _build.lib().repro_vsr_spmv_spill(
            bal.rows.data_ptr(), bal.cols.data_ptr(), bal.vals.data_ptr(),
            _common.value_code(bal.vals),
            _common.scales_ptr(bal.vals, scales), x.data_ptr(),
            _common.is_bf16(x), row_base.data_ptr(), part.data_ptr(),
            bal.n_tiles, bal.tile, m, win, _common.stream_of(x))
        _build.check(err, "vsr_spmv_spill")
        LAUNCHES["vsr_spmv_spill"] += 1
        VALUE_LAUNCHES["vsr_spmv_spill"][_common.value_type(bal.vals)] += 1
    return part


def spmv_vsr_spill_plain(bal: BalancedCOO, x: torch.Tensor, *,
                         row_base: torch.Tensor | None = None,
                         win: int | None = None,
                         scales: torch.Tensor | None = None) -> torch.Tensor:
    """The spill SpMV's plain PyTorch version: plain partials, then the
    plain combine."""
    if row_base is None or win is None:
        row_base, win = SpillWindows()(bal)
    part = spill_partials_plain(bal, x[:, None], row_base, win, scales)[..., 0]
    return spill_combine_plain(part, row_base, bal.shape[0]).to(x.dtype)


def _spill_spmv(bal: BalancedCOO, x: torch.Tensor, row_base: torch.Tensor,
                win: int, scales: torch.Tensor | None = None) -> torch.Tensor:
    """K5, then the combine, on ordered windows."""
    return _combine(spmv_vsr_partials(bal, x, row_base, win, scales=scales),
                    row_base, bal.shape[0]).to(x.dtype)


def spmv_vsr(bal: BalancedCOO, x: torch.Tensor, *,
             row_base: torch.Tensor | None = None,
             win: int | None = None,
             scales: torch.Tensor | None = None) -> torch.Tensor:
    """NB SpMV, spill and combine (the parity reference): K5's partials,
    then ``vsr.spill_combine``.  ``row_base`` / ``win`` come from
    ``plan_windows`` (computed here when not given; a given ``row_base`` on
    the card must be non-decreasing); ``scales`` decode a slab of codes."""
    return _spill_spmv(bal, x, *_given_or_planned(bal, row_base, win), scales)
