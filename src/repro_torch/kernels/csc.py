"""K3 — row-split SpMM on the ELL substrate, on Hopper; counterpart of
``repro.kernels.csc``.

``spmm_csc`` replaces the TPU kernel ``src/repro/kernels/csc.py::_csc_kernel``:
``Y = A·X`` over ELL ``(M, W)`` cols/vals, sums in f32, result cast to
``x.dtype``.  On the TPU one binary served both row-split logical kernels;
here each has its own design in ``repro_torch/csrc/csc.cu``:

* bound — bytes: 8 B of ELL per stored entry and 4 B of ``lens`` per row,
  against 2·N flops; a one-pass kernel also gathers one row of X per
  stored entry (nnz·N·sizeof(X) bytes), which only L2 hits keep off
  device memory;
* ``"sr"`` (``rs_sr``, the paper's CSC): a group of lanes owns a row, a
  lane 4 adjacent columns gathered with one 16-byte load per stored entry;
  the row's (col, val) pairs are staged once in shared memory by
  coalesced loads, and 8 gathers are in flight per lane.  An X more than
  eight times the L2 is cut into column slabs of 128 bytes a row, one
  slab after another (``sr_lanes``);
* ``"pr"`` (``rs_pr``, the paper's parallel reduction, N ≤ 4): a group of
  8–32 lanes splits a row's stored entries, each lane gathers whole X rows
  (4 columns a column block), and the group reduces by shuffles.

Both walk only the stored slots (``ELL.lens``) and add ``0·X[0, :]`` once
for a row shorter than the width, which is what its padding slots add: an
inf or NaN in X's row 0 reaches the rows the plain version sends it to.
Each output is written once, without atomics: the result is deterministic.
``DESIGN_LAUNCHES`` counts each design's launches.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..core.formats import ELL
from ..core.selector import SelectorThresholds

from . import _build, _common

#: launches of the K3 kernels since process start (or the last reset)
LAUNCHES = {"csc_spmm": 0}
#: K3's launches by design: "sr" (lane groups own columns) or "pr" (lane
#: groups split a row's entries)
DESIGN_LAUNCHES = {"csc_spmm": {"sr": 0, "pr": 0}}

#: columns of X a lane of the sr design owns (one 16-byte f32 load)
LANE_COLS = 4
#: the card's L2 (H100: 50 MB); an X more than ``SLAB_MIN_X_L2`` times
#: larger takes the sr design in column slabs of ``SLAB_ROW_BYTES`` of each
#: X row, one slab after another (``tools/time_csc.py``: faster than one
#: pass for a 512 MB X, K = 2^20 and N = 128 in f32; slower for a 256 MB
#: one, the same in bf16)
L2_BYTES = 50 * 2**20
SLAB_MIN_X_L2 = 8
SLAB_ROW_BYTES = 128


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


def spmm_csc_stored_plain(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """The kernels' order of work in PyTorch: each row's stored slots in
    order, then one ``0·X[0, :]`` where the row is shorter than the width.
    Equal to ``spmm_csc_plain``, non-finite X included."""
    x2 = x[:, None] if x.ndim == 1 else x
    y = torch.zeros((ell.shape[0], x2.shape[1]), dtype=torch.float32,
                    device=x2.device)
    lens = ell.lens.long()
    for j in range(ell.width):
        rows = torch.nonzero(lens > j)[:, 0]
        y.index_add_(0, rows, ell.vals[rows, j, None].float()
                     * x2.index_select(0, ell.cols[rows, j]).float())
    short = torch.nonzero(lens < ell.width)[:, 0]
    y.index_add_(0, short, 0.0 * x2[:1].float().expand(len(short), -1))
    y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def sr_lanes(n: int, k: int = 0, itemsize: int = 4) -> int:
    """Lanes of a row in the sr design: the power of two whose
    ``LANE_COLS``-column pieces cover N, at most a warp (128 columns a
    column block); for a (K, N) X of ``itemsize`` bytes an element more
    than ``SLAB_MIN_X_L2`` L2s large, at most ``SLAB_ROW_BYTES`` of a row
    (the column-slab order)."""
    g = 1
    while g < 32 and g * LANE_COLS < n:
        g *= 2
    if k * n * itemsize > SLAB_MIN_X_L2 * L2_BYTES:
        g = min(g, SLAB_ROW_BYTES // (LANE_COLS * itemsize))
    return g


def pr_group(ell: ELL) -> int:
    """Lanes that split a row in the pr design: the power of two at or above
    the mean stored row length, within 8–32.  Reads ``lens`` (one device
    sync); a plan computes it once, in its prep hook."""
    m = ell.lens.numel()
    mean = float(ell.lens.sum()) / m if m else 0.0
    p = 8
    while p < 32 and p < mean:
        p *= 2
    return p


def _design(n: int) -> str:
    """The routing rule of a call that names no design: ``"pr"`` up to the
    selector's default ``n_threshold``, as a plan would pick, else ``"sr"``."""
    return "pr" if n <= SelectorThresholds.n_threshold else "sr"


def _check(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """Raise ``ValueError`` unless the K3 kernels take these operands;
    returns X as ``(K, N)``."""
    x2 = x[:, None] if x.ndim == 1 else x
    _common.check_operands("csc_spmm", (ell.cols,), ell.vals, x2)
    m, k = ell.shape
    if x2.shape[0] != k:
        raise ValueError(f"csc_spmm: x has {x2.shape[0]} rows, A has {k} columns")
    lens = ell.lens
    if lens.dtype != torch.int32 or lens.shape != (m,) or not lens.is_contiguous():
        raise ValueError("csc_spmm: lens must be contiguous int32 of shape "
                         f"({m},), got {lens.dtype} {tuple(lens.shape)}")
    if -(-x2.shape[1] // LANE_COLS) > 65535:
        raise ValueError(f"csc_spmm: N={x2.shape[1]} exceeds the launch grid")
    return x2


def _launch(design: str, ell: ELL, x2: torch.Tensor, *,
            lanes: int | None = None) -> torch.Tensor:
    """Launch ``design`` on checked operands into an ``(M, N)`` f32 ``Y``.
    ``lanes`` is the sr design's lanes a row (default ``sr_lanes``; fewer
    lanes make narrower column slabs) or the pr design's group (default
    ``pr_group(ell)``)."""
    if design == "sr":
        if lanes is None:
            lanes = sr_lanes(x2.shape[1], x2.shape[0], x2.element_size())
        fn = _build.lib().repro_csc_sr
    elif design == "pr":
        lanes = pr_group(ell) if lanes is None else lanes
        fn = _build.lib().repro_csc_pr
    else:
        raise ValueError(f"csc_spmm: unknown design {design!r}")
    m, n = ell.shape[0], x2.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if y.numel():
        err = fn(ell.cols.data_ptr(), ell.vals.data_ptr(),
                 _common.is_bf16(ell.vals), ell.lens.data_ptr(),
                 x2.data_ptr(), _common.is_bf16(x2), y.data_ptr(), m,
                 ell.width, n, lanes, _common.stream_of(x2))
        _build.check(err, "csc_spmm")
        LAUNCHES["csc_spmm"] += 1
        DESIGN_LAUNCHES["csc_spmm"][design] += 1
    return y


def reset_counts() -> None:
    """Set ``DESIGN_LAUNCHES`` to 0 (``reset_launch_counts`` calls it)."""
    for counts in DESIGN_LAUNCHES.values():
        counts.update(dict.fromkeys(counts, 0))


def spmm_csc(ell: ELL, x: torch.Tensor, design: str | None = None, *,
             group: int | None = None) -> torch.Tensor:
    """K3: ``Y = A·X`` on the ELL substrate.  CPU operands take the plain
    version; CUDA operands launch ``design`` (``None``: by N, as the
    selector would) or raise.  ``group`` is the pr design's lanes a row (a
    plan passes the one its prep hook chose)."""
    if _common.on_cpu("csc_spmm", ell.cols, ell.vals, ell.lens, x):
        return spmm_csc_plain(ell, x)
    x2 = _check(ell, x)
    design = _design(x2.shape[1]) if design is None else design
    y = _launch(design, ell, x2, lanes=group if design == "pr" else None)
    y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def _prep_pr(ell: ELL) -> dict:
    """The pr design's group for this matrix, chosen once a plan."""
    return {"group": pr_group(ell)}


def _hopper_sr(ell: ELL, x: torch.Tensor):
    return spmm_csc(ell, x.contiguous(), "sr")


def _hopper_pr(ell: ELL, x: torch.Tensor, *, group: int | None = None):
    return spmm_csc(ell, x.contiguous(), "pr", group=group)


registry.register("rs_sr", "hopper", "ell", _hopper_sr)
registry.register("rs_pr", "hopper", "ell", _hopper_pr, prep=_prep_pr)
