"""K1 and K4 — nnz-balanced (VSR) SpMM on Hopper, and the host-side prep of
the reference's VSR kernels; counterpart of ``repro.kernels.vsr``.

``spmm_vsr_fused`` replaces the TPU kernel
``src/repro/kernels/vsr.py::_vsr_fused_kernel``: ``Y = A·X`` over the
BalancedCOO slabs, padding rows (``rows == M``) dropped, sums in f32, result
cast to ``x.dtype``.  On the TPU one binary served both nnz-balanced logical
kernels; here each has its own design:

* bound — bytes: per nonzero 12 B of substrate, against 2·N flops; a
  one-pass kernel also gathers one row of X a nonzero, which only L2 hits
  keep off device memory;
* ``"sr"`` (``nb_sr``, ``repro_torch/csrc/vsr.cu``): a CTA stages a tile
  (several at small N) in shared memory by 16-byte evict-first loads; lane
  groups walk equal ranges of its slots, a lane 4 columns of X by one
  16-byte gather a slot, 4 gathers before their FMAs, 4 CTAs an SM; a run
  that crosses ranges is merged in shared memory;
* ``"pr"`` (``nb_pr``, ``repro_torch/csrc/spmv.cu``): K2's warp kernel on
  4-column pieces of X rows — one warp a tile, 4 slots a lane by 16-byte
  loads, a segmented sum over the lane's slots and one shuffle scan across
  the warp a 128-slot step; the column blocks of 4 are the grid's slow
  dimension, so this is the fast path at N <= 4 only.  An X of one column
  takes K2's kernel.

Both write a run that no other tile adds to with a plain store and add a
tile's first and last runs into a zeroed Y by ``atomicAdd``, so they need
the slab's order (rows non-decreasing).  ``DESIGN_LAUNCHES`` counts each
design's launches; a call that names no design is routed by N (``_design``).

``spmm_vsr`` is the spill-and-combine variant, the fused path's parity
reference: K4 replaces ``src/repro/kernels/vsr.py::_vsr_kernel`` (same
source file) and writes each tile's row sums into its ``(WIN, N)`` window of
an ``(n_tiles, WIN, N)`` partials buffer at ``row - row_base`` (clamped to
the window); ``spill_combine`` — the reference's ``segment_sum`` outside the
kernel — adds the windows, on the card by a kernel of its own.  The path
runs when a plan's NB kernel opts hold ``spill=True``.

* K4's bound — bytes: K1's, plus the partials written (4·WIN·N B a tile);
* K4's design — K1's sr design with runs keyed on the clamped window row;
  window rows the tile does not touch written as 0 by the group before
  them.  Every partial is written once, without atomics or a zeroing pass;
* the combine's bound — bytes: the partials read once and Y written once;
* its design — a row-parallel gather: the tiles that cover a row are one
  range of the non-decreasing ``row_base`` (binary search), summed in
  order into the row, written once.

Quantized value slabs (the TPU kernels' quant branches, ``vsr.py:146-155``
and ``:229-237``): K1 and K4 also take an ``(n_tiles, tile)`` slab of int8
or ``float8_e4m3fn`` codes with ``scales``, one f32 scale a tile
(``core/quant.py``), and multiply each code by its tile's scale in f32 as
they stage it: 1 B a value read in place of 4, no f32 copy of the stream.
The plain versions decode (``dequantize_stream``), then run the float math.
``VALUE_LAUNCHES`` counts each kernel's launches by value type.  A plan's
NB entries pass a baked slab's scales; a live float stream on a quantized
plan (``quant=`` in the opts) is quantized on its device first, so the
coded kernel runs.

``plan_windows`` (the spill path's windows) and ``plan_visits`` (the TPU
fused path's visit schedule, which the Hopper kernels do not need) are the
reference's host-side prep; they return its arrays element for element.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core import registry
from ..core.formats import BalancedCOO, host
from ..core.quant import dequantize_stream, is_quantized_dtype, quantize_stream
from ..core.selector import HOPPER_MAX_TILE, SelectorThresholds, TileGeometry

from . import _build, _common

#: launches of the K1 and K4 kernels and of the spill path's combine since
#: process start (or the last reset)
LAUNCHES = {"vsr_spmm": 0, "vsr_spmm_spill": 0, "spill_combine": 0}
#: K1's launches by design: "sr" (lane groups walk ranges of a staged tile)
#: or "pr" (a warp a tile, shuffle scan)
DESIGN_LAUNCHES = {"vsr_spmm": {"sr": 0, "pr": 0}}
#: value types of the nnz-balanced kernels' slabs (``_common.value_type``)
VALUE_KINDS = ("f32", "bf16", "int8", "fp8")
#: K1's and K4's launches by the value type of the slab they read
VALUE_LAUNCHES = {k: dict.fromkeys(VALUE_KINDS, 0)
                  for k in ("vsr_spmm", "vsr_spmm_spill")}


def _tile_spans(bal: BalancedCOO) -> tuple[np.ndarray, int, int]:
    """Per-tile first row (``m`` for an all-padding tile), the largest
    number of rows any tile spans (at least 1), and that span padded to a
    multiple of 8 (the window ``WIN``)."""
    rows = host(bal.rows)
    m = bal.shape[0]
    valid = rows < m
    any_valid = valid.any(axis=1)
    first = np.where(any_valid, rows[:, 0], m).astype(np.int32)
    last = np.where(any_valid, np.where(valid, rows, -1).max(axis=1), 0)
    span = int(np.maximum(last - first + 1, 1).max()) if len(rows) else 1
    return first, span, -(-span // 8) * 8


def plan_windows(bal: BalancedCOO, *, max_win: int | None = None
                 ) -> tuple[np.ndarray, int]:
    """Per-tile first row (``row_base``) and the largest row window ``WIN``
    any tile spans, padded to a multiple of 8 — the spill path's prep.
    Sentinel entries do not count; ``max_win`` warns on a pathological
    span."""
    first, span, win = _tile_spans(bal)
    if max_win is not None and win > max_win:
        warnings.warn(
            f"VSR spill window {win} exceeds max_win={max_win} (one tile "
            f"spans {span} rows — likely an empty-row gap)", stacklevel=2)
    return first, win


class SpillWindows:
    """The spill path's row windows of one plan: ``plan_windows`` run on the
    plan's first spill call and kept, so the fused path never pays for the
    scan.  A window wider than ``max_win`` raises ``ValueError``: the
    reference never runs its spill kernel on such a plan (it demotes it to
    xla), and the port does not run another kernel in its place."""

    def __init__(self, max_win: int | None = None):
        self.max_win = max_win
        self._value: tuple[torch.Tensor, int] | None = None

    def __call__(self, bal: BalancedCOO) -> tuple[torch.Tensor, int]:
        """``(row_base, win)``: (n_tiles,) int32 on the substrate's device,
        and the window height."""
        if self._value is None:
            first, span, win = _tile_spans(bal)
            if self.max_win is not None and win > self.max_win:
                raise ValueError(
                    f"spill path: a tile of {bal.tile} nonzeros spans {span} "
                    f"rows, a window of {win} > max_win={self.max_win} (an "
                    "empty-row gap); the fused kernels take this plan")
            self._value = (torch.from_numpy(first).to(bal.rows.device), win)
        return self._value


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


def decoded(bal: BalancedCOO, scales: torch.Tensor | None) -> BalancedCOO:
    """``bal`` with a coded slab decoded to f32 by ``scales`` (the plain
    versions' first step); a float slab as it is."""
    if not is_quantized_dtype(bal.vals.dtype):
        return bal
    if scales is None:
        raise ValueError(f"a slab of {bal.vals.dtype} codes needs its per-tile "
                         "scales")
    return BalancedCOO(bal.rows, bal.cols, dequantize_stream(bal.vals, scales),
                       bal.shape)


def spmm_vsr_plain(bal: BalancedCOO, x: torch.Tensor,
                   scales: torch.Tensor | None = None) -> torch.Tensor:
    """K1's plain PyTorch version: every product, one f32 segment sum (a
    coded slab decoded by ``scales`` first)."""
    bal = decoded(bal, scales)
    x2 = x[:, None] if x.ndim == 1 else x
    m = bal.shape[0]
    p = (bal.vals.reshape(-1, 1).float()
         * x2.index_select(0, bal.cols.reshape(-1)).float())
    y = torch.zeros((m + 1, x2.shape[1]), dtype=torch.float32, device=x2.device)
    y.index_add_(0, bal.rows.reshape(-1), p)
    y = y[:m].to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def _design(n: int) -> str:
    """The routing rule of a call that names no design: ``"pr"`` up to the
    selector's default ``n_threshold``, as a plan would pick, else ``"sr"``."""
    return "pr" if n <= SelectorThresholds.n_threshold else "sr"


def _check(bal: BalancedCOO, x: torch.Tensor,
           scales: torch.Tensor | None = None) -> torch.Tensor:
    """Raise ``ValueError`` unless the K1 kernels take these operands;
    returns X as ``(K, N)``."""
    x2 = x[:, None] if x.ndim == 1 else x
    _common.check_operands("vsr_spmm", (bal.rows, bal.cols), bal.vals, x2,
                           coded=True, scales=scales)
    k = bal.shape[1]
    if x2.shape[0] != k:
        raise ValueError(f"vsr_spmm: x has {x2.shape[0]} rows, A has {k} columns")
    if bal.tile > HOPPER_MAX_TILE:
        raise ValueError(f"vsr_spmm: tile {bal.tile} > {HOPPER_MAX_TILE} "
                         "does not fit the kernel's shared-memory staging")
    if -(-x2.shape[1] // 4) > 65535:
        raise ValueError(f"vsr_spmm: N={x2.shape[1]} exceeds the launch grid")
    return x2


def _launch(design: str, bal: BalancedCOO, x2: torch.Tensor, *,
            lanes: int | None = None,
            scales: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``design`` on checked operands into an ``(M, N)`` f32 ``Y``.
    ``lanes`` forces the sr design's lanes a group (default
    ``spill_lanes``); fewer lanes walk shorter ranges.  ``scales``: a coded
    slab's, not read for a float one."""
    if design not in DESIGN_LAUNCHES["vsr_spmm"]:
        raise ValueError(f"vsr_spmm: unknown design {design!r}")
    m, n = bal.shape[0], x2.shape[1]
    y = torch.zeros((m, n), dtype=torch.float32, device=x2.device)
    args = (bal.rows.data_ptr(), bal.cols.data_ptr(), bal.vals.data_ptr(),
            _common.value_code(bal.vals),
            _common.scales_ptr(bal.vals, scales), x2.data_ptr(),
            _common.is_bf16(x2), y.data_ptr(), bal.n_tiles, bal.tile, m, n)
    if design == "sr":
        fn = _build.lib().repro_vsr_sr
        args += (lanes or spill_lanes(n),)
    else:
        fn = _build.lib().repro_vsr_pr
    if y.numel():
        _build.check(fn(*args, _common.stream_of(x2)), "vsr_spmm")
        LAUNCHES["vsr_spmm"] += 1
        DESIGN_LAUNCHES["vsr_spmm"][design] += 1
        VALUE_LAUNCHES["vsr_spmm"][_common.value_type(bal.vals)] += 1
    return y


def reset_counts() -> None:
    """Set ``DESIGN_LAUNCHES`` and ``VALUE_LAUNCHES`` to 0
    (``reset_launch_counts`` calls it)."""
    for counts in (*DESIGN_LAUNCHES.values(), *VALUE_LAUNCHES.values()):
        counts.update(dict.fromkeys(counts, 0))


def spmm_vsr_fused(bal: BalancedCOO, x: torch.Tensor,
                   design: str | None = None, *,
                   scales: torch.Tensor | None = None) -> torch.Tensor:
    """K1: ``Y = A·X`` over the BalancedCOO slabs (int8 / fp8 codes with
    their per-tile ``scales``, or f32 / bf16 values).  CPU operands take the
    plain version; CUDA operands launch ``design`` (``None``: by N, as the
    selector would) or raise."""
    if _common.on_cpu("vsr_spmm", bal.rows, bal.cols, bal.vals, x):
        return spmm_vsr_plain(bal, x, scales)
    x2 = _check(bal, x, scales)
    design = _design(x2.shape[1]) if design is None else design
    y = _launch(design, bal, x2, scales=scales).to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def spmm_vsr_routed(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    """The nnz-balanced product of a call that names no logical kernel (the
    unfused chain and attention pairs): K2 for ``x`` of shape (K,), else K1
    in the design ``_design`` picks by N."""
    x = x.contiguous()
    if x.ndim == 1:
        from .spmv import spmv_vsr_fused
        return spmv_vsr_fused(bal, x)
    return spmm_vsr_fused(bal, x)


def spill_combine_plain(partials: torch.Tensor, row_base: torch.Tensor,
                        m: int) -> torch.Tensor:
    """The combine's plain PyTorch version (the reference's
    ``segment_sum``): one ``index_add_`` of every window row at
    ``row_base[t] + w``, rows at or past ``m`` dropped; any ``row_base``."""
    win = partials.shape[1]
    tail = tuple(partials.shape[2:])
    idx = (row_base.long()[:, None]
           + torch.arange(win, device=partials.device)[None, :]).reshape(-1)
    y = partials.new_zeros((m + win + 1,) + tail)
    y.index_add_(0, idx, partials.reshape((-1,) + tail))
    return y[:m]


def check_row_base(row_base: torch.Tensor) -> None:
    """Raise ``ValueError`` unless a caller's ``row_base`` on the card is
    non-decreasing, as the combine kernel needs (``SpillWindows`` gives it
    so).  One device sync."""
    if not _common.on_cpu("spill_combine", row_base) and row_base.numel() > 1 \
            and bool((row_base[1:] < row_base[:-1]).any()):
        raise ValueError("spill path: row_base must be non-decreasing (the "
                         "combine finds a row's tiles by binary search); "
                         "plan_windows / SpillWindows give it so")


def _combine(partials: torch.Tensor, row_base: torch.Tensor,
             m: int) -> torch.Tensor:
    """The combine on an ordered ``row_base``: the plain version for CPU
    operands, the kernel for CUDA operands."""
    if _common.on_cpu("spill_combine", partials, row_base):
        return spill_combine_plain(partials, row_base, m)
    n_tiles, win = partials.shape[:2]
    if (partials.ndim not in (2, 3) or partials.dtype != torch.float32
            or not partials.is_contiguous()
            or row_base.dtype != torch.int32 or row_base.shape != (n_tiles,)
            or not row_base.is_contiguous()):
        raise ValueError("spill_combine: partials must be contiguous float32 "
                         "(n_tiles, WIN[, N]) and row_base contiguous int32 "
                         "(n_tiles,)")
    n = partials.shape[2] if partials.ndim == 3 else 1
    if partials.numel() > 2**31 - 1 or m * n > 2**31 - 1:
        raise ValueError("spill_combine: an operand exceeds int32 indexing")
    y = torch.empty((m,) + tuple(partials.shape[2:]), dtype=torch.float32,
                    device=partials.device)
    if y.numel():
        err = _build.lib().repro_spill_combine(
            partials.data_ptr(), row_base.data_ptr(), y.data_ptr(), n_tiles,
            win, m, n, _common.stream_of(partials))
        _build.check(err, "spill_combine")
        LAUNCHES["spill_combine"] += 1
    return y


def spill_combine(partials: torch.Tensor, row_base: torch.Tensor,
                  m: int) -> torch.Tensor:
    """The spill path's combine (the reference's ``segment_sum``): window
    row ``w`` of tile ``t`` holds a sum for row ``row_base[t] + w``; rows
    that cross tiles add up, rows at or past ``m`` drop out.  ``partials``
    (n_tiles, WIN[, N]) f32 → (M[, N]) f32.  CPU operands take the plain
    version; CUDA operands launch the kernel, which needs ``row_base``
    non-decreasing (checked: ``ValueError``), or raise."""
    check_row_base(row_base)
    return _combine(partials, row_base, m)


def spill_partials_plain(bal: BalancedCOO, x2: torch.Tensor,
                         row_base: torch.Tensor, win: int,
                         scales: torch.Tensor | None = None) -> torch.Tensor:
    """K4's (and, at N = 1, K5's) plain PyTorch version: every product
    summed in f32 into its tile's window at ``row - row_base`` (clamped to
    the window, as the reference clamps), padding dropped; a coded slab
    decoded by ``scales`` first."""
    bal = decoded(bal, scales)
    n_tiles, t = bal.rows.shape
    n = x2.shape[1]
    m = bal.shape[0]
    valid = bal.rows < m
    local = (bal.rows - row_base[:, None]).clamp(0, win - 1)
    flat = (torch.arange(n_tiles, device=x2.device)[:, None] * win
            + local).reshape(-1)
    p = x2.index_select(0, bal.cols.reshape(-1)).float()
    p.mul_(bal.vals.reshape(-1, 1).float())
    p.masked_fill_(~valid.reshape(-1, 1), 0.0)
    part = torch.zeros((n_tiles * win, n), dtype=torch.float32, device=x2.device)
    part.index_add_(0, flat, p)
    return part.reshape(n_tiles, win, n)


def _given_or_planned(bal: BalancedCOO, row_base, win
                      ) -> tuple[torch.Tensor, int]:
    """The caller's windows, checked (``check_row_base``), or the planned
    ones."""
    if row_base is None or win is None:
        return SpillWindows()(bal)
    check_row_base(row_base)
    return row_base, int(win)


def spill_lanes(n: int) -> int:
    """Lanes of a group of K4 and of K1's sr design: the power of two whose
    4-column pieces cover N, at most a warp (128 columns a column block).
    Unlike K3's sr design, no
    column slabs for an X far larger than L2: on the uniform scale-20
    graph at N = 128 one pass measured 3.05 ms against 3.22 in 32-column
    slabs (NVIDIA H100 80GB HBM3, ``tools/time_spill.py``): each slab
    re-stages the tile, and 8-lane groups walk short ranges."""
    g = 1
    while g < 32 and 4 * g < n:
        g *= 2
    return g


def spmm_vsr_partials(bal: BalancedCOO, x2: torch.Tensor,
                      row_base: torch.Tensor, win: int, *,
                      lanes: int | None = None,
                      scales: torch.Tensor | None = None) -> torch.Tensor:
    """K4 alone: the (n_tiles, WIN, N) f32 partials of ``x2`` (K, N); a
    slab of codes takes its per-tile ``scales``.  CPU operands take the
    plain version; CUDA operands launch the kernel or raise.  ``lanes``
    forces a group's lanes (default ``spill_lanes``)."""
    if _common.on_cpu("vsr_spmm_spill", bal.rows, bal.cols, bal.vals, x2,
                      row_base):
        return spill_partials_plain(bal, x2, row_base, win, scales)
    _common.check_operands("vsr_spmm_spill", (bal.rows, bal.cols), bal.vals, x2,
                           coded=True, scales=scales)
    m, k = bal.shape
    n = x2.shape[1]
    if x2.shape[0] != k:
        raise ValueError(f"vsr_spmm_spill: x has {x2.shape[0]} rows, A has "
                         f"{k} columns")
    if (row_base.dtype != torch.int32 or row_base.shape != (bal.n_tiles,)
            or not row_base.is_contiguous() or win < 1):
        raise ValueError("vsr_spmm_spill: row_base must be contiguous int32 "
                         f"({bal.n_tiles},) and win >= 1")
    if bal.tile > HOPPER_MAX_TILE:
        raise ValueError(f"vsr_spmm_spill: tile {bal.tile} > {HOPPER_MAX_TILE} "
                         "does not fit the kernel's shared-memory staging")
    lanes = lanes or spill_lanes(n)
    if -(-n // (4 * lanes)) > 65535:
        raise ValueError(f"vsr_spmm_spill: N={n} exceeds the launch grid")
    part = torch.empty((bal.n_tiles, win, n), dtype=torch.float32,
                       device=x2.device)
    if part.numel() > 2**31 - 1:
        raise ValueError("vsr_spmm_spill: the partials exceed int32 indexing")
    if part.numel():
        err = _build.lib().repro_vsr_spmm_spill(
            bal.rows.data_ptr(), bal.cols.data_ptr(), bal.vals.data_ptr(),
            _common.value_code(bal.vals),
            _common.scales_ptr(bal.vals, scales), x2.data_ptr(),
            _common.is_bf16(x2), row_base.data_ptr(), part.data_ptr(),
            bal.n_tiles, bal.tile, m, n, win, lanes, _common.stream_of(x2))
        _build.check(err, "vsr_spmm_spill")
        LAUNCHES["vsr_spmm_spill"] += 1
        VALUE_LAUNCHES["vsr_spmm_spill"][_common.value_type(bal.vals)] += 1
    return part


def spmm_vsr_spill_plain(bal: BalancedCOO, x: torch.Tensor, *,
                         row_base: torch.Tensor | None = None,
                         win: int | None = None,
                         scales: torch.Tensor | None = None) -> torch.Tensor:
    """The spill path's plain PyTorch version: plain partials, then the
    plain combine."""
    x2 = x[:, None] if x.ndim == 1 else x
    if row_base is None or win is None:
        row_base, win = SpillWindows()(bal)
    y = spill_combine_plain(spill_partials_plain(bal, x2, row_base, win, scales),
                            row_base, bal.shape[0]).to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def _spill_spmm(bal: BalancedCOO, x2: torch.Tensor, row_base: torch.Tensor,
                win: int, scales: torch.Tensor | None = None) -> torch.Tensor:
    """K4, then the combine, on ordered windows."""
    return _combine(spmm_vsr_partials(bal, x2, row_base, win, scales=scales),
                    row_base, bal.shape[0]).to(x2.dtype)


def spmm_vsr(bal: BalancedCOO, x: torch.Tensor, *,
             row_base: torch.Tensor | None = None,
             win: int | None = None,
             scales: torch.Tensor | None = None) -> torch.Tensor:
    """NB SpMM, spill and combine (the fused path's parity reference): K4's
    partials, then ``spill_combine``.  ``row_base`` / ``win`` come from
    ``plan_windows`` (computed here when not given; a given ``row_base``
    on the card must be non-decreasing); ``scales`` decode a slab of
    codes."""
    x2 = x[:, None] if x.ndim == 1 else x
    y = _spill_spmm(bal, x2, *_given_or_planned(bal, row_base, win), scales)
    return y[:, 0] if x.ndim == 1 else y


def spmm_as_n_spmv_hopper(bal: BalancedCOO, x: torch.Tensor, *,
                          row_base: torch.Tensor | None = None,
                          win: int | None = None) -> torch.Tensor:
    """Paper §2.1.2 strawman on the Hopper kernels (the reference's
    ``spmm_as_n_spmv_pallas``): one SpMV a column, each re-reading the
    sparse stream — K2 a column, or K5 when ``row_base`` / ``win`` are
    given.  A composition of launches, not a kernel."""
    from .spmv import _spill_spmv, spmv_vsr_fused
    x2 = x[:, None] if x.ndim == 1 else x
    if row_base is not None and win is not None:
        row_base, win = _given_or_planned(bal, row_base, win)
        one_col = lambda col: _spill_spmv(bal, col, row_base, win)
    else:
        one_col = lambda col: spmv_vsr_fused(bal, col)
    cols = [one_col(x2[:, j].contiguous()) for j in range(x2.shape[1])]
    out = (torch.stack(cols, dim=1) if cols
           else x2.new_zeros((bal.shape[0], 0)))
    return out[:, 0] if x.ndim == 1 else out


# ---------------------------------------------------------------------------
# registry: the Hopper kernels of the nnz-balanced logical pair, each with its
# own K1 design (nb_sr: "sr", nb_pr: "pr"); x of shape (K,) takes K2, as in
# the reference's _pallas_nb.  ``spill=True`` in the kernel opts forces the
# spill path (K4, K5 at N = 1).  A quantized plan's opts carry ``quant`` (a
# float slab is quantized first) and, for its baked slab of codes,
# ``scales`` (``coded``).
# ---------------------------------------------------------------------------

def _prep_geometry(bal: BalancedCOO, *,
                   geometry: TileGeometry | None = None) -> dict:
    """Prep hook of the Hopper entries on the balanced slab: check the
    plan's geometry against the Hopper rules at plan time.  The reference's
    hook builds the TPU visit schedule, which the Hopper kernels do not
    need."""
    (geometry or TileGeometry()).validate("hopper")
    return {}


def _prep_windows(bal: BalancedCOO, *, geometry: TileGeometry | None = None,
                  max_win: int | None = None) -> dict:
    """Prep hook of the Hopper NB entries: ``_prep_geometry``, and an empty
    ``SpillWindows`` that the spill path fills on its first call (the
    reference builds its spill windows at plan time)."""
    return dict(_prep_geometry(bal, geometry=geometry),
                windows=SpillWindows(max_win))


def coded(bal: BalancedCOO, quant: str | None,
          scales: torch.Tensor | None
          ) -> tuple[BalancedCOO, torch.Tensor | None]:
    """The slab and scales an NB entry launches on: a baked slab of codes
    with the plan's ``scales``; a float slab on a quantized plan (``quant``:
    a live stream) quantized per tile on its own device, fresh scales; a
    float slab otherwise, no scales."""
    if is_quantized_dtype(bal.vals.dtype):
        if scales is None:
            raise ValueError(f"a slab of {bal.vals.dtype} codes needs its "
                             "per-tile scales")
        return bal, scales
    if quant is None:
        return bal, None
    q, sc = quantize_stream(bal.vals, quant)
    return BalancedCOO(bal.rows, bal.cols, q, bal.shape), sc


def _hopper_nb(design: str, bal: BalancedCOO, x: torch.Tensor, *,
               spill: bool = False, windows: SpillWindows | None = None,
               quant: str | None = None, scales: torch.Tensor | None = None):
    x = x.contiguous()
    bal, scales = coded(bal, quant, scales)
    if spill:
        row_base, win = (windows or SpillWindows())(bal)
        if x.ndim == 1:
            from .spmv import _spill_spmv
            return _spill_spmv(bal, x, row_base, win, scales)
        return _spill_spmm(bal, x, row_base, win, scales)
    if x.ndim == 1:
        from .spmv import spmv_vsr_fused
        return spmv_vsr_fused(bal, x, scales=scales)
    return spmm_vsr_fused(bal, x, design, scales=scales)


def _hopper_nb_sr(bal: BalancedCOO, x: torch.Tensor, **opts):
    return _hopper_nb("sr", bal, x, **opts)


def _hopper_nb_pr(bal: BalancedCOO, x: torch.Tensor, **opts):
    return _hopper_nb("pr", bal, x, **opts)


registry.register("nb_pr", "hopper", "balanced", _hopper_nb_pr, prep=_prep_windows)
registry.register("nb_sr", "hopper", "balanced", _hopper_nb_sr, prep=_prep_windows)
