"""K6, K7, K8 — the SDDMM and the fused SDDMM→transform→SpMM chain on Hopper;
counterpart of ``repro.kernels.fused_chain``.

Graph attention samples ``A @ Bᵀ`` at a graph's edges (SDDMM), transforms
the edge scores per row (identity, ``alpha``-scale or masked softmax) and
aggregates ``X`` over the same edges.  Run as separate kernels, the edge
stream makes a round trip through device memory; the fused chain keeps it on
chip.  The wrappers take the balanced slab's pattern ``(rows, cols)``
(padding ``rows == M``) and ``shape``; their CUDA sources are
``repro_torch/csrc/sddmm.cu`` (K6), ``repro_torch/csrc/chain.cu`` (K7 and
K8, the slot-tile design) and ``repro_torch/csrc/attention.cu`` (K7 and K8's
softmax in the block design, the bias compiled out), whose notes give each
kernel's bound and design:

* ``sddmm_fused`` (K6) replaces ``_sddmm_kernel``: f32 scores shaped like
  ``rows``, 0 at padding slots;
* ``chain_stats_fused`` (K7) replaces ``_chain_stats_kernel``: the softmax's
  row max and sum of ``exp(alpha·e − max)``, each ``(M,)`` (the TPU kernel's
  ``(mb, wb)`` blocks, flattened), empty rows at ``(SOFTMAX_NEG, 0)``;
* ``chain_fused`` (K8, with K7 for softmax) replaces ``_chain_kernel``:
  ``Y = T(e) · X`` with f32 sums, cast to ``x.dtype``.

K6 has two designs, the paper's two reductions on its reduction axis d,
routed by ``_sddmm_design``: ``"seq"`` for a row of one 16-byte piece or
less, ``"par"`` above it; ``DESIGN_LAUNCHES["sddmm"]`` counts each.

K7 and K8's softmax route each call as attention does (``blocks._route``):
an attention pattern — a band, BigBird — takes the block design of
``kernels/blocks.py`` (64 query rows a CTA, the tensor cores) with ``scale
= alpha``; a scattered graph, mixed types or d > 256 take the slot-tile
design (a CTA per balanced tile, the CUDA cores), as identity and scale
always do.  ``DESIGN_LAUNCHES`` counts the launches of each design.

The slot-tile K7 has two modes (``STATS_MODES`` counts each): ``"full"``,
every row's statistics (``chain_stats_fused``, the unfused pair), and
``"edge"``, only the rows of each tile's first and last runs — the runs
that may continue in a neighbouring tile — which the fused chain launches:
K8 folds every other row itself, from the scores it already holds.
``edge_slots``, ``chain_stats_edge_plain`` and ``chain_tiles_plain`` give
that order of work in plain PyTorch.

Each has a plain PyTorch version beside it (``*_plain``) with the same
contract: what the CPU takes and what the kernels are held to on the card.
``chain_unfused`` is the pair a ``"hopper"`` plan runs below the fuse gate
(``thresholds.chain_fuse_min_n``): K6 scores, K7 statistics, the weights by
elementwise tensor ops (``chain_edge_weights``, which the chain's backward
runs to recompute the weights), then K1/K2 on the materialised edge
stream.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..core.formats import BalancedCOO
from ..core.selector import HOPPER_MAX_TILE, TileGeometry
from ..core.spmm import (CHAIN_TRANSFORMS, SOFTMAX_EPS, SOFTMAX_NEG,
                         chain_stats_torch, chain_torch, chain_weights,
                         sddmm_torch)

from . import _build, _common, blocks as _blocks
from .vsr import _prep_geometry, spmm_vsr_routed

__all__ = ["CHAIN_TRANSFORMS", "sddmm_fused", "sddmm_plain",
           "chain_stats_fused", "chain_stats_plain", "chain_fused",
           "chain_plain", "chain_unfused", "chain_edge_weights", "edge_slots",
           "chain_stats_edge_plain", "chain_tiles_plain"]

#: launches of K6, K7 and K8 since process start (or the last reset)
LAUNCHES = {"sddmm": 0, "chain_stats": 0, "chain": 0}
#: launches by design: K6's "seq" or "par" (``csrc/sddmm.cu``, routed by d,
#: ``_sddmm_design``); K7's and K8's "block" (the tensor-core kernels of
#: ``csrc/attention.cu`` with the bias compiled out) or "slot" (``chain.cu``)
DESIGN_LAUNCHES = {"sddmm": {"seq": 0, "par": 0},
                   **{kernel: {"block": 0, "slot": 0}
                      for kernel in ("chain_stats", "chain")}}
#: K6's design codes of the ``repro_sddmm`` entry point
_SDDMM_DESIGNS = {"seq": 0, "par": 1}
#: the slot-tile K7's launches by mode: "full" (every row) or "edge" (the
#: tiles' first and last runs alone)
STATS_MODES = {"full": 0, "edge": 0}

#: transform codes of the ``repro_chain`` entry point
_TRANSFORM_CODES = {"identity": 0, "scale": 1, "softmax": 2}


def _alpha(alpha) -> float:
    return 1.0 if alpha is None else float(alpha)


def _check_transform(transform: str) -> None:
    if transform not in CHAIN_TRANSFORMS:
        raise ValueError(f"unknown chain transform {transform!r}; expected "
                         f"one of {CHAIN_TRANSFORMS}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def sddmm_plain(rows, cols, a, b, *, shape) -> torch.Tensor:
    """K6's plain version: the ``"torch"`` backend's SDDMM."""
    return sddmm_torch(rows, cols, a, b, shape=shape)


def chain_stats_plain(rows, cols, a, b, *, shape, alpha=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's plain version: the ``"torch"`` backend's statistics without
    their padding row, ``(row_max, row_sum)`` each ``(M,)`` f32."""
    m = int(shape[0])
    rm, rs = chain_stats_torch(rows, cols, a, b, shape=shape, alpha=alpha)
    return rm[:m], rs[:m]


def chain_plain(rows, cols, a, b, x, *, shape, transform: str = "identity",
                alpha=None, stats=None) -> torch.Tensor:
    """K8's plain version (K7 included for softmax): the ``"torch"``
    backend's unfused chain."""
    return chain_torch(rows, cols, a, b, x, shape=shape, transform=transform,
                       alpha=alpha, stats=stats)


# ---------------------------------------------------------------------------
# the slot-tile kernels' order of work, in plain PyTorch
# ---------------------------------------------------------------------------

def edge_slots(rows, m: int) -> torch.Tensor:
    """The slots of each tile's edge runs, ``(n_tiles, tile)`` bool: those of
    the tile's first row and of its last, padding (``rows >= m``) excluded.
    Rows are sorted within a tile, so each row is one run; only an edge run
    may continue in a neighbouring tile, and a row with an edge run in one
    tile has one in each tile it touches."""
    return ((rows == rows[:, :1]) | (rows == rows[:, -1:])) & (rows < m)


def _tile_runs(rows, m: int):
    """Each valid slot's run (a (tile, row) pair) in slot order: the valid
    mask, each valid slot's run index, the runs' rows and whether each run
    is an edge run."""
    n_tiles, tile = rows.shape
    valid = (rows < m).reshape(-1)
    tiles = torch.arange(n_tiles, device=rows.device).repeat_interleave(tile)
    key = tiles[valid] * (m + 1) + rows.reshape(-1)[valid].long()
    runs, run_of = torch.unique_consecutive(key, return_inverse=True)
    edge = torch.zeros(runs.shape, dtype=torch.bool, device=rows.device)
    edge[run_of] = edge_slots(rows, m).reshape(-1)[valid]
    return valid, run_of, runs % (m + 1), edge


def _run_stats(z, run_of, n_runs: int):
    """Each run's ``(max, sum of exp(z − max))``, the max floored at
    ``SOFTMAX_NEG`` as every slot of the kernels' scan starts."""
    rm = torch.full((n_runs,), SOFTMAX_NEG, dtype=torch.float32,
                    device=z.device)
    rm = rm.scatter_reduce(0, run_of, z, reduce="amax", include_self=True)
    rs = torch.zeros(n_runs, dtype=torch.float32, device=z.device)
    return rm, rs.index_add_(0, run_of, torch.exp(z - rm[run_of]))


def _edge_stats(z, run_of, run_row, edge, m: int):
    """``(row_max, row_sum)`` each ``(M,)`` of the rows of edge runs: each
    run's pair merged across tiles by the online-softmax update, as K7's
    edge mode merges them; every other row at ``(SOFTMAX_NEG, 0)``."""
    t_m, t_s = _run_stats(z, run_of, run_row.shape[0])
    er, em, es = run_row[edge], t_m[edge], t_s[edge]
    rm = torch.full((m,), SOFTMAX_NEG, dtype=torch.float32, device=z.device)
    rm = rm.scatter_reduce(0, er, em, reduce="amax", include_self=True)
    rs = torch.zeros(m, dtype=torch.float32, device=z.device)
    return rm, rs.index_add_(0, er, es * torch.exp(em - rm[er])), (t_m, t_s)


def chain_stats_edge_plain(rows, cols, a, b, *, shape, alpha=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7's edge mode in plain PyTorch: ``(row_max, row_sum)`` each ``(M,)``
    of the rows that hold an edge run of some tile (``edge_slots``), from
    per-tile partials merged by the online-softmax update; every other row
    left at ``(SOFTMAX_NEG, 0)``."""
    m = int(shape[0])
    valid, run_of, run_row, edge = _tile_runs(rows, m)
    e = sddmm_torch(rows, cols, a, b, shape=shape).reshape(-1)[valid]
    return _edge_stats(_alpha(alpha) * e, run_of, run_row, edge, m)[:2]


def chain_tiles_plain(rows, cols, a, b, x, *, shape,
                      transform: str = "identity", alpha=None, stats=None
                      ) -> torch.Tensor:
    """K8 in the slot-tile kernels' order of work: softmax without
    ``stats`` takes each tile's interior runs' statistics from the tile
    alone and its edge runs' from K7's edge mode (``chain_stats_edge_plain``),
    as the fused chain does; given ``stats``, identity and scale, the
    weights of ``chain_weights``.  Y sums in f32 and is cast to
    ``x.dtype``."""
    _check_transform(transform)
    m = int(shape[0])
    r = rows.reshape(-1)
    valid = r < m
    e = sddmm_torch(rows, cols, a, b, shape=shape).reshape(-1)
    if transform == "softmax" and stats is None:
        _, run_of, run_row, edge = _tile_runs(rows, m)
        z = _alpha(alpha) * e[valid]
        rm, rs, (t_m, t_s) = _edge_stats(z, run_of, run_row, edge, m)
        s_m = torch.where(edge, rm[run_row], t_m)[run_of]
        s_s = torch.where(edge, rs[run_row], t_s)[run_of]
        w = torch.zeros_like(e)
        w[valid] = torch.exp(z - s_m) / torch.clamp(s_s, min=SOFTMAX_EPS)
    else:
        w = chain_weights(e, r, valid, m, transform, alpha, stats=stats)
    x2 = x[:, None] if x.ndim == 1 else x
    y = torch.zeros((m, x2.shape[1]), dtype=torch.float32, device=x.device)
    xg = x2.index_select(0, cols.reshape(-1)[valid].long()).float()
    y.index_add_(0, r[valid].long(), w[valid, None] * xg)
    y = y.to(x.dtype)
    return y[:, 0] if x.ndim == 1 else y


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check_pattern(kernel: str, rows, cols, a, b, shape) -> None:
    """Raise ``ValueError`` unless the kernels take this pattern and these
    feature matrices: contiguous int32 ``(n_tiles, tile)`` slabs within the
    shared-memory staging, A ``(M, d)`` and B ``(K, d)`` contiguous and of
    one type, float32 or bfloat16."""
    for t in (rows, cols):
        if t.dtype != torch.int32 or t.shape != rows.shape or not t.is_contiguous():
            raise ValueError(f"{kernel}: rows and cols must be contiguous "
                             "int32 slabs of one shape")
    if rows.ndim != 2 or rows.shape[1] > HOPPER_MAX_TILE:
        raise ValueError(f"{kernel}: the pattern must be (n_tiles, tile) "
                         f"slabs with tile <= {HOPPER_MAX_TILE}")
    m, k = (int(s) for s in shape)
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != m or b.shape[0] != k \
            or a.shape[1] != b.shape[1]:
        raise ValueError(f"{kernel}: needs A ({m}, d) and B ({k}, d); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _common.FLOAT_TYPES or b.dtype != a.dtype:
        raise ValueError(f"{kernel}: A and B must share one type, float32 or "
                         f"bfloat16; got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{kernel}: A and B must be contiguous")


def _sddmm_design(d: int, dtype: torch.dtype) -> str:
    """K6's routing rule: ``"seq"`` (a thread a slot, no shuffle) where a
    feature row fits one 16-byte piece (d <= 4 f32, <= 8 bf16), else
    ``"par"`` (lane groups split d)."""
    return "seq" if d * torch.empty((), dtype=dtype).element_size() <= 16 else "par"


def sddmm_fused(rows, cols, a, b, *, shape) -> torch.Tensor:
    """K6: f32 edge scores shaped like ``rows``.  CPU operands take the plain
    version; CUDA operands launch the kernel of the design ``_sddmm_design``
    routes d to, or raise."""
    if _common.on_cpu("sddmm", rows, cols, a, b):
        return sddmm_plain(rows, cols, a, b, shape=shape)
    return _launch_sddmm(None, rows, cols, a, b, shape=shape)


def _launch_sddmm(design, rows, cols, a, b, *, shape) -> torch.Tensor:
    """K6 on CUDA operands in ``design``: ``None`` routes by d, ``"seq"`` or
    ``"par"`` forces one (for tests and timings)."""
    _check_pattern("sddmm", rows, cols, a, b, shape)
    design = design or _sddmm_design(a.shape[1], a.dtype)
    if design not in _SDDMM_DESIGNS:
        raise ValueError(f"sddmm: unknown design {design!r}")
    out = torch.empty(rows.shape, dtype=torch.float32, device=rows.device)
    if out.numel():
        err = _build.lib().repro_sddmm(
            rows.data_ptr(), cols.data_ptr(), a.data_ptr(), b.data_ptr(),
            _common.is_bf16(a), out.data_ptr(), rows.shape[0], rows.shape[1],
            int(shape[0]), a.shape[1], _SDDMM_DESIGNS[design],
            _common.stream_of(a))
        _build.check(err, "sddmm")
        _count("sddmm", design)
    return out


def _count(kernel: str, design: str) -> None:
    LAUNCHES[kernel] += 1
    DESIGN_LAUNCHES[kernel][design] += 1


def reset_counts() -> None:
    """Set ``DESIGN_LAUNCHES`` and ``STATS_MODES`` to 0
    (``reset_launch_counts`` calls it)."""
    for counts in DESIGN_LAUNCHES.values():
        counts.update(dict.fromkeys(counts, 0))
    STATS_MODES.update(dict.fromkeys(STATS_MODES, 0))


def _stats_packed(rows, cols, a, b, m: int, alpha, design, layout,
                  edge: bool = False) -> torch.Tensor:
    """Launch K7 in ``design`` into an ``(M, 2)`` f32 buffer of
    ``(row_max, row_sum)`` pairs, filled with ``(SOFTMAX_NEG, 0)`` first;
    ``edge`` takes the slot-tile design's edge mode."""
    stats = _blocks.new_stats(m, rows.device)
    if design == "block":
        if edge:
            raise ValueError("chain_stats: the block design has no edge mode")
        if _blocks.launch_stats("chain_stats", layout, a, b, None, stats,
                                _alpha(alpha)):
            _count("chain_stats", design)
    elif m and rows.numel():
        err = _build.lib().repro_chain_stats(
            rows.data_ptr(), cols.data_ptr(), a.data_ptr(), b.data_ptr(),
            _common.is_bf16(a), stats.data_ptr(), rows.shape[0],
            rows.shape[1], m, a.shape[1], _alpha(alpha), int(edge),
            _common.stream_of(a))
        _build.check(err, "chain_stats")
        _count("chain_stats", design)
        STATS_MODES["edge" if edge else "full"] += 1
    return stats


def chain_stats_fused(rows, cols, a, b, *, shape, alpha=None,
                      blocks: _blocks.AttnBlocks | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: ``(row_max, row_sum)`` of the masked softmax of ``alpha`` times
    the edge scores, each ``(M,)`` f32.  CPU operands take the plain version;
    CUDA operands launch the kernel of the routed design (``blocks._route``)
    or raise.  ``blocks`` caches the pattern's block layout (built per call
    without it)."""
    if _common.on_cpu("chain_stats", rows, cols, a, b):
        return chain_stats_plain(rows, cols, a, b, shape=shape, alpha=alpha)
    return _launch_stats(None, rows, cols, a, b, shape=shape, alpha=alpha,
                         blocks=blocks)


def _launch_stats(design, rows, cols, a, b, *, shape, alpha=None,
                  blocks=None, edge: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 on CUDA operands in ``design``: ``None`` routes by the rule,
    ``"block"`` or ``"slot"`` forces one (for tests and timings); ``edge``
    takes the slot-tile design's edge mode (what the fused chain runs)."""
    _check_pattern("chain_stats", rows, cols, a, b, shape)
    route, layout = _blocks._route("chain_stats", design, blocks, rows, cols,
                                   shape, a, b)
    stats = _stats_packed(rows, cols, a, b, int(shape[0]), alpha, route,
                          layout, edge)
    return stats[:, 0].contiguous(), stats[:, 1].contiguous()


def chain_fused(rows, cols, a, b, x, *, shape, transform: str = "identity",
                alpha=None, stats=None,
                blocks: _blocks.AttnBlocks | None = None) -> torch.Tensor:
    """K8: ``Y = T(mask(A·Bᵀ)) · X`` in one pass over the pattern, the edge
    scores kept on chip; softmax first runs K7 (in the same design) unless
    ``stats`` (row max and row sum, indexable by row id) are given.  CPU
    operands take the plain version; CUDA operands launch the kernels or
    raise.  Softmax routes by the rule, as ``chain_stats_fused`` (``blocks``
    as there); identity and scale take the slot-tile design."""
    _check_transform(transform)
    given = () if stats is None else tuple(stats)
    if _common.on_cpu("chain", rows, cols, a, b, x, *given):
        return chain_plain(rows, cols, a, b, x, shape=shape,
                           transform=transform, alpha=alpha, stats=stats)
    return _launch_chain(None, rows, cols, a, b, x, shape=shape,
                         transform=transform, alpha=alpha, stats=stats,
                         blocks=blocks)


def _route(design, transform: str, blocks, rows, cols, shape, a, b, x):
    """K8's design, ``("block", layout)`` or ``("slot", None)``: softmax by
    ``blocks._route`` (X must share A's type too), identity and scale on
    the slot-tile design (forcing ``"block"`` on them raises)."""
    if transform == "softmax":
        return _blocks._route("chain", design, blocks, rows, cols, shape, a,
                              b, x)
    if design == "block":
        raise ValueError(f"chain: the block design runs softmax only; got "
                         f"{transform!r}")
    return _blocks._route("chain", "slot", blocks, rows, cols, shape, a, b)


def _launch_chain(design, rows, cols, a, b, x, *, shape,
                  transform: str = "identity", alpha=None, stats=None,
                  blocks=None, edge_stats: bool = False) -> torch.Tensor:
    """K8 (K7 first for softmax without ``stats``) on CUDA operands in
    ``design``, as for ``_launch_stats``; only softmax has a block design.
    ``edge_stats`` says that the given ``stats`` hold the rows of the
    tiles' edge runs alone (K7's edge mode, ``_launch_stats(edge=True)``):
    the slot-tile K8 then folds every other row itself, as in the fused
    chain (for tests and timings of K8 alone)."""
    _check_transform(transform)
    _check_pattern("chain", rows, cols, a, b, shape)
    m = int(shape[0])
    x2 = _common.check_dense("chain", x, int(shape[1]))
    n = x2.shape[1]
    route, layout = _route(design, transform, blocks, rows, cols, shape, a,
                           b, x2)
    # the slot-tile K8 folds every run that lies inside its tile itself: K7
    # computes the tiles' edge runs alone
    packed = None
    edge = transform == "softmax" and route == "slot" and (
        stats is None or edge_stats)
    if edge_stats and not edge:
        raise ValueError("chain: edge statistics need the slot-tile design's "
                         "softmax with given stats")
    if transform == "softmax":
        packed = (_stats_packed(rows, cols, a, b, m, alpha, route, layout,
                                edge)
                  if stats is None else _blocks.pack_stats(stats, m))
    y = torch.zeros((m, n), dtype=torch.float32, device=x2.device)
    if route == "block":
        if _blocks.launch_chain("chain", layout, a, b, None, packed, x2, y,
                                _alpha(alpha)):
            _count("chain", route)
    elif y.numel() and rows.numel():
        err = _build.lib().repro_chain(
            rows.data_ptr(), cols.data_ptr(), a.data_ptr(), b.data_ptr(),
            _common.is_bf16(a), None if packed is None else packed.data_ptr(),
            x2.data_ptr(), _common.is_bf16(x2), y.data_ptr(), rows.shape[0],
            rows.shape[1], m, n, a.shape[1], _TRANSFORM_CODES[transform],
            int(edge), _alpha(alpha), _common.stream_of(x2))
        _build.check(err, "chain")
        _count("chain", route)
    y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def chain_edge_weights(rows, cols, a, b, *, shape,
                       transform: str = "identity", alpha=None, stats=None,
                       blocks: _blocks.AttnBlocks | None = None
                       ) -> torch.Tensor:
    """The chain's f32 edge weights ``T(e)`` shaped like ``rows``, 0 at
    padding, by the kernels: K6 scores, K7 statistics for softmax (full
    mode, or the block design on an attention pattern), the weights by
    elementwise tensor ops (the reference does that step outside any
    kernel too).  The first half of ``chain_unfused``, and the recompute of
    the chain's backward on the card.  ``blocks`` as for
    ``chain_stats_fused``."""
    _check_transform(transform)
    m = int(shape[0])
    e = sddmm_fused(rows, cols, a, b, shape=shape)
    if transform == "softmax" and stats is None:
        stats = chain_stats_fused(rows, cols, a, b, shape=shape, alpha=alpha,
                                  blocks=blocks)
    r = rows.reshape(-1)
    return chain_weights(e.reshape(-1), r, r < m, m, transform, alpha,
                         stats=stats).reshape(rows.shape)


def chain_unfused(rows, cols, a, b, x, *, shape, transform: str = "identity",
                  alpha=None, stats=None,
                  blocks: _blocks.AttnBlocks | None = None) -> torch.Tensor:
    """The chain as separate kernels, the edge stream materialised: the
    weights of ``chain_edge_weights``, then the nnz-balanced SpMM routed by
    N (``vsr.spmm_vsr_routed``: K2 for 1-D x, else K1 in its pr or sr
    design) on ``BalancedCOO(rows, cols, w)``.  ``blocks`` as for
    ``chain_stats_fused``."""
    w = chain_edge_weights(rows, cols, a, b, shape=shape, transform=transform,
                           alpha=alpha, stats=stats, blocks=blocks)
    return spmm_vsr_routed(BalancedCOO(rows, cols, w, tuple(shape)), x)


# ---------------------------------------------------------------------------
# registry: the Hopper entries of the chain family.  Their prep hook is the
# NB entries' geometry check (no visit schedule is needed); the chain's adds
# the plan's ``AttnBlocks`` (shared with the ``attn_chain`` entry), filled on
# its first softmax call.
# ---------------------------------------------------------------------------

def _prep_chain(bal: BalancedCOO, *, geometry: TileGeometry | None = None,
                shared: dict) -> dict:
    return dict(_prep_geometry(bal, geometry=geometry),
                blocks=_blocks.plan_blocks(shared))


def _hopper_sddmm(rows, cols, a, b, **kw):
    return sddmm_fused(rows, cols, a.contiguous(), b.contiguous(), **kw)


def _hopper_chain(rows, cols, a, b, x, *, fuse: bool = True, **kw):
    run = chain_fused if fuse else chain_unfused
    return run(rows, cols, a.contiguous(), b.contiguous(), x.contiguous(),
               **kw)


registry.register("sddmm", "hopper", "balanced", _hopper_sddmm,
                  prep=_prep_geometry)
registry.register("chain", "hopper", "balanced", _hopper_chain,
                  prep=_prep_chain)
