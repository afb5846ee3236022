"""K9, K10 — block-sparse attention on Hopper; counterpart of
``repro.kernels.attention``.

Per (batch, head), block-sparse attention is the softmax chain of
``fused_chain`` with ``alpha = scale``; what earns it its own logical kernel
(``attn_chain``) is the additive per-edge bias, ``z = scale·e + bias``,
which rides the balanced slab layout of the pattern.  The wrappers take the
slab's pattern ``(rows, cols)`` (padding ``rows == M``), Q ``(M, d)``,
K ``(K, d)``, the f32 bias slab shaped like ``rows`` and ``shape``; their
CUDA source is ``repro_torch/csrc/attention.cu``, whose note gives each
kernel's bound and design:

* ``attn_stats_fused`` (K9) replaces ``_attn_stats_kernel``: the softmax's
  row max and sum of ``exp(z − max)``, each ``(M,)`` (the TPU kernel's
  ``(mb, wb)`` blocks, flattened), empty rows at ``(SOFTMAX_NEG, 0)``;
* ``attn_chain_fused`` (K10, with K9 first unless ``stats`` are given)
  replaces ``_attn_kernel``: ``Y = softmax(z) · V`` with f32 sums, cast to
  ``v.dtype``.

Each kernel has two designs, and the wrapper routes every call to one:

* the **block design** (``kernels/blocks.py``, shared with K7/K8) — a CTA
  owns 64 query rows and walks the 64×64 blocks of keys its row block
  touches, the scores and ``P·V`` on the tensor cores, through the
  pattern's ``BlockLayout``, built once per plan (``AttnBlocks``);
* the **slot-tile design** — a CTA per balanced tile of the slab, one slot
  at a time on the CUDA cores, for patterns the block design would waste.

``blocks._route`` applies the rule between them; ``DESIGN_LAUNCHES`` counts
the launches of each design.  The block names (``BlockLayout``,
``AttnBlocks``, ``build_block_layout``, the plain evaluators
``attn_*_blocks_plain``, …) are re-exported here.

Each kernel has a plain PyTorch version beside it (``*_plain``, the
``"torch"`` backend's functions) with the same contract.  ``attn_unfused``
is what a ``"hopper"`` plan runs below the fuse gate
(``attn_fuse_min_seq``): K6 scores, K9 statistics, the weights by
elementwise tensor ops, then K1/K2.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..core.formats import BalancedCOO
from ..core.selector import TileGeometry
from ..core.spmm import attn_chain_torch, attn_stats_torch, attn_weights

from . import _build, _common, blocks as _blocks, fused_chain
from .blocks import (BLOCK, BLOCK_FILL_MIN, BLOCK_MAX_D, AttnBlocks,  # noqa: F401
                     BlockLayout, _route,
                     attn_chain_blocks_plain, attn_stats_blocks_plain,
                     build_block_layout, chunk_row_blocks, layout_entries)
from .vsr import _prep_geometry, spmm_vsr_routed

__all__ = ["BLOCK", "BLOCK_FILL_MIN", "BLOCK_MAX_D", "BlockLayout",
           "AttnBlocks", "build_block_layout", "chunk_row_blocks",
           "layout_entries", "attn_stats_fused", "attn_stats_plain",
           "attn_stats_blocks_plain", "attn_chain_fused", "attn_chain_plain",
           "attn_chain_blocks_plain", "attn_unfused", "attn_edge_weights"]

#: launches of K9 and K10 since process start (or the last reset)
LAUNCHES = {"attn_stats": 0, "attn_chain": 0}
#: the same launches by design ("block" or "slot")
DESIGN_LAUNCHES = {kernel: {"block": 0, "slot": 0} for kernel in LAUNCHES}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def attn_stats_plain(rows, cols, q, k, bias, *, shape, scale=1.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9's plain version: the ``"torch"`` backend's statistics without
    their padding row, ``(row_max, row_sum)`` each ``(M,)`` f32."""
    m = int(shape[0])
    rm, rs = attn_stats_torch(rows, cols, q, k, bias, shape=shape,
                              scale=scale)
    return rm[:m], rs[:m]


def attn_chain_plain(rows, cols, q, k, bias, v, *, shape, scale=1.0,
                     stats=None) -> torch.Tensor:
    """K10's plain version (K9 included): the ``"torch"`` backend's
    unfused attention."""
    return attn_chain_torch(rows, cols, q, k, bias, v, shape=shape,
                            scale=scale, stats=stats)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check_bias(kernel: str, rows, bias) -> None:
    if bias.dtype != torch.float32 or bias.shape != rows.shape \
            or not bias.is_contiguous():
        raise ValueError(f"{kernel}: the bias must be a contiguous float32 "
                         f"slab of the pattern's shape {tuple(rows.shape)}; "
                         f"got {bias.dtype} {tuple(bias.shape)}")


def _count(kernel: str, design: str) -> None:
    LAUNCHES[kernel] += 1
    DESIGN_LAUNCHES[kernel][design] += 1


def reset_counts() -> None:
    """Set ``DESIGN_LAUNCHES`` to 0 (``reset_launch_counts`` calls it)."""
    for counts in DESIGN_LAUNCHES.values():
        counts.update(dict.fromkeys(counts, 0))


def _stats_packed(rows, cols, q, k, bias, m: int, scale, design, layout
                  ) -> torch.Tensor:
    """Launch K9 into an ``(M, 2)`` f32 buffer of ``(row_max, row_sum)``
    pairs, filled with ``(SOFTMAX_NEG, 0)`` first."""
    stats = _blocks.new_stats(m, rows.device)
    if design == "block":
        if _blocks.launch_stats("attn_stats", layout, q, k, bias, stats,
                                scale):
            _count("attn_stats", design)
    elif m and rows.numel():
        err = _build.lib().repro_attn_stats(
            rows.data_ptr(), cols.data_ptr(), q.data_ptr(), k.data_ptr(),
            _common.is_bf16(q), bias.data_ptr(), stats.data_ptr(),
            rows.shape[0], rows.shape[1], m, q.shape[1], float(scale),
            _common.stream_of(q))
        _build.check(err, "attn_stats")
        _count("attn_stats", design)
    return stats


def attn_stats_fused(rows, cols, q, k, bias, *, shape, scale=1.0,
                     blocks: AttnBlocks | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9: ``(row_max, row_sum)`` of the masked softmax of ``scale·QKᵀ +
    bias``, each ``(M,)`` f32.  CPU operands take the plain version; CUDA
    operands launch the kernel of the routed design or raise.  ``blocks``
    caches the pattern's block layout (built per call without it)."""
    if _common.on_cpu("attn_stats", rows, cols, q, k, bias):
        return attn_stats_plain(rows, cols, q, k, bias, shape=shape,
                                scale=scale)
    return _launch_stats(None, rows, cols, q, k, bias, shape=shape,
                         scale=scale, blocks=blocks)


def _launch_stats(design, rows, cols, q, k, bias, *, shape, scale=1.0,
                  blocks=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K9 on CUDA operands in ``design``: ``None`` routes by the rule,
    ``"block"`` or ``"slot"`` forces one (for tests and timings)."""
    fused_chain._check_pattern("attn_stats", rows, cols, q, k, shape)
    _check_bias("attn_stats", rows, bias)
    route, layout = _route("attn_stats", design, blocks, rows, cols, shape,
                           q, k)
    stats = _stats_packed(rows, cols, q, k, bias, int(shape[0]), scale, route,
                          layout)
    return stats[:, 0].contiguous(), stats[:, 1].contiguous()


def attn_chain_fused(rows, cols, q, k, bias, v, *, shape, scale=1.0,
                     stats=None, blocks: AttnBlocks | None = None
                     ) -> torch.Tensor:
    """K10: ``Y = softmax_mask(scale·QKᵀ + bias) · V`` in one pass over the
    pattern, the weights kept on chip; runs K9 first (in the same design)
    unless ``stats`` (row max and row sum, indexable by row id) are given.
    CPU operands take the plain version; CUDA operands launch the kernels or
    raise.  ``blocks`` as for ``attn_stats_fused``."""
    given = () if stats is None else tuple(stats)
    if _common.on_cpu("attn_chain", rows, cols, q, k, bias, v, *given):
        return attn_chain_plain(rows, cols, q, k, bias, v, shape=shape,
                                scale=scale, stats=stats)
    return _launch_chain(None, rows, cols, q, k, bias, v, shape=shape,
                         scale=scale, stats=stats, blocks=blocks)


def _launch_chain(design, rows, cols, q, k, bias, v, *, shape, scale=1.0,
                  stats=None, blocks=None) -> torch.Tensor:
    """K10 (K9 first without ``stats``) on CUDA operands in ``design``, as
    for ``_launch_stats``."""
    fused_chain._check_pattern("attn_chain", rows, cols, q, k, shape)
    _check_bias("attn_chain", rows, bias)
    m = int(shape[0])
    v2 = _common.check_dense("attn_chain", v, int(shape[1]))
    n = v2.shape[1]
    route, layout = _route("attn_chain", design, blocks, rows, cols, shape,
                           q, k, v2)
    packed = (_stats_packed(rows, cols, q, k, bias, m, scale, route, layout)
              if stats is None else _blocks.pack_stats(stats, m))
    y = torch.zeros((m, n), dtype=torch.float32, device=v2.device)
    if route == "block":
        if _blocks.launch_chain("attn_chain", layout, q, k, bias, packed, v2,
                                y, scale):
            _count("attn_chain", route)
    elif y.numel() and rows.numel():
        err = _build.lib().repro_attn(
            rows.data_ptr(), cols.data_ptr(), q.data_ptr(), k.data_ptr(),
            _common.is_bf16(q), bias.data_ptr(), packed.data_ptr(),
            v2.data_ptr(), _common.is_bf16(v2), y.data_ptr(), rows.shape[0],
            rows.shape[1], m, n, q.shape[1], float(scale),
            _common.stream_of(v2))
        _build.check(err, "attn_chain")
        _count("attn_chain", route)
    y = y.to(v2.dtype)
    return y[:, 0] if v.ndim == 1 else y


def attn_edge_weights(rows, cols, q, k, bias, *, shape, scale=1.0,
                      stats=None, blocks: AttnBlocks | None = None
                      ) -> torch.Tensor:
    """Attention's f32 edge weights shaped like ``rows``, 0 at padding, by
    the kernels: K6 scores, K9 statistics (the block design on an attention
    mask), the weights by elementwise tensor ops (the reference does that
    step outside any kernel too).  The first half of ``attn_unfused``, and
    the recompute of attention's backward on the card."""
    m = int(shape[0])
    e = fused_chain.sddmm_fused(rows, cols, q, k, shape=shape)
    if stats is None:
        stats = attn_stats_fused(rows, cols, q, k, bias, shape=shape,
                                 scale=scale, blocks=blocks)
    r = rows.reshape(-1)
    return attn_weights(e.reshape(-1), bias.reshape(-1).float(), r, r < m, m,
                        scale, stats=stats).reshape(rows.shape)


def attn_unfused(rows, cols, q, k, bias, v, *, shape, scale=1.0,
                 stats=None, blocks: AttnBlocks | None = None
                 ) -> torch.Tensor:
    """Attention as separate kernels, the edge stream materialised: the
    weights of ``attn_edge_weights``, then the nnz-balanced SpMM routed by
    N (``vsr.spmm_vsr_routed``: K2 for 1-D v, else K1 in its pr or sr
    design) on ``BalancedCOO(rows, cols, w)``."""
    w = attn_edge_weights(rows, cols, q, k, bias, shape=shape, scale=scale,
                          stats=stats, blocks=blocks)
    return spmm_vsr_routed(BalancedCOO(rows, cols, w, tuple(shape)), v)


# ---------------------------------------------------------------------------
# registry: the Hopper entry of attention with a bias.  Its prep hook is the
# NB entries' geometry check and the plan's ``AttnBlocks`` (shared with the
# ``chain`` entry), filled on the plan's first call.
# ---------------------------------------------------------------------------

def _prep_attn(bal: BalancedCOO, *, geometry: TileGeometry | None = None,
               shared: dict) -> dict:
    return dict(_prep_geometry(bal, geometry=geometry),
                blocks=_blocks.plan_blocks(shared))


def _hopper_attn(rows, cols, q, k, bias, v, *, fuse: bool = True, **kw):
    run = attn_chain_fused if fuse else attn_unfused
    return run(rows, cols, q.contiguous(), k.contiguous(), bias.contiguous(),
               v.contiguous(), **kw)


registry.register("attn_chain", "hopper", "balanced", _hopper_attn,
                  prep=_prep_attn)
