"""K6, K7, K8 — the SDDMM and the fused SDDMM→transform→SpMM chain on Hopper;
counterpart of ``repro.kernels.fused_chain``.

Graph attention samples ``A @ Bᵀ`` at a graph's edges (SDDMM), transforms
the edge scores per row (identity, ``alpha``-scale or masked softmax) and
aggregates ``X`` over the same edges.  Run as separate kernels, the edge
stream makes a round trip through device memory; the fused chain keeps it on
chip.  The wrappers take the balanced slab's pattern ``(rows, cols)``
(padding ``rows == M``) and ``shape``; their CUDA sources are
``repro_torch/csrc/sddmm.cu`` (K6) and ``repro_torch/csrc/chain.cu`` (K7,
K8), whose notes give each kernel's bound and design:

* ``sddmm_fused`` (K6) replaces ``_sddmm_kernel``: f32 scores shaped like
  ``rows``, 0 at padding slots;
* ``chain_stats_fused`` (K7) replaces ``_chain_stats_kernel``: the softmax's
  row max and sum of ``exp(alpha·e − max)``, each ``(M,)`` (the TPU kernel's
  ``(mb, wb)`` blocks, flattened), empty rows at ``(SOFTMAX_NEG, 0)``;
* ``chain_fused`` (K8, with K7 for softmax) replaces ``_chain_kernel``:
  ``Y = T(e) · X`` with f32 sums, cast to ``x.dtype``.

Each has a plain PyTorch version beside it (``*_plain``) with the same
contract: what the CPU takes and what the kernels are held to on the card.
``chain_unfused`` is the pair a ``"hopper"`` plan runs below the fuse gate
(``thresholds.chain_fuse_min_n``): K6 scores, K7 statistics, the weights by
elementwise tensor ops, then K1/K2 on the materialised edge stream.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..core.formats import BalancedCOO
from ..core.selector import HOPPER_MAX_TILE
from ..core.spmm import (CHAIN_TRANSFORMS, SOFTMAX_NEG, chain_stats_torch,
                         chain_torch, chain_weights, sddmm_torch)

from . import _build, _common
from .vsr import _prep_geometry

__all__ = ["CHAIN_TRANSFORMS", "sddmm_fused", "sddmm_plain",
           "chain_stats_fused", "chain_stats_plain", "chain_fused",
           "chain_plain", "chain_unfused"]

#: launches of K6, K7 and K8 since process start (or the last reset)
LAUNCHES = {"sddmm": 0, "chain_stats": 0, "chain": 0}

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


def sddmm_fused(rows, cols, a, b, *, shape) -> torch.Tensor:
    """K6: f32 edge scores shaped like ``rows``.  CPU operands take the plain
    version; CUDA operands launch the kernel or raise."""
    if _common.on_cpu("sddmm", rows, cols, a, b):
        return sddmm_plain(rows, cols, a, b, shape=shape)
    _check_pattern("sddmm", rows, cols, a, b, shape)
    out = torch.empty(rows.shape, dtype=torch.float32, device=rows.device)
    if out.numel():
        err = _build.lib().repro_sddmm(
            rows.data_ptr(), cols.data_ptr(), a.data_ptr(), b.data_ptr(),
            _common.is_bf16(a), out.data_ptr(), rows.shape[0], rows.shape[1],
            int(shape[0]), a.shape[1], _common.stream_of(a))
        _build.check(err, "sddmm")
        LAUNCHES["sddmm"] += 1
    return out


def _stats_packed(rows, cols, a, b, m: int, alpha) -> torch.Tensor:
    """Launch K7 into an ``(M, 2)`` f32 buffer of ``(row_max, row_sum)``
    pairs, filled with ``(SOFTMAX_NEG, 0)`` first."""
    stats = torch.zeros((m, 2), dtype=torch.float32, device=rows.device)
    stats[:, 0] = SOFTMAX_NEG
    if m and rows.numel():
        err = _build.lib().repro_chain_stats(
            rows.data_ptr(), cols.data_ptr(), a.data_ptr(), b.data_ptr(),
            _common.is_bf16(a), stats.data_ptr(), rows.shape[0],
            rows.shape[1], m, a.shape[1], _alpha(alpha), _common.stream_of(a))
        _build.check(err, "chain_stats")
        LAUNCHES["chain_stats"] += 1
    return stats


def chain_stats_fused(rows, cols, a, b, *, shape, alpha=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: ``(row_max, row_sum)`` of the masked softmax of ``alpha`` times
    the edge scores, each ``(M,)`` f32.  CPU operands take the plain version;
    CUDA operands launch the kernel or raise."""
    if _common.on_cpu("chain_stats", rows, cols, a, b):
        return chain_stats_plain(rows, cols, a, b, shape=shape, alpha=alpha)
    _check_pattern("chain_stats", rows, cols, a, b, shape)
    stats = _stats_packed(rows, cols, a, b, int(shape[0]), alpha)
    return stats[:, 0].contiguous(), stats[:, 1].contiguous()


def chain_fused(rows, cols, a, b, x, *, shape, transform: str = "identity",
                alpha=None, stats=None) -> torch.Tensor:
    """K8: ``Y = T(mask(A·Bᵀ)) · X`` in one pass over the pattern, the edge
    scores kept on chip; softmax first runs K7 unless ``stats`` (row max and
    row sum, indexable by row id) are given.  CPU operands take the plain
    version; CUDA operands launch the kernels or raise."""
    _check_transform(transform)
    given = () if stats is None else tuple(stats)
    if _common.on_cpu("chain", rows, cols, a, b, x, *given):
        return chain_plain(rows, cols, a, b, x, shape=shape,
                           transform=transform, alpha=alpha, stats=stats)
    _check_pattern("chain", rows, cols, a, b, shape)
    m = int(shape[0])
    x2 = _common.check_dense("chain", x, int(shape[1]))
    n = x2.shape[1]
    packed = None
    if transform == "softmax":
        packed = (_stats_packed(rows, cols, a, b, m, alpha) if stats is None
                  else torch.stack([s[:m].float() for s in given], dim=1)
                  .contiguous())
    y = torch.zeros((m, n), dtype=torch.float32, device=x2.device)
    if y.numel() and rows.numel():
        err = _build.lib().repro_chain(
            rows.data_ptr(), cols.data_ptr(), a.data_ptr(), b.data_ptr(),
            _common.is_bf16(a), None if packed is None else packed.data_ptr(),
            x2.data_ptr(), _common.is_bf16(x2), y.data_ptr(), rows.shape[0],
            rows.shape[1], m, n, a.shape[1], _TRANSFORM_CODES[transform],
            _alpha(alpha), _common.stream_of(x2))
        _build.check(err, "chain")
        LAUNCHES["chain"] += 1
    y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def chain_unfused(rows, cols, a, b, x, *, shape, transform: str = "identity",
                  alpha=None, stats=None) -> torch.Tensor:
    """The chain as separate kernels, the edge stream materialised: K6
    scores, K7 statistics for softmax, the weights by elementwise tensor ops
    (the reference does that step outside any kernel too), then the
    nnz-balanced SpMM of the ``"hopper"`` backend (K1, or K2 for 1-D x) on
    ``BalancedCOO(rows, cols, w)``."""
    _check_transform(transform)
    m = int(shape[0])
    e = sddmm_fused(rows, cols, a, b, shape=shape)
    if transform == "softmax" and stats is None:
        stats = chain_stats_fused(rows, cols, a, b, shape=shape, alpha=alpha)
    r = rows.reshape(-1)
    w = chain_weights(e.reshape(-1), r, r < m, m, transform, alpha,
                      stats=stats)
    bal = BalancedCOO(rows, cols, w.reshape(rows.shape), tuple(shape))
    return registry.resolve("nb_pr", "hopper").fn(bal, x)


# ---------------------------------------------------------------------------
# registry: the Hopper entries of the chain family.  Their prep hook is the
# NB entries' geometry check; no visit schedule is needed.
# ---------------------------------------------------------------------------

def _hopper_sddmm(rows, cols, a, b, **kw):
    return sddmm_fused(rows, cols, a.contiguous(), b.contiguous(), **kw)


def _hopper_chain(rows, cols, a, b, x, *, fuse: bool = True, **kw):
    run = chain_fused if fuse else chain_unfused
    return run(rows, cols, a.contiguous(), b.contiguous(), x.contiguous(),
               **kw)


registry.register("sddmm", "hopper", "balanced", _hopper_sddmm,
                  prep=_prep_geometry)
registry.register("chain", "hopper", "balanced", _hopper_chain,
                  prep=_prep_geometry)
