"""The paper's 2x2 implementation space and the SDDMM→SpMM chain as plain
PyTorch — the ``"torch"`` backend; counterpart of ``repro.core.spmm``.

These lowerings are the CPU path and the oracle the Hopper kernels are held
to.  RS = row-split, NB = nnz-balanced (workload balancing); SR = sequential
reduction, PR = parallel reduction.

  rs_sr  CSR-Scalar / RowSplit   (ELL, a loop over the width)
  rs_pr  CSR-Vector              (ELL, materialise + tree sum, width slabs)
  nb_sr  MergePath-style         (BalancedCOO, slabs of tiles in sequence)
  nb_pr  VSR, paper §2.1.1       (BalancedCOO, one flat segment sum)

Padding rows (``rows == M``) of the balanced substrate land in an extra
output row that is cut off, exactly as ``segment_sum(num_segments=M+1)``
drops them in the reference.  Sums run in f32 when either operand is bf16 or
f16, and the result is cast back to ``x.dtype``.

The chain half (DESIGN.md §9) samples ``A @ Bᵀ`` at the pattern's nonzeros
(SDDMM), transforms the edge scores per row (identity / scale / masked
softmax) and feeds them to ``spmm_nb_pr`` over the same pattern; these
lowerings materialise the edge stream, as the reference's xla ones do.
Block-sparse attention (DESIGN.md §10) is the softmax chain with
``alpha = scale`` plus an additive per-edge bias: ``attn_stats_torch`` and
``attn_chain_torch``.
"""
from __future__ import annotations

import torch

from . import registry
from .formats import ELL, BalancedCOO
from .quant import dequantize_stream, is_quantized_dtype, quantize_stream


def _as_2d(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if x.ndim == 1:
        return x[:, None], True
    return x, False


def _acc_dtype(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    p = torch.promote_types(a, b)
    if p in (torch.bfloat16, torch.float16):
        return torch.promote_types(p, torch.float32)
    return p


def _finish(out: torch.Tensor, x2: torch.Tensor, squeeze: bool) -> torch.Tensor:
    out = out.to(x2.dtype)
    return out[:, 0] if squeeze else out


#: element budget of the partial products one reduction step materialises
#: (rs_pr's (M, width_slab, N) and nb_sr's (slab_nnz, N)); 64 MiB at f32
RS_PR_SLAB_ELEMS = 1 << 24


# ---------------------------------------------------------------------------
# RS (row-split) kernels on ELL
# ---------------------------------------------------------------------------

def spmm_rs_sr(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """Row-split + sequential reduction: one gathered column slab of the ELL
    per step, added into a running (M, N) sum."""
    x2, squeeze = _as_2d(x)
    m = ell.shape[0]
    acc = _acc_dtype(ell.vals.dtype, x2.dtype)
    out = torch.zeros((m, x2.shape[1]), dtype=acc, device=x2.device)
    for j in range(ell.width):
        xg = x2.index_select(0, ell.cols[:, j])
        out += ell.vals[:, j, None].to(acc) * xg.to(acc)
    return _finish(out, x2, squeeze)


def spmm_rs_pr(ell: ELL, x: torch.Tensor, *,
               slab_elems: int | None = None) -> torch.Tensor:
    """Row-split + parallel reduction: all (M, width, N) partial products
    tree-summed over the width — or, above ``slab_elems`` elements, width
    slabs summed in turn (memory bounded by the budget)."""
    x2, squeeze = _as_2d(x)
    m, w = ell.cols.shape
    n = x2.shape[1]
    acc = _acc_dtype(ell.vals.dtype, x2.dtype)
    budget = RS_PR_SLAB_ELEMS if slab_elems is None else slab_elems
    ws = w if m * w * n <= budget else max(1, budget // max(m * n, 1))
    out = torch.zeros((m, n), dtype=acc, device=x2.device)
    for s in range(0, w, ws):
        cols = ell.cols[:, s:s + ws]
        xg = x2.index_select(0, cols.reshape(-1)).reshape(m, cols.shape[1], n)
        out += (ell.vals[:, s:s + ws, None].to(acc) * xg.to(acc)).sum(dim=1)
    return _finish(out, x2, squeeze)


# ---------------------------------------------------------------------------
# NB (nnz-balanced) kernels on BalancedCOO
# ---------------------------------------------------------------------------

def spmm_nb_pr(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    """nnz-balanced + parallel reduction — the VSR algorithm (paper §2.1.1):
    every partial product of the stream reduced by one segment sum keyed on
    row ids (``index_add_``)."""
    x2, squeeze = _as_2d(x)
    m = bal.shape[0]
    acc = _acc_dtype(bal.vals.dtype, x2.dtype)
    p = (bal.vals.reshape(-1, 1).to(acc)
         * x2.index_select(0, bal.cols.reshape(-1)).to(acc))
    out = torch.zeros((m + 1, x2.shape[1]), dtype=acc, device=x2.device)
    out.index_add_(0, bal.rows.reshape(-1), p)
    return _finish(out[:m], x2, squeeze)


def spmm_nb_sr(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    """nnz-balanced + sequential reduction (MergePath-flavoured): slabs of
    whole tiles are walked in order, each scatter-added into the running
    output, so the partial products never exceed ``RS_PR_SLAB_ELEMS``."""
    x2, squeeze = _as_2d(x)
    m = bal.shape[0]
    n = x2.shape[1]
    acc = _acc_dtype(bal.vals.dtype, x2.dtype)
    out = torch.zeros((m + 1, n), dtype=acc, device=x2.device)
    step = max(1, RS_PR_SLAB_ELEMS // max(bal.tile * n, 1))
    for t0 in range(0, bal.n_tiles, step):
        cols = bal.cols[t0:t0 + step].reshape(-1)
        p = (bal.vals[t0:t0 + step].reshape(-1, 1).to(acc)
             * x2.index_select(0, cols).to(acc))
        out.index_add_(0, bal.rows[t0:t0 + step].reshape(-1), p)
    return _finish(out[:m], x2, squeeze)


def spmm_as_n_spmv(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    """Paper §2.1.2 baseline: N column-by-column SpMVs, each re-gathering the
    sparse stream — the redundant loads VDL removes."""
    x2, squeeze = _as_2d(x)
    cols = [spmm_nb_pr(bal, x2[:, j]) for j in range(x2.shape[1])]
    out = (torch.stack(cols, dim=1) if cols
           else x2.new_zeros((bal.shape[0], 0)))
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# SDDMM and the unfused chain: the GNN pair on the balanced slab's pattern
# ---------------------------------------------------------------------------

#: per-row transforms the chain supports between its SDDMM and SpMM halves
CHAIN_TRANSFORMS: tuple[str, ...] = ("identity", "scale", "softmax")

#: masked-softmax sentinel: a finite stand-in for -inf, so an empty row's
#: max stays finite and no ``inf - inf`` NaN can arise
SOFTMAX_NEG = -1e30

#: row-sum floor of the masked-softmax divide: an empty row (sum 0) gives
#: zero weights, not NaN
SOFTMAX_EPS = 1e-30


def _sddmm_flat(r, c, a, b, valid):
    """Flat edge scores ``e[i] = <A[r[i]], B[c[i]]>`` in f32, 0 at padding
    (whose row id ``M`` is never used as an index)."""
    ag = a.index_select(0, torch.where(valid, r, 0)).float()
    bg = b.index_select(0, torch.where(valid, c, 0)).float()
    return torch.where(valid, (ag * bg).sum(dim=-1), 0.0)


def _softmax_stats(z, r, valid, m):
    """Per-row (max, sum of exp) of masked scores, each ``(m + 1,)``.  Empty
    rows keep ``(SOFTMAX_NEG, 0)``; padding slots land in row ``m``."""
    rr = torch.where(valid, r, m).long()
    zm = torch.where(valid, z, SOFTMAX_NEG)
    rm = torch.full((m + 1,), SOFTMAX_NEG, dtype=torch.float32, device=z.device)
    rm = rm.scatter_reduce(0, rr, zm, reduce="amax", include_self=True)
    p = torch.where(valid, torch.exp(z - rm[rr]), 0.0)
    rs = torch.zeros(m + 1, dtype=torch.float32, device=z.device).index_add_(0, rr, p)
    return rm, rs


def chain_weights(e, r, valid, m, transform: str, alpha, stats=None):
    """The chain's per-row transform of flat f32 edge scores: ``identity``,
    ``scale`` (times ``alpha``) or ``softmax``, the masked row softmax of
    ``alpha * e`` (empty rows give all-zero weights).  ``stats`` replaces the
    local ``(row_max, row_sum)`` statistics, each indexable by row id."""
    al = 1.0 if alpha is None else float(alpha)
    if transform == "identity":
        return torch.where(valid, e, 0.0)
    if transform == "scale":
        return torch.where(valid, al * e, 0.0)
    if transform == "softmax":
        return attn_weights(e, 0.0, r, valid, m, al, stats=stats)
    raise ValueError(f"unknown chain transform {transform!r}; expected one "
                     f"of {CHAIN_TRANSFORMS}")


def attn_weights(e, bias, r, valid, m, scale, stats=None):
    """Masked row softmax of ``scale * e + bias``, the attention chain's
    transform (DESIGN.md §10).  ``bias`` is the flat per-edge additive bias;
    ``stats`` replaces the local ``(row_max, row_sum)``, each indexable by
    row id, as in :func:`chain_weights`."""
    z = float(scale) * e + bias
    rr = torch.where(valid, r, 0).long()
    rm, rs = _softmax_stats(z, r, valid, m) if stats is None else stats
    p = torch.where(valid, torch.exp(z - rm[rr]), 0.0)
    return p / torch.clamp(rs[rr], min=SOFTMAX_EPS)


def _flat_pattern(rows, m):
    r = rows.reshape(-1)
    return r, r < m


def sddmm_torch(rows, cols, a, b, *, shape, **_opts) -> torch.Tensor:
    """SDDMM over a balanced-layout pattern: f32 scores shaped like
    ``rows``, 0 at padding slots.  ``execute_sddmm`` flattens to the
    CSR-ordered ``(nnz,)`` stream."""
    r, valid = _flat_pattern(rows, int(shape[0]))
    return _sddmm_flat(r, cols.reshape(-1), a, b, valid).reshape(rows.shape)


def chain_stats_torch(rows, cols, a, b, *, shape, alpha=None, **_opts):
    """Per-row softmax statistics of ``alpha`` times the edge scores, each
    ``(m + 1,)`` — the reference's ``chain_stats_xla``."""
    m = int(shape[0])
    r, valid = _flat_pattern(rows, m)
    e = _sddmm_flat(r, cols.reshape(-1), a, b, valid)
    al = 1.0 if alpha is None else float(alpha)
    return _softmax_stats(al * e, r, valid, m)


def chain_edge_weights(rows, cols, a, b, *, shape,
                       transform: str = "identity", alpha=None, stats=None
                       ) -> torch.Tensor:
    """The chain's f32 edge weights ``T(e)`` shaped like ``rows``, 0 at
    padding: the first half of ``chain_torch``, and the recompute of the
    chain's backward on the ``"torch"`` backend."""
    m = int(shape[0])
    r, valid = _flat_pattern(rows, m)
    e = _sddmm_flat(r, cols.reshape(-1), a, b, valid)
    return chain_weights(e, r, valid, m, transform, alpha,
                         stats=stats).reshape(rows.shape)


def chain_torch(rows, cols, a, b, x, *, shape, transform: str = "identity",
                alpha=None, stats=None, **_opts) -> torch.Tensor:
    """Unfused SDDMM → transform → SpMM: the edge stream is materialised and
    fed to ``spmm_nb_pr``.  ``stats`` replaces the softmax statistics."""
    w = chain_edge_weights(rows, cols, a, b, shape=shape, transform=transform,
                           alpha=alpha, stats=stats)
    return spmm_nb_pr(BalancedCOO(rows, cols, w, tuple(shape)), x)


def attn_stats_torch(rows, cols, q, k, bias, *, shape, scale=1.0, **_opts):
    """Per-row softmax statistics of ``scale * QKᵀ + bias`` at the pattern,
    each ``(m + 1,)`` — the reference's ``attn_stats_xla``.  ``bias`` is a
    slab shaped like ``rows``."""
    m = int(shape[0])
    r, valid = _flat_pattern(rows, m)
    e = _sddmm_flat(r, cols.reshape(-1), q, k, valid)
    z = float(scale) * e + bias.reshape(-1).float()
    return _softmax_stats(z, r, valid, m)


def attn_edge_weights(rows, cols, q, k, bias, *, shape, scale=1.0,
                      stats=None) -> torch.Tensor:
    """Attention's f32 edge weights, the masked softmax of ``scale * e +
    bias`` shaped like ``rows``, 0 at padding: the first half of
    ``attn_chain_torch``, and the recompute of attention's backward on the
    ``"torch"`` backend."""
    m = int(shape[0])
    r, valid = _flat_pattern(rows, m)
    e = _sddmm_flat(r, cols.reshape(-1), q, k, valid)
    return attn_weights(e, bias.reshape(-1).float(), r, valid, m, scale,
                        stats=stats).reshape(rows.shape)


def attn_chain_torch(rows, cols, q, k, bias, v, *, shape, scale=1.0,
                     stats=None, **_opts) -> torch.Tensor:
    """Unfused attention: SDDMM QKᵀ → masked softmax of ``scale * e +
    bias`` → SpMM against V, the edge stream materialised (the reference's
    ``attn_chain_xla``).  ``stats`` replaces the softmax statistics."""
    w = attn_edge_weights(rows, cols, q, k, bias, shape=shape, scale=scale,
                          stats=stats)
    return spmm_nb_pr(BalancedCOO(rows, cols, w, tuple(shape)), v)


def _ignore_opts(fn):
    """Registry signature of the plain matmul entries: the opts of other
    backends' prep hooks and callers (``spill``, ...) are accepted and
    ignored, as the reference's xla entries do."""
    def entry(sub, x, **_opts):
        return fn(sub, x)
    return entry


def _quant_nb(fn):
    """Registry signature of the plain nnz-balanced entries, aware of
    quantized plans as the reference's ``_xla_nb`` is: a baked slab of codes
    is decoded with its ``scales``; a live float stream on a quantized plan
    (``quant``) goes through ``quantize_stream`` and ``dequantize_stream``,
    so this backend sees the numbers the Hopper kernels see.  Other opts
    are ignored."""
    def entry(sub, x, *, scales=None, quant=None, **_opts):
        if is_quantized_dtype(sub.vals.dtype):
            if scales is None:
                raise ValueError("a quantized value stream needs its per-tile "
                                 "scales")
            sub = BalancedCOO(sub.rows, sub.cols,
                              dequantize_stream(sub.vals, scales), sub.shape)
        elif quant is not None:
            sub = BalancedCOO(sub.rows, sub.cols,
                              dequantize_stream(*quantize_stream(sub.vals, quant)),
                              sub.shape)
        return fn(sub, x)
    return entry


for _name, _fn, _wrap, _sub in (("rs_sr", spmm_rs_sr, _ignore_opts, "ell"),
                                ("rs_pr", spmm_rs_pr, _ignore_opts, "ell"),
                                ("nb_sr", spmm_nb_sr, _quant_nb, "balanced"),
                                ("nb_pr", spmm_nb_pr, _quant_nb, "balanced")):
    registry.register(_name, "torch", _sub, _wrap(_fn))
registry.register("sddmm", "torch", "balanced", sddmm_torch)
registry.register("chain", "torch", "balanced", chain_torch)
registry.register("attn_chain", "torch", "balanced", attn_chain_torch)


# ---------------------------------------------------------------------------
# deprecation shim — the trainable front door lives in core.plan
# ---------------------------------------------------------------------------

def spmm_nb_pr_trainable(bal_static: tuple, vals: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Deprecated: use ``repro_torch.core.plan.execute_pattern`` (the
    differentiable front door of all four logical kernels).
    ``bal_static`` is ``(rows, cols, shape)`` of a balanced pattern."""
    import warnings
    warnings.warn("spmm_nb_pr_trainable is deprecated; use "
                  "repro_torch.core.plan.execute_pattern", DeprecationWarning,
                  stacklevel=2)
    from .plan import execute_pattern
    rows, cols, shape = bal_static
    return execute_pattern(rows, cols, vals, tuple(shape), x, impl="nb_pr")
