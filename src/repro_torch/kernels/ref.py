"""Plain PyTorch oracles; counterpart of ``repro.kernels.ref``.

The simplest scatter-add formulation, independent of ``core/spmm.py`` and
of the Hopper kernels, so tests cross-check three ways.  Sums in f32, result
cast back to ``x.dtype``.
"""
from __future__ import annotations

import torch

from ..core.formats import CSR, ELL, BalancedCOO, host, row_ids_from_indptr


def ref_spmm_coo(rows, cols, vals, m: int, x: torch.Tensor) -> torch.Tensor:
    """Y[r] += v * X[c] — the definition.  ``rows`` may hold the padding
    sentinel ``m`` (dropped)."""
    x2 = x[:, None] if x.ndim == 1 else x
    p = vals.reshape(-1, 1).float() * x2[cols.long()].float()
    out = torch.zeros((m + 1, x2.shape[1]), dtype=torch.float32, device=x2.device)
    out.index_put_((rows.long(),), p, accumulate=True)
    out = out[:m].to(x2.dtype)
    return out[:, 0] if x.ndim == 1 else out


def ref_spmm_csr(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    rows = torch.from_numpy(row_ids_from_indptr(host(csr.indptr), csr.nnz))
    return ref_spmm_coo(rows.to(x.device), csr.indices, csr.data, csr.shape[0], x)


def ref_spmm_ell(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    m = ell.shape[0]
    rows = torch.arange(m, device=x.device).repeat_interleave(ell.width)
    return ref_spmm_coo(rows, ell.cols.reshape(-1), ell.vals.reshape(-1), m, x)


def ref_spmm_balanced(bal: BalancedCOO, x: torch.Tensor) -> torch.Tensor:
    return ref_spmm_coo(bal.rows.reshape(-1), bal.cols.reshape(-1),
                        bal.vals.reshape(-1), bal.shape[0], x)


def ref_segment_reduce(p: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Oracle for an in-kernel segment reduction: a plain segment sum."""
    out = p.new_zeros((num_segments,) + tuple(p.shape[1:]))
    return out.index_add_(0, seg_ids, p)
