"""The deprecated kernel front door; counterpart of ``repro.kernels.ops``'s
``spmm``.  ``repro_torch.api.sparse(csr) @ x`` replaces it."""
from __future__ import annotations

import warnings

import torch

from ..core.selector import PreparedMatrix, SelectorThresholds


def spmm(prep, x: torch.Tensor, *, impl: str | None = None,
         th: SelectorThresholds = SelectorThresholds(),
         force_hopper: bool = False, device=None) -> torch.Tensor:
    """Deprecated: use ``repro_torch.api.sparse`` (``m = sparse(csr); m @
    x``).  ``prep`` is a ``PreparedMatrix`` or a CSR (planned on
    ``device``, the card for None); ``force_hopper`` runs the Hopper
    kernels whatever the plan's backend (the reference's
    ``force_pallas``)."""
    warnings.warn("repro_torch.kernels.spmm is deprecated; use "
                  "repro_torch.api.sparse", DeprecationWarning, stacklevel=2)
    from ..api import sparse
    m = (prep._matrix if isinstance(prep, PreparedMatrix)
         else sparse(prep, device=device))
    return m.with_thresholds(th).matmul(
        x, impl=impl, backend="hopper" if force_hopper else None)
