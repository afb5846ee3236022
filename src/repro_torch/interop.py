"""Carry the reference package's state into the port.

The reference's "weights" are its CSR and its calibrated thresholds.  This
module turns a reference CSR's arrays — numpy ``indptr``, ``indices``,
``data`` and ``shape``, e.g. ``np.asarray(csr.indptr)`` — and a thresholds
JSON into the port's objects.  It imports nothing of the reference: only
arrays and text cross over.
"""
from __future__ import annotations

import numpy as np

from .core.formats import CSR, _csr
from .core.selector import SelectorThresholds


def csr_from_arrays(indptr, indices, data, shape, *, device="cpu") -> CSR:
    """The port's CSR from a reference CSR's arrays (values keep their
    dtype, index arrays become int32, the shape Python ints)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    if len(indptr) != int(shape[0]) + 1 or len(indices) != len(np.asarray(data)):
        raise ValueError("indptr must have shape[0] + 1 entries and indices "
                         "one per value")
    return _csr(indptr, indices, np.asarray(data), shape, device)


def thresholds_from_json(text: str) -> SelectorThresholds:
    """The port's thresholds from a reference thresholds JSON (v1-v5)."""
    return SelectorThresholds.from_json(text)
