"""Shared layers; counterpart of ``repro.models.layers``.  Ported so far:
``rmsnorm`` and the sparse FFN — the paper as a feature: FFN weights pruned
to a fixed pattern, stored as a balanced value stream and executed through
the SpMM (``pattern_matmul``), differentiable in the values and the input.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.plan import execute_pattern
from ..core.registry import resolve_device


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x / rms(x) * (1 + w)``, the norm taken in f32 and cast back to
    ``x.dtype`` before the scale, as the reference does."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w.to(x.dtype))


@dataclasses.dataclass(frozen=True, eq=False)
class SparsePattern:
    """Frozen (non-trainable) sparsity pattern of one pruned weight matrix W
    (m, k) in the balanced layout: ``rows`` / ``cols`` ``(n_tiles, tile)``
    int32, row-major, the tail padded with ``rows == m``.  Its per-pattern
    prep (Wᵀ's slabs for the backward) is ``execute_pattern``'s, memoised on
    the ``rows`` tensor: built once while the pattern lives."""

    rows: torch.Tensor
    cols: torch.Tensor
    shape: tuple

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @staticmethod
    def random(seed: int, m: int, k: int, density: float, tile: int,
               device=None) -> "SparsePattern":
        """``max(m·k·density, 1)`` distinct positions drawn by
        ``numpy.random.default_rng(seed)`` — the reference's draw from the
        integer its key gives — sorted row-major and tiled.  ``device=None``
        is the card."""
        nnz = max(int(m * k * density), 1)
        rng = np.random.default_rng(int(seed))
        flat = rng.choice(m * k, size=nnz, replace=False)
        flat.sort()
        rows, cols = (flat // k).astype(np.int32), (flat % k).astype(np.int32)
        return SparsePattern.from_arrays(rows, cols, (m, k), tile, device)

    @staticmethod
    def from_arrays(rows, cols, shape, tile: int | None = None,
                    device=None) -> "SparsePattern":
        """A pattern from numpy ``rows`` / ``cols``: flat ones are tiled at
        ``tile`` (tail padded with ``rows == m``), ``(n_tiles, tile)`` slabs
        taken as they are.  ``device=None`` is the card."""
        rows, cols = np.array(rows, np.int32), np.array(cols, np.int32)
        if rows.ndim == 1:
            n_tiles = -(-len(rows) // tile)
            pad = n_tiles * tile - len(rows)
            rows = np.concatenate([rows, np.full(pad, shape[0], np.int32)])
            cols = np.concatenate([cols, np.zeros(pad, np.int32)])
            rows, cols = rows.reshape(n_tiles, tile), cols.reshape(n_tiles, tile)
        dev = resolve_device(device)
        return SparsePattern(torch.from_numpy(rows).to(dev),
                             torch.from_numpy(cols).to(dev), tuple(shape))

    @property
    def n_tiles(self) -> int:
        return int(self.rows.shape[0])

    def to_dense(self, vals: torch.Tensor) -> torch.Tensor:
        """W (m, k) with ``vals`` (one a slot) at the pattern's positions."""
        m, k = self.shape
        r, v = self.rows.reshape(-1), vals.reshape(-1)
        keep = r < m
        w = torch.zeros((m, k), dtype=vals.dtype, device=vals.device)
        return w.index_put((r[keep].long(), self.cols.reshape(-1)[keep].long()),
                           v[keep], accumulate=True)


def sparse_matmul(pattern: SparsePattern, vals: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """``x @ Wᵀ`` with W (m, k) sparse, as the SpMM ``W · xᵀ`` through
    ``pattern_matmul``: differentiable in ``vals`` and ``x``.  ``x`` is
    ``(..., k)``; the result ``(..., m)`` in ``x.dtype``."""
    flat = x.reshape(-1, x.shape[-1])                          # (T, k)
    y = execute_pattern(pattern.rows, pattern.cols, vals, pattern.shape,
                        flat.T)                                # (m, T)
    return y.T.reshape(x.shape[:-1] + (pattern.shape[0],)).to(x.dtype)


def sparse_mlp_apply(patterns: dict, p: dict, x: torch.Tensor,
                     act: str = "swiglu") -> torch.Tensor:
    """FFN with pruned weight matrices executed through the paper's SpMM:
    ``patterns`` and ``p`` keyed ``gate`` / ``up`` / ``down`` and
    ``v_gate`` / ``v_up`` / ``v_down``."""
    if act == "swiglu":
        h = (torch.nn.functional.silu(sparse_matmul(patterns["gate"],
                                                    p["v_gate"], x))
             * sparse_matmul(patterns["up"], p["v_up"], x))
    else:
        h = torch.nn.functional.gelu(
            sparse_matmul(patterns["up"], p["v_up"], x), approximate="tanh")
    return sparse_matmul(patterns["down"], p["v_down"], h)
