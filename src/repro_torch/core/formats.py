"""Sparse-matrix formats of the port (counterpart of ``repro.core.formats``).

Construction is an offline step, as in the paper's static-profiling usage:
host-side numpy then ``.to(device)`` (CSR, ELL), or torch on the CSR's device
(the balanced slabs, the BSR and the transpose).  Every container is a frozen
dataclass of tensors on one device, registered with ``torch.utils._pytree``
(its tensors are the leaves, shapes the static context), so a frozen
``PlanArtifact`` flattens to exactly its tensors.  Index arrays are int32.

CSR          canonical row-compressed storage (the paper's input format).
ELL          row-split padded storage — the substrate of the RS kernels —
             with each row's count of stored entries.
BalancedCOO  nnz-split tiled storage: exactly ``tile`` nonzeros per tile, the
             tail padded with ``row == M`` sentinels, zero values and column
             0.  Substrate of the NB kernels.
BSR          block-sparse rows: every (bm, bk) block holding a nonzero stored
             dense.  Substrate of the block-granule ``"bsr"`` backend.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree


def host(t: torch.Tensor) -> np.ndarray:
    """A numpy view (CPU tensors) or copy (device tensors) of ``t``."""
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row. indptr:(M+1,) indices:(nnz,) data:(nnz,)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "CSR":
        device = torch.device(device)
        if self.device == device:
            return self
        return CSR(self.indptr.to(device), self.indices.to(device),
                   self.data.to(device), self.shape)

    def to_dense(self) -> torch.Tensor:
        m, k = self.shape
        rows = torch.from_numpy(row_ids_from_indptr(host(self.indptr), self.nnz))
        out = torch.zeros((m, k), dtype=self.data.dtype, device=self.device)
        out.index_put_((rows.to(self.device).long(), self.indices.long()),
                       self.data, accumulate=True)
        return out


@dataclasses.dataclass(frozen=True)
class ELL:
    """Row-split padded format. cols/vals: (M, width); padding has vals==0
    and cols==0, so gathers stay in bounds.  lens: (M,) int32, the stored
    entries of each row (slots ``[0, lens[i])``; an explicit zero is stored),
    from the pattern and never from the values."""

    cols: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]
    lens: torch.Tensor

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])


@dataclasses.dataclass(frozen=True)
class BalancedCOO:
    """nnz-split tiled COO. rows/cols/vals: (n_tiles, tile).  Tiles may span
    row boundaries (paper §2.1.1); padding is rows==M, vals==0, cols==0."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]

    @property
    def n_tiles(self) -> int:
        return int(self.rows.shape[0])

    @property
    def tile(self) -> int:
        return int(self.rows.shape[1])


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse rows. indptr:(Mb+1,) indices:(nblocks,) block columns,
    blocks:(nblocks, bm, bk) dense.  The last block row and column may run
    past ``shape``; those entries are zero."""

    indptr: torch.Tensor
    indices: torch.Tensor
    blocks: torch.Tensor
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return int(self.indices.shape[0])


#: constructions per substrate since process start (or last reset); the plan
#: layer promises to build only the substrate the selected kernel consumes.
BUILD_COUNTS: dict[str, int] = {"ell": 0, "balanced": 0, "bsr": 0}


def reset_build_counts() -> dict[str, int]:
    """Zero the substrate-construction counters; returns the previous values."""
    prev = dict(BUILD_COUNTS)
    for k in BUILD_COUNTS:
        BUILD_COUNTS[k] = 0
    return prev


def row_ids_from_indptr(indptr: np.ndarray, nnz: int) -> np.ndarray:
    """Expand CSR indptr to a per-nonzero row-id vector (int32)."""
    indptr = np.asarray(indptr)
    return np.repeat(np.arange(len(indptr) - 1), np.diff(indptr)).astype(np.int32)[:nnz]


def _tensor(a: np.ndarray, dtype=None) -> torch.Tensor:
    # torch wants writable memory; read-only inputs (views of another
    # framework's buffers) are copied
    return torch.from_numpy(np.require(a, dtype, ["C", "W"]))


def _csr(indptr, indices, data, shape, device) -> CSR:
    return CSR(_tensor(indptr, np.int32).to(device),
               _tensor(indices, np.int32).to(device),
               _tensor(data).to(device), (int(shape[0]), int(shape[1])))


def csr_from_coo(rows, cols, vals, shape, dtype=np.float32, *,
                 device="cpu") -> CSR:
    """Build CSR from (possibly unsorted, possibly duplicated) COO triplets.
    Duplicates are summed, matching scipy semantics."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, dtype)
    m, k = shape
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        keep = np.ones(len(rows), bool)
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        grp = np.cumsum(keep) - 1
        vals = np.bincount(grp, weights=vals.astype(np.float64),
                           minlength=keep.sum()).astype(dtype)
        rows, cols = rows[keep], cols[keep]
    indptr = np.zeros(m + 1, np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)
    return _csr(indptr, cols.astype(np.int32), vals, (m, k), device)


def csr_from_dense(a, *, device="cpu") -> CSR:
    a = host(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    rows, cols = np.nonzero(a)
    return csr_from_coo(rows, cols, a[rows, cols], a.shape, a.dtype,
                        device=device)


def csr_transpose(csr: CSR) -> tuple[CSR, torch.Tensor]:
    """The CSR of Aᵀ and ``perm`` (int32): ``perm[j]`` is the position in
    A's nonzero stream of Aᵀ's j-th nonzero, so Aᵀ's values are
    ``csr.data[perm]``.  A stable sort of ``indices`` on the CSR's device:
    within a column of A, rows keep their order, so Aᵀ's rows are sorted
    too; empty rows and columns give empty columns and rows of Aᵀ."""
    m, k = csr.shape
    perm = torch.sort(csr.indices, stable=True).indices
    indptr = torch.zeros(k + 1, dtype=torch.int32, device=csr.device)
    indptr[1:] = torch.cumsum(torch.bincount(csr.indices.long(), minlength=k), 0)
    return (CSR(indptr, _row_ids(csr)[perm], csr.data[perm], (k, m)),
            perm.to(torch.int32))


def _row_ids(csr: CSR) -> torch.Tensor:
    """(nnz,) int32 row of each nonzero, on the CSR's device."""
    return torch.repeat_interleave(
        torch.arange(csr.shape[0], dtype=torch.int32, device=csr.device),
        torch.diff(csr.indptr.long()), output_size=csr.nnz)


def csr_to_ell(csr: CSR, width: int | None = None) -> ELL:
    """Row-split padded copy of ``csr``; rows longer than ``width`` are cut.
    Vectorised: each kept nonzero lands at (its row, its rank in the row)."""
    BUILD_COUNTS["ell"] += 1
    indptr = host(csr.indptr).astype(np.int64)
    indices = host(csr.indices)
    m, _ = csr.shape
    lens = np.diff(indptr)
    w = (int(lens.max()) if m else 0) if width is None else int(width)
    w = max(w, 1)
    rows = row_ids_from_indptr(indptr, len(indices)).astype(np.int64)
    rank = np.arange(len(indices), dtype=np.int64) - indptr[rows]
    keep = np.nonzero(rank < w)[0]
    slot = rows[keep] * w + rank[keep]
    cols = np.zeros(m * w, np.int32)
    cols[slot] = indices[keep]
    dev = csr.device
    vals = torch.zeros(m * w, dtype=csr.data.dtype, device=dev)
    vals[torch.from_numpy(slot).to(dev)] = csr.data[torch.from_numpy(keep).to(dev)]
    return ELL(torch.from_numpy(cols.reshape(m, w)).to(dev), vals.reshape(m, w),
               csr.shape,
               torch.from_numpy(np.minimum(lens, w).astype(np.int32)).to(dev))


def _tiled(rows: torch.Tensor, cols: torch.Tensor, m: int, tile: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """A flat (row, col) stream chopped into ``tile``-slot slabs, the tail
    padded with ``row == m`` sentinels and column 0."""
    n_tiles = max(1, -(-rows.numel() // tile))
    pad = n_tiles * tile - rows.numel()
    return (torch.nn.functional.pad(rows, (0, pad), value=m).reshape(n_tiles, tile),
            torch.nn.functional.pad(cols, (0, pad)).reshape(n_tiles, tile))


def balanced_pattern(csr: CSR, tile: int = 512
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(rows, cols)`` slabs of ``csr_to_balanced``, without values,
    built on the CSR's device."""
    return _tiled(_row_ids(csr), csr.indices.to(torch.int32), csr.shape[0],
                  tile)


def csr_to_balanced(csr: CSR, tile: int = 512) -> BalancedCOO:
    """nnz-split: chop the row-major nonzero stream into fixed ``tile``
    quotas — the paper's workload-balancing step (Fig. 2(e))."""
    BUILD_COUNTS["balanced"] += 1
    rows, cols = balanced_pattern(csr, tile)
    vals = torch.nn.functional.pad(csr.data, (0, rows.numel() - csr.nnz))
    return BalancedCOO(rows, cols, vals.reshape(rows.shape), csr.shape)


def balanced_transpose(rows: torch.Tensor, cols: torch.Tensor, shape
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slabs of Aᵀ for a balanced pattern of A (``shape`` (M, K),
    padding ``rows >= M`` anywhere): Aᵀ's ``(rows, cols)`` at the same tile,
    its rows sorted (padding ``K``), and ``perm`` (int32), the flat slot of
    A's slabs each of Aᵀ's nonzeros comes from.  A stable sort of the
    columns on the pattern's device."""
    m, k = (int(s) for s in shape)
    r, c = rows.reshape(-1), cols.reshape(-1)
    slots = torch.nonzero(r < m).squeeze(1)
    c_live = c.index_select(0, slots)
    order = torch.sort(c_live, stable=True).indices
    perm = slots.index_select(0, order)
    rows_t, cols_t = _tiled(c_live.index_select(0, order).to(torch.int32),
                            r.index_select(0, perm).to(torch.int32), k,
                            rows.shape[1])
    return rows_t, cols_t, perm.to(torch.int32)


def bsr_slots(csr: CSR, bm: int, bk: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each CSR nonzero lands in ``csr_to_bsr``'s blocks: the sorted
    unique block keys (block row · Kb + block column, int64) and the (3, nnz)
    int64 scatter map (block id, row in the block, column in the block).
    Computed on the CSR's device."""
    m, k = csr.shape
    kb = -(-k // bk)
    dev = csr.device
    rows = torch.repeat_interleave(
        torch.arange(m, device=dev), torch.diff(csr.indptr.long()),
        output_size=csr.nnz)
    cols = csr.indices.long()
    keys, inv = torch.unique(rows // bm * kb + cols // bk, sorted=True,
                             return_inverse=True)
    return keys, torch.stack([inv, rows % bm, cols % bk])


def csr_to_bsr(csr: CSR, bm: int = 8, bk: int = 128) -> BSR:
    """Coarsen to (bm, bk) dense blocks: every block holding a nonzero is
    materialised, blocks in sorted (block row, block column) order and
    duplicate nonzeros summed — the reference's ``csr_to_bsr`` element for
    element, computed on the CSR's device."""
    BUILD_COUNTS["bsr"] += 1
    m, k = csr.shape
    mb, kb = -(-m // bm), -(-k // bk)
    keys, slots = bsr_slots(csr, bm, bk)
    blocks = torch.zeros((keys.shape[0], bm, bk), dtype=csr.data.dtype,
                         device=csr.device)
    blocks.index_put_(tuple(slots), csr.data, accumulate=True)
    counts = torch.bincount(keys // kb, minlength=mb)
    indptr = torch.zeros(mb + 1, dtype=torch.int32, device=csr.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return BSR(indptr, (keys % kb).int(), blocks, csr.shape, (bm, bk))


def bsr_block_rows(bsr: BSR) -> torch.Tensor:
    """(nblocks,) int64 block row of each stored block."""
    mb = bsr.indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(mb, device=bsr.indptr.device),
        torch.diff(bsr.indptr.long()), output_size=bsr.nblocks)


def bsr_to_dense(bsr: BSR) -> torch.Tensor:
    """The dense (M, K) matrix of ``bsr`` (a test utility)."""
    m, k = bsr.shape
    bm, bk = bsr.block_shape
    mb, kb = bsr.indptr.shape[0] - 1, -(-k // bk)
    grid = bsr.blocks.new_zeros((mb, kb, bm, bk))
    grid[bsr_block_rows(bsr), bsr.indices.long()] = bsr.blocks
    return grid.permute(0, 2, 1, 3).reshape(mb * bm, kb * bk)[:m, :k]


def _register_pytree(cls, tensor_fields: tuple[str, ...]) -> None:
    """Register a container with ``torch.utils._pytree``: its tensor fields
    that are not None are the children, the rest (shapes) the context."""
    static_fields = tuple(f.name for f in dataclasses.fields(cls)
                          if f.name not in tensor_fields)

    def flatten(obj):
        present = tuple(f for f in tensor_fields if getattr(obj, f) is not None)
        static = tuple(getattr(obj, f) for f in static_fields)
        return [getattr(obj, f) for f in present], (present, static)

    def unflatten(values, context):
        present, static = context
        kw = dict.fromkeys(tensor_fields)
        kw.update(zip(static_fields, static))
        kw.update(zip(present, values))
        return cls(**kw)

    pytree.register_pytree_node(
        cls, flatten, unflatten,
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")


for _cls, _fields in ((CSR, ("indptr", "indices", "data")),
                      (ELL, ("cols", "vals", "lens")),
                      (BalancedCOO, ("rows", "cols", "vals")),
                      (BSR, ("indptr", "indices", "blocks"))):
    _register_pytree(_cls, _fields)
