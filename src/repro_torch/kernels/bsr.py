"""K11 — block-sparse (BSR) SpMM on Hopper, the block-granule ``"bsr"``
backend; counterpart of ``repro.kernels.bsr``.

``spmm_bsr`` replaces the TPU kernel ``src/repro/kernels/bsr.py::_bsr_kernel``:
``Y = A·X`` over the materialised ``(bm, bk)`` blocks, sums in f32, result
cast to ``x.dtype``.  Its CUDA source is ``repro_torch/csrc/bsr.cu``:

* bound — bytes at small N (each block is read once: 4·bm·bk B a block
  against 2·bm·bk·N flops), operations from about N = 32 in f32;
* design — one CTA per (block row, block of up to 128 columns of X).  The
  CTA's threads are (k-lane, column) pairs: columns own X columns, so X row
  loads coalesce; k-lanes split the row's flattened (block, k) range, so at
  N = 1 the whole CTA reads the row's blocks with coalesced loads.  Each
  thread keeps ``bm`` f32 sums in registers; the k-lanes reduce in shared
  memory and each output element is stored once, without atomics.

The kernel reads the BSR arrays (``indptr``, ``indices``, ``blocks``)
directly.  The TPU kernel pads every block row to the widest one
(block-ELL) because its grid must be rectangular; a CUDA CTA loops over its
own row's blocks, so padding slots would cost reads for nothing and a live
value stream would need a re-pad.  ``bsr_to_blockell`` and ``_prep_bell`` —
the reference's block-ELL layout and its live gather map — are kept as host
utilities, element-equal to the reference's.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..core.formats import BSR, bsr_block_rows

from . import _build, _common

#: launches of the K11 kernel since process start (or the last reset)
LAUNCHES = {"bsr_spmm": 0}

#: block rows the kernel keeps as per-thread f32 sums (registers)
MAX_BLOCK_ROWS = 64


def _bell_gather(bsr: BSR) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The block-ELL gather map: (Mb, WB) source block of each slot (0 on a
    padding slot), its validity, and the width WB (at least 1)."""
    indptr = bsr.indptr.long()
    lens = torch.diff(indptr)
    wb = max(1, int(lens.max())) if lens.numel() else 1
    slot = torch.arange(wb, device=indptr.device)[None, :]
    valid = slot < lens[:, None]
    src = torch.where(valid, indptr[:-1, None] + slot, 0)
    return src, valid, wb


def bsr_to_blockell(bsr: BSR) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Pad every block row to the widest one: ``(blocks, bcols, wb)`` with
    blocks ``(Mb, WB, bm, bk)`` (padding blocks zero) and bcols ``(Mb, WB)``
    int32 (padding 0) — the TPU kernel's layout."""
    src, valid, wb = _bell_gather(bsr)
    if bsr.nblocks == 0:
        return (bsr.blocks.new_zeros((src.shape[0], wb) + bsr.blocks.shape[1:]),
                torch.zeros(src.shape, dtype=torch.int32, device=src.device), wb)
    blocks = torch.where(valid[..., None, None], bsr.blocks[src], 0)
    bcols = torch.where(valid, bsr.indices[src], 0).int()
    return blocks, bcols, wb


def _prep_bell(bsr: BSR) -> dict:
    """The reference's block-ELL prep: the baked padded blocks with the
    flat block columns and WB (``blockell``), and the pattern-only gather
    map that re-pads live block values (``bell_src`` int32, ``bell_valid``)."""
    src, valid, _ = _bell_gather(bsr)
    blocks, bcols, wb = bsr_to_blockell(bsr)
    return {"blockell": (blocks, bcols.reshape(-1), wb),
            "bell_src": src.int(), "bell_valid": valid}


def spmm_bsr_plain(bsr: BSR, x: torch.Tensor) -> torch.Tensor:
    """K11's plain PyTorch version: each block times its gathered (bk, N)
    slab of X, summed into its block row in f32."""
    x2 = x[:, None] if x.ndim == 1 else x
    m, k = bsr.shape
    bm, bk = bsr.block_shape
    mb = bsr.indptr.shape[0] - 1
    n = x2.shape[1]
    kb = -(-k // bk)
    xp = torch.zeros((kb * bk, n), dtype=torch.float32, device=x2.device)
    xp[:k] = x2.float()
    slabs = xp.reshape(kb, bk, n).index_select(0, bsr.indices.long())
    prod = torch.bmm(bsr.blocks.float(), slabs)             # (nblocks, bm, N)
    y = torch.zeros((mb, bm, n), dtype=torch.float32, device=x2.device)
    y.index_add_(0, bsr_block_rows(bsr), prod)
    y = y.reshape(mb * bm, n)[:m].to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


def spmm_bsr(bsr: BSR, x: torch.Tensor) -> torch.Tensor:
    """K11: ``Y = A·X`` on the BSR substrate.  CPU operands take the plain
    version; CUDA operands launch the kernel or raise."""
    if _common.on_cpu("bsr_spmm", bsr.indptr, bsr.indices, bsr.blocks, x):
        return spmm_bsr_plain(bsr, x)
    m, k = bsr.shape
    bm, bk = bsr.block_shape
    x2 = _common.check_dense("bsr_spmm", x, k)
    for name, t in (("indptr", bsr.indptr), ("indices", bsr.indices)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"bsr_spmm: {name} must be contiguous int32")
    if bsr.blocks.dtype not in _common.FLOAT_TYPES or not bsr.blocks.is_contiguous():
        raise ValueError("bsr_spmm: blocks must be contiguous float32 or "
                         f"bfloat16, got {bsr.blocks.dtype}")
    if bsr.blocks.shape[1:] != (bm, bk):
        raise ValueError(f"bsr_spmm: blocks of shape {tuple(bsr.blocks.shape)} "
                         f"do not match the block shape {(bm, bk)}")
    if bm > MAX_BLOCK_ROWS:
        raise ValueError(f"bsr_spmm: block of {bm} rows > {MAX_BLOCK_ROWS}, "
                         "the sums a thread keeps in registers")
    mb = bsr.indptr.shape[0] - 1
    if mb != -(-m // bm):
        raise ValueError(f"bsr_spmm: indptr holds {mb} block rows, M={m} "
                         f"at bm={bm} needs {-(-m // bm)}")
    n = x2.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if y.numel():
        err = _build.lib().repro_bsr_spmm(
            bsr.indptr.data_ptr(), bsr.indices.data_ptr(),
            bsr.blocks.data_ptr(), _common.is_bf16(bsr.blocks), x2.data_ptr(),
            _common.is_bf16(x2), y.data_ptr(), mb, bm, bk, m, k, n,
            _common.stream_of(x2))
        _build.check(err, "bsr_spmm")
        LAUNCHES["bsr_spmm"] += 1
    y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


# ---------------------------------------------------------------------------
# registry: the block-granule backend.  All four logical kernels resolve to
# K11, as in the reference (block granularity subsumes both the balancing
# and the reduction axes).  Live value streams arrive as rebuilt blocks
# (``core/plan.py::execute``), which K11 reads as it reads baked ones.
# ---------------------------------------------------------------------------

def _bsr_entry(bsr: BSR, x: torch.Tensor):
    return spmm_bsr(bsr, x.contiguous())


for _logical in registry.MATMUL_KERNELS:
    registry.register(_logical, "bsr", "bsr", _bsr_entry)
