"""K11 — block-sparse (BSR) SpMM on Hopper, the block-granule ``"bsr"``
backend; counterpart of ``repro.kernels.bsr``.

``spmm_bsr`` replaces the TPU kernel ``src/repro/kernels/bsr.py::_bsr_kernel``:
``Y = A·X`` over the materialised ``(bm, bk)`` blocks, sums in f32, result
cast to ``x.dtype``.  Its CUDA source is ``repro_torch/csrc/bsr.cu``, whose
note gives the bound — the block stream (each block read once: 4·bm·bk B
against 2·bm·bk·N flops) up to N ≈ 100 in f32, operations above — and two
designs, routed per call by ``_design``:

* **the tensor-core design** (``"tc"``) when bm is a multiple of 8 up to
  ``GROUP_ROWS``, bk a multiple of the MMA's depth (8 in f32, 16 in bf16),
  blocks and X share one type, the blocks are 16-byte aligned and N ≥
  ``TC_MIN_N``.  A CTA owns a group of
  ``GROUP_ROWS // bm`` block rows and a tile of N; it stages each X slab the
  group touches once, by ``cp.async``, and computes ``Yᵀ = Xᵀ·Wᵀ`` on
  ``mma.sync`` (N is the MMA's m, the block's rows its n; 3×TF32 in f32).
  A row without a block at a column issues no product there, so an inf or
  NaN in that X slab never reaches it.  It reads the pattern through a
  ``BsrGroups`` layout (``build_groups``), built once a plan by the entry's
  prep hook and reused by live value streams;
* **the fma design** (``"fma"``) for every other call (N = 1 and 4 on the
  default path, and Aᵀ's ``(bk, bm)`` blocks in the backward when bk >
  ``GROUP_ROWS``): one CTA per (block row, ≤ 128 columns of X, chunk of
  ≤ ``MAX_BLOCK_ROWS`` rows of the block) on the CUDA cores, straight from
  ``indptr``.

``DESIGN_LAUNCHES`` counts each design's launches.  ``spmm_bsr_plain`` is
the oracle the kernels are held to; ``spmm_bsr_groups_plain`` evaluates the
tensor-core design's walk of the layout in PyTorch.  The TPU kernel's
block-ELL layout (every block row padded to the widest one) is not the
card's: ``bsr_to_blockell`` and ``_prep_bell`` are kept as host utilities,
element-equal to the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import registry
from ..core.formats import BSR, bsr_block_rows

from . import _build, _common

#: launches of the K11 kernel since process start (or the last reset)
LAUNCHES = {"bsr_spmm": 0}
#: K11's launches by design: "tc" (tensor cores, the group layout) or "fma"
DESIGN_LAUNCHES = {"bsr_spmm": {"tc": 0, "fma": 0}}

#: block rows the fma design keeps as per-thread f32 sums (registers); a
#: taller block is cut into chunks of 16 rows, a CTA each
MAX_BLOCK_ROWS = 64
#: output rows of a group in the tensor-core design (eight n8 MMA tiles)
GROUP_ROWS = 64
#: least N the tensor-core design takes; below it the fma design
TC_MIN_N = 8


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


# ---------------------------------------------------------------------------
# the group layout of the tensor-core design
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BsrGroups:
    """A BSR pattern cut into groups of ``group_blocks`` consecutive block
    rows, for the tensor-core design.

    For group ``i`` the entries ``ptr[i]:ptr[i + 1]`` are the distinct block
    columns its rows hold a block in, ascending (``cols``), and ``blocks[e,
    j]`` is the index of member row ``j``'s block at entry ``e``'s column in
    the BSR's block array, −1 where it has none.  ``tiles`` is what the
    kernel reads: for each entry and each of a group's eight n8 row tiles
    (``GROUP_ROWS`` rows), the tile's first row in the ``(nblocks·bm, bk)``
    block array, −1 where its block row has none (None when bm is not a
    multiple of 8 or a group holds more than ``GROUP_ROWS`` rows).  It
    depends on the pattern only, so live block values
    (``core/plan.py::execute``) reuse it.  ``distinct`` says whether no
    (block row, column) holds two blocks — a BSR from ``csr_to_bsr`` never
    does; one that does goes to the fma design."""

    group_blocks: int
    ptr: torch.Tensor        # (n_groups + 1,) int32
    cols: torch.Tensor       # (n_entries,) int32
    blocks: torch.Tensor     # (n_entries, group_blocks) int32
    tiles: torch.Tensor | None   # (n_entries, 8) int32
    distinct: bool
    indptr: torch.Tensor     # the pattern it was built for
    indices: torch.Tensor
    block_shape: tuple

    @property
    def n_groups(self) -> int:
        return int(self.ptr.shape[0]) - 1

    def matches(self, bsr: BSR) -> bool:
        """Whether this layout was built for ``bsr``'s pattern: the same
        block shape and ``(indptr, indices)`` tensors, or equal ones."""
        if tuple(bsr.block_shape) != self.block_shape:
            return False
        if bsr.indptr is self.indptr and bsr.indices is self.indices:
            return True
        return (bsr.indptr.shape == self.indptr.shape
                and bsr.indices.shape == self.indices.shape
                and bsr.indptr.device == self.indptr.device
                and torch.equal(bsr.indptr, self.indptr)
                and torch.equal(bsr.indices, self.indices))


def group_blocks_for(bm: int, group_rows: int = GROUP_ROWS) -> int:
    """Block rows of a group: as many as fill ``group_rows`` output rows."""
    return max(1, group_rows // bm)


def build_groups(bsr: BSR, group_rows: int = GROUP_ROWS) -> BsrGroups:
    """The group layout of ``bsr``, with torch ops on its device."""
    bm, bk = bsr.block_shape
    mb = bsr.indptr.shape[0] - 1
    kb = -(-bsr.shape[1] // bk)
    g = group_blocks_for(bm, group_rows)
    n_groups = -(-mb // g)
    dev = bsr.indptr.device
    brow = bsr_block_rows(bsr)
    key = (brow // g) * kb + bsr.indices.long()
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    slot = (inv, brow % g)
    blocks = torch.full((uniq.shape[0], g), -1, dtype=torch.int32, device=dev)
    blocks[slot] = torch.arange(bsr.nblocks, dtype=torch.int32, device=dev)
    held = torch.zeros((uniq.shape[0], g), dtype=torch.int32, device=dev)
    held.index_put_(slot, torch.ones_like(inv, dtype=torch.int32),
                    accumulate=True)
    distinct = bsr.nblocks == 0 or int(held.max()) <= 1
    ptr = torch.zeros(n_groups + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(uniq // kb, minlength=n_groups), 0)
    tiles = None
    if bm % 8 == 0 and g * bm <= GROUP_ROWS:
        j = torch.arange(g * bm // 8, device=dev)
        member = blocks[:, j // (bm // 8)]
        tiles = torch.full((uniq.shape[0], GROUP_ROWS // 8), -1,
                           dtype=torch.int32, device=dev)
        tiles[:, :j.shape[0]] = torch.where(
            member >= 0, member * bm + (j % (bm // 8)).int() * 8, -1)
    return BsrGroups(g, ptr, (uniq % kb).int(), blocks, tiles, distinct,
                     bsr.indptr, bsr.indices, tuple(bsr.block_shape))


def spmm_bsr_groups_plain(bsr: BSR, x: torch.Tensor,
                          layout: BsrGroups | None = None) -> torch.Tensor:
    """The tensor-core design's walk in PyTorch: for each (group, column)
    entry, the X slab at the column times the block of each member row that
    has one there — absent members multiply nothing — summed into the
    member's block row in f32."""
    if layout is None:
        layout = build_groups(bsr)
    if not layout.distinct:
        raise ValueError("spmm_bsr_groups_plain: the layout cannot list "
                         "repeated (block row, column) blocks")
    x2 = x[:, None] if x.ndim == 1 else x
    m, k = bsr.shape
    bm, bk = bsr.block_shape
    g = layout.group_blocks
    n = x2.shape[1]
    kb = -(-k // bk)
    xp = torch.zeros((kb * bk, n), dtype=torch.float32, device=x2.device)
    xp[:k] = x2.float()
    entry_group = torch.repeat_interleave(
        torch.arange(layout.n_groups, device=x2.device),
        torch.diff(layout.ptr.long()), output_size=layout.cols.shape[0])
    e, member = torch.nonzero(layout.blocks >= 0, as_tuple=True)
    slabs = xp.reshape(kb, bk, n).index_select(0, layout.cols.long()[e])
    prod = torch.bmm(bsr.blocks.float().index_select(
        0, layout.blocks[e, member].long()), slabs)         # (present, bm, N)
    y = torch.zeros((layout.n_groups * g, bm, n), dtype=torch.float32,
                    device=x2.device)
    y.index_add_(0, entry_group[e] * g + member, prod)
    y = y.reshape(-1, n)[:m].to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _mma_depth(dtype: torch.dtype) -> int:
    return 8 if dtype == torch.float32 else 16


def _takes_tc(bsr: BSR, x2: torch.Tensor) -> bool:
    """Whether the tensor-core kernel takes these operands: bm a multiple of
    8 up to ``GROUP_ROWS``, bk of the MMA's depth, blocks and X of one type,
    the blocks 16-byte aligned (they are copied 16 bytes at a time)."""
    bm, bk = bsr.block_shape
    return (bm % 8 == 0 and bm <= GROUP_ROWS
            and bk % _mma_depth(bsr.blocks.dtype) == 0
            and bsr.blocks.dtype == x2.dtype
            and bsr.blocks.data_ptr() % 16 == 0)


def _design(bsr: BSR, x2: torch.Tensor) -> str:
    """The routing rule: ``"tc"`` when the tensor-core kernel takes the
    operands and N ≥ ``TC_MIN_N`` (a layout with repeated blocks still
    sends the call to the fma design, ``spmm_bsr``), else ``"fma"``."""
    return "tc" if x2.shape[1] >= TC_MIN_N and _takes_tc(bsr, x2) else "fma"


def tc_columns(n: int) -> int:
    """Columns of X a tensor-core CTA owns at this N: 32, 64 or 128."""
    for cols in (32, 64):
        if n <= cols:
            return cols
    return 128


def _check(bsr: BSR, x: torch.Tensor) -> torch.Tensor:
    """Raise ``ValueError`` unless a K11 kernel takes these operands;
    returns X as ``(K, N)``."""
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
    mb = bsr.indptr.shape[0] - 1
    if mb != -(-m // bm):
        raise ValueError(f"bsr_spmm: indptr holds {mb} block rows, M={m} "
                         f"at bm={bm} needs {-(-m // bm)}")
    return x2


def _launch(design: str, bsr: BSR, x2: torch.Tensor,
            layout: BsrGroups | None = None, ncols: int | None = None
            ) -> torch.Tensor:
    """Launch ``design`` on checked operands into an ``(M, N)`` f32 ``Y``;
    raises ``ValueError`` where that design does not take them.  ``ncols``
    forces the tensor-core CTA's column tile (default ``tc_columns(N)``)."""
    bm, bk = bsr.block_shape
    if design == "tc":
        if not _takes_tc(bsr, x2):
            raise ValueError(f"bsr_spmm: the tensor-core design does not take "
                             f"blocks {(bm, bk)} of {bsr.blocks.dtype} with "
                             f"x of {x2.dtype}")
        if layout is None or not layout.matches(bsr) \
                or layout.group_blocks != group_blocks_for(bm):
            raise ValueError("bsr_spmm: the group layout was built for "
                             "another pattern or group size")
        if not layout.distinct:
            raise ValueError("bsr_spmm: the tensor-core design does not take "
                             "repeated (block row, column) blocks")
    elif design != "fma":
        raise ValueError(f"bsr_spmm: unknown design {design!r}")
    return _run(design, bsr, x2, layout, ncols)


def _run(design: str, bsr: BSR, x2: torch.Tensor, layout: BsrGroups | None,
         ncols: int | None = None) -> torch.Tensor:
    """The launch itself, on operands the caller has checked for
    ``design``."""
    m, k = bsr.shape
    bm, bk = bsr.block_shape
    n = x2.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if not y.numel():
        return y
    if design == "tc":
        if layout.n_groups > 65535:
            raise ValueError(f"bsr_spmm: {layout.n_groups} groups exceed the "
                             "launch grid")
        err = _build.lib().repro_bsr_spmm_tc(
            layout.ptr.data_ptr(), layout.cols.data_ptr(),
            layout.tiles.data_ptr(), layout.n_groups, layout.group_blocks * bm,
            bsr.blocks.data_ptr(), x2.data_ptr(), _common.is_bf16(x2),
            y.data_ptr(), bm, bk, m, k, n,
            tc_columns(n) if ncols is None else ncols, _common.stream_of(x2))
    else:
        if -(-bm // 16) > 65535:
            raise ValueError(f"bsr_spmm: a block of {bm} rows exceeds the "
                             "launch grid")
        err = _build.lib().repro_bsr_spmm(
            bsr.indptr.data_ptr(), bsr.indices.data_ptr(),
            bsr.blocks.data_ptr(), _common.is_bf16(bsr.blocks), x2.data_ptr(),
            _common.is_bf16(x2), y.data_ptr(), bsr.indptr.shape[0] - 1, bm, bk,
            m, k, n, _common.stream_of(x2))
    _build.check(err, "bsr_spmm")
    _count(design)
    return y


def _count(design: str) -> None:
    LAUNCHES["bsr_spmm"] += 1
    DESIGN_LAUNCHES["bsr_spmm"][design] += 1


def reset_counts() -> None:
    """Set ``DESIGN_LAUNCHES`` to 0 (``reset_launch_counts`` calls it)."""
    for counts in DESIGN_LAUNCHES.values():
        counts.update(dict.fromkeys(counts, 0))


def spmm_bsr(bsr: BSR, x: torch.Tensor,
             layout: BsrGroups | None = None) -> torch.Tensor:
    """K11: ``Y = A·X`` on the BSR substrate.  CPU operands take the plain
    version; CUDA operands launch the routed design or raise.  ``layout`` is
    the tensor-core design's group layout of ``bsr`` (a plan passes its
    own); built here when that design takes the call and none is given."""
    if _common.on_cpu("bsr_spmm", bsr.indptr, bsr.indices, bsr.blocks, x):
        return spmm_bsr_plain(bsr, x)
    x2 = _check(bsr, x)
    design = _design(bsr, x2)
    if design == "tc":
        if layout is None:
            layout = build_groups(bsr)
        elif not layout.matches(bsr):
            raise ValueError("bsr_spmm: the group layout was built for "
                             "another pattern")
        if not layout.distinct:
            design = "fma"
    y = _run(design, bsr, x2, layout)
    if y.dtype != x2.dtype:
        y = y.to(x2.dtype)
    return y[:, 0] if x.ndim == 1 else y


# ---------------------------------------------------------------------------
# registry: the block-granule backend.  All four logical kernels resolve to
# K11, as in the reference (block granularity subsumes both the balancing
# and the reduction axes).  Live value streams arrive as rebuilt blocks in
# the same order (``core/plan.py::execute``), which K11 reads as it reads
# baked ones, through the same group layout.
# ---------------------------------------------------------------------------

def _prep_groups(bsr: BSR, *, shared: dict) -> dict:
    """The plan's one group layout, kept in the dict its prep hooks share:
    the four entries of a ``"bsr"`` plan build it once."""
    if "bsr_groups" not in shared:
        shared["bsr_groups"] = build_groups(bsr)
    return {"layout": shared["bsr_groups"]}


def _bsr_entry(bsr: BSR, x: torch.Tensor, *, layout: BsrGroups | None = None):
    return spmm_bsr(bsr, x.contiguous(), layout=layout)


for _logical in registry.MATMUL_KERNELS:
    registry.register(_logical, "bsr", "bsr", _bsr_entry, prep=_prep_groups)
