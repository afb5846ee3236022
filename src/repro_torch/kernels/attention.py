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

* the **block design** — a CTA owns 64 query rows and walks the 64×64
  blocks of keys its row block touches, the scores and ``P·V`` on the
  tensor cores.  It reads the pattern through a ``BlockLayout`` (the
  touched blocks, a 64-bit mask of kept keys and the slot of the first kept
  key for every (block, row)), built on the pattern's device once per plan
  (``AttnBlocks``);
* the **slot-tile design** — a CTA per balanced tile of the slab, one slot
  at a time on the CUDA cores, for patterns the block design would waste.

The block design runs when the pattern keeps at least ``BLOCK_FILL_MIN`` of
the entries of the blocks it touches, d ≤ ``BLOCK_MAX_D`` and Q, K (and V)
share one type whose rows take 16-byte loads; otherwise the slot-tile design
runs.  ``DESIGN_LAUNCHES`` counts the launches of each design.

Each kernel has a plain PyTorch version beside it (``*_plain``, the
``"torch"`` backend's functions) with the same contract, and the block
design's arithmetic has its own plain evaluator (``*_blocks_plain``: dense
masked 64×64 tiles, the bias through the masks' popcount ranks).
``attn_unfused`` is what a ``"hopper"`` plan runs below the fuse gate
(``attn_fuse_min_seq``): K6 scores, K9 statistics, the weights by
elementwise tensor ops, then K1/K2.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import registry
from ..core.formats import BalancedCOO
from ..core.selector import TileGeometry
from ..core.spmm import (SOFTMAX_EPS, SOFTMAX_NEG, attn_chain_torch,
                         attn_stats_torch, attn_weights)

from . import _build, _common, fused_chain
from .vsr import _prep_geometry

__all__ = ["BLOCK", "BLOCK_FILL_MIN", "BLOCK_MAX_D", "BlockLayout",
           "AttnBlocks", "build_block_layout", "chunk_row_blocks",
           "layout_entries", "attn_stats_fused", "attn_stats_plain",
           "attn_stats_blocks_plain", "attn_chain_fused", "attn_chain_plain",
           "attn_chain_blocks_plain", "attn_unfused"]

#: launches of K9 and K10 since process start (or the last reset)
LAUNCHES = {"attn_stats": 0, "attn_chain": 0}
#: the same launches by design ("block" or "slot")
DESIGN_LAUNCHES = {kernel: {"block": 0, "slot": 0} for kernel in LAUNCHES}

#: query rows of a row block and keys of a key block in the block design
BLOCK = 64
#: least share of a touched block's 4096 entries that the pattern must keep
#: for the block design: masked tensor-core work is then at most 4× the kept
#: work, and the layout costs under 1 B a kept entry
BLOCK_FILL_MIN = 0.25
#: widest head the block design stages in shared memory
BLOCK_MAX_D = 256


# ---------------------------------------------------------------------------
# the block layout of a pattern
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """A pattern on the 64×64 block grid, for the block design.

    The slab is the CSR stream padded at its tail, so in each block the keys
    row ``r`` keeps are one run of consecutive slots, in column order: the
    slot of kept key ``c`` is ``starts[i] + popcount(mask[i] & ((1 << c) −
    1))`` for ``i = block·64 + r % 64``.

    * ``block_ptr`` ``(MB + 1,)`` int32 — row block ``b`` touches blocks
      ``block_ptr[b]:block_ptr[b + 1]``;
    * ``block_col`` ``(nb,)`` int32 — each block's column-block id;
    * ``masks`` ``(nb·64, 2)`` int32 — each (block, local row)'s kept keys,
      the low 32 key bits first (one little-endian 64-bit word);
    * ``starts`` ``(nb·64,)`` int32 — the slot of its first kept key;
    * ``work`` ``(n_chunks, 4)`` int32 — ``(row block, first block, count,
      split)`` per CTA (``chunk_row_blocks``)."""

    shape: tuple[int, int]
    nnz: int
    block_ptr: torch.Tensor
    block_col: torch.Tensor
    masks: torch.Tensor
    starts: torch.Tensor
    work: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return int(self.block_col.numel())

    @property
    def fill(self) -> float:
        return self.nnz / max(1, self.n_blocks * BLOCK * BLOCK)


def chunk_row_blocks(per_row_block: np.ndarray) -> np.ndarray:
    """The work list of the block design from the number of blocks each row
    block touches: ``(n_chunks, 4)`` int32 rows ``(row block, first block,
    count, split)``.  A row block with more than twice the mean number of
    blocks (the mean over row blocks that touch any) is cut into chunks of
    about the mean, ``split = 1`` (its CTAs then merge their rows' results
    atomically); the others are one chunk each; empty row blocks get
    none."""
    counts = np.asarray(per_row_block, np.int64)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    busy = np.nonzero(counts)[0]
    if not len(busy):
        return np.zeros((0, 4), np.int32)
    mean = counts.sum() / len(busy)
    size = max(1, int(np.ceil(mean)))
    out = []
    for rb in busy:
        c = int(counts[rb])
        parts = -(-c // size) if c > 2 * mean else 1
        edges = [c * i // parts for i in range(parts + 1)]
        for lo, hi in zip(edges[:-1], edges[1:]):
            out.append((rb, ptr[rb] + lo, hi - lo, int(parts > 1)))
    return np.asarray(out, np.int32).reshape(-1, 4)


def _pattern_keys(rows, cols, shape):
    """Slot, row, column and block key (row block · KB + column block) of
    every valid slot, in slot order."""
    m, kdim = (int(s) for s in shape)
    r = rows.reshape(-1)
    slots = torch.nonzero(r < m).reshape(-1)
    r = r[slots].long()
    c = cols.reshape(-1)[slots].long()
    kb = max(1, -(-kdim // BLOCK))
    return slots, r, c, (r // BLOCK) * kb + c // BLOCK


def _low32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) as the int32 of the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def build_block_layout(rows, cols, shape) -> BlockLayout | None:
    """The pattern's ``BlockLayout``, built on its device; ``None`` when the
    block design does not take it: the touched blocks keep less than
    ``BLOCK_FILL_MIN`` of their entries (no masks are built then), or a
    row's keys in a block are not one run of consecutive slots in column
    order (a slab that is not a CSR stream)."""
    m, kdim = (int(s) for s in shape)
    dev = rows.device
    slots, r, c, key = _pattern_keys(rows, cols, shape)
    nnz = int(slots.numel())
    if not nnz:
        return None
    ukey, inv = torch.unique(key, return_inverse=True)
    nb = int(ukey.numel())
    if nnz < BLOCK_FILL_MIN * nb * BLOCK * BLOCK:
        return None
    kb = max(1, -(-kdim // BLOCK))
    mb = -(-m // BLOCK)
    grp = inv * BLOCK + r % BLOCK                 # (block, local row)
    lc = c % BLOCK
    # a run of consecutive slots per group, strictly increasing columns
    same = grp[1:] == grp[:-1]
    n_grp = nb * BLOCK
    first = torch.full((n_grp,), 2**62, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, grp, slots, reduce="amin")
    last = torch.full((n_grp,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, grp, slots, reduce="amax")
    size = torch.bincount(grp, minlength=n_grp)
    used = size > 0
    runs = bool(((last - first + 1)[used] == size[used]).all())
    ordered = bool((lc[1:] > lc[:-1])[same].all())
    if not (runs and ordered):
        return None
    bits = torch.ones_like(lc) << (lc % 32)
    words = torch.zeros((n_grp, 2), dtype=torch.int64, device=dev)
    words.view(-1).index_add_(0, grp * 2 + lc // 32, bits)
    per_rb = torch.bincount(ukey // kb, minlength=mb)
    block_ptr = torch.zeros(mb + 1, dtype=torch.int64, device=dev)
    torch.cumsum(per_rb, 0, out=block_ptr[1:])
    work = chunk_row_blocks(per_rb.cpu().numpy())
    return BlockLayout(
        shape=(m, kdim), nnz=nnz, block_ptr=block_ptr.to(torch.int32),
        block_col=(ukey % kb).to(torch.int32), masks=_low32(words),
        starts=torch.where(used, first, 0).to(torch.int32),
        work=torch.from_numpy(work).to(dev))


class AttnBlocks:
    """The block layout of one plan's pattern: ``build_block_layout`` run on
    the plan's first attention call and kept (``None`` kept too, for a
    pattern the block design does not take).  A later call must give the
    same pattern — the same ``(rows, cols)`` tensors, or equal ones, and
    shape — or it raises ``ValueError``: the kernels trust the layout."""

    def __init__(self):
        self._pattern: tuple | None = None
        self._value: BlockLayout | None = None

    def __call__(self, rows, cols, shape) -> BlockLayout | None:
        shape = tuple(int(s) for s in shape)
        if self._pattern is None:
            self._value = build_block_layout(rows, cols, shape)
            self._pattern = (rows, cols, shape)
            return self._value
        rows0, cols0, shape0 = self._pattern
        same = shape == shape0 and (
            (rows is rows0 and cols is cols0)
            or (rows.shape == rows0.shape and cols.shape == cols0.shape
                and rows.device == rows0.device
                and torch.equal(rows, rows0) and torch.equal(cols, cols0)))
        if not same:
            raise ValueError("AttnBlocks: this layout was built for another "
                             "pattern; use one AttnBlocks per pattern")
        return self._value


def _block_rows(layout: BlockLayout) -> torch.Tensor:
    """``(nb,)`` int64: the row block of each block."""
    ptr = layout.block_ptr.long()
    return torch.repeat_interleave(
        torch.arange(ptr.numel() - 1, device=ptr.device), torch.diff(ptr),
        output_size=layout.n_blocks)


def _kept_slots(layout: BlockLayout) -> tuple[torch.Tensor, torch.Tensor]:
    """``(kept, slot)``, each ``(nb, 64, 64)``: whether (block, local row)
    keeps key ``c``, and the slot of a kept key — its mask's popcount rank
    past ``starts``."""
    w = layout.masks.long()
    bits = (w[..., None] >> torch.arange(32, device=w.device)) & 1
    bits = bits.reshape(-1, BLOCK, BLOCK)                # (nb, 64, 64)
    rank = torch.cumsum(bits, dim=-1) - bits
    slot = layout.starts.long().reshape(-1, BLOCK, 1) + rank
    return bits.bool(), slot


def layout_entries(layout: BlockLayout
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``(row, col, slot)`` triples the layout encodes, each ``(E,)``
    int64, ordered by block, then row, then column."""
    kept, slot = _kept_slots(layout)
    b, lr, lc = torch.nonzero(kept, as_tuple=True)
    return (_block_rows(layout)[b] * BLOCK + lr,
            layout.block_col.long()[b] * BLOCK + lc, slot[b, lr, lc])


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


def _block_tiles(layout: BlockLayout, x: torch.Tensor, row_blocks: bool
                 ) -> torch.Tensor:
    """``(nb, 64, w)`` f32 tiles of ``x`` at each block's row block
    (``row_blocks``) or column block, zero past ``x``'s last row."""
    ids = _block_rows(layout) if row_blocks else layout.block_col.long()
    r = ids[:, None] * BLOCK + torch.arange(BLOCK, device=x.device)
    ok = r < x.shape[0]
    tiles = x.float().index_select(0, torch.where(ok, r, 0).reshape(-1))
    return tiles.reshape(layout.n_blocks, BLOCK, -1) * ok[..., None]


def _block_scores(layout, q, k, bias, scale):
    """Dense masked 64×64 tiles of ``z = scale·QKᵀ + bias``: ``(z, kept,
    row)``, ``row`` the query row of each (block, local row)."""
    kept, slot = _kept_slots(layout)
    z = scale * torch.bmm(_block_tiles(layout, q, True),
                          _block_tiles(layout, k, False).transpose(1, 2))
    flat = bias.reshape(-1).float()
    z = z + torch.where(kept, flat[torch.where(kept, slot, 0)], 0.0)
    row = (_block_rows(layout)[:, None] * BLOCK
           + torch.arange(BLOCK, device=z.device))
    return z, kept, row


def attn_stats_blocks_plain(layout: BlockLayout, q, k, bias, *, scale=1.0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The block design's K9 arithmetic in PyTorch: dense masked tiles, each
    kept entry starting from ``max(z, SOFTMAX_NEG)``; ``(row_max,
    row_sum)`` each ``(M,)`` f32, empty rows at ``(SOFTMAX_NEG, 0)``."""
    m = layout.shape[0]
    z, kept, row = _block_scores(layout, q, k, bias, scale)
    zm = torch.where(kept, torch.clamp(z, min=SOFTMAX_NEG), SOFTMAX_NEG)
    idx = row.reshape(-1).clamp(max=m)          # rows past M land in row M
    rm = torch.full((m + 1,), SOFTMAX_NEG, dtype=torch.float32, device=z.device)
    rm.scatter_reduce_(0, idx, zm.amax(dim=-1).reshape(-1), reduce="amax")
    p = torch.where(kept, torch.exp(z - rm[idx].reshape(row.shape)[..., None]),
                    0.0)
    rs = torch.zeros(m + 1, dtype=torch.float32, device=z.device)
    rs.index_add_(0, idx, p.sum(dim=-1).reshape(-1))
    return rm[:m], rs[:m]


def attn_chain_blocks_plain(layout: BlockLayout, q, k, bias, v, *, scale=1.0,
                            stats=None) -> torch.Tensor:
    """The block design's K10 arithmetic in PyTorch: the weights of each
    dense masked tile times the tile of V, summed into the rows; K9's
    statistics from ``attn_stats_blocks_plain`` unless ``stats`` are
    given.  ``(M, N)`` (``(M,)`` for 1-D ``v``) of ``v.dtype``."""
    m = layout.shape[0]
    rm, rs = (attn_stats_blocks_plain(layout, q, k, bias, scale=scale)
              if stats is None else stats)
    rm = torch.cat([rm[:m].float(), rm.new_zeros(1, dtype=torch.float32)])
    rs = torch.cat([rs[:m].float(), rs.new_zeros(1, dtype=torch.float32)])
    z, kept, row = _block_scores(layout, q, k, bias, scale)
    idx = row.reshape(-1).clamp(max=m)
    p = torch.where(kept, torch.exp(z - rm[idx].reshape(row.shape)[..., None]),
                    0.0)
    p = p / torch.clamp(rs[idx], min=SOFTMAX_EPS).reshape(row.shape)[..., None]
    v2 = v[:, None] if v.ndim == 1 else v
    part = torch.bmm(p, _block_tiles(layout, v2, False))
    y = torch.zeros((m + 1, v2.shape[1]), dtype=torch.float32, device=z.device)
    y.index_add_(0, idx, part.reshape(-1, v2.shape[1]))
    y = y[:m].to(v.dtype)
    return y[:, 0] if v.ndim == 1 else y


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def _check_bias(kernel: str, rows, bias) -> None:
    if bias.dtype != torch.float32 or bias.shape != rows.shape \
            or not bias.is_contiguous():
        raise ValueError(f"{kernel}: the bias must be a contiguous float32 "
                         f"slab of the pattern's shape {tuple(rows.shape)}; "
                         f"got {bias.dtype} {tuple(bias.shape)}")


def _block_operands(q, k, v=None) -> bool:
    """Whether the block design takes these operands: Q, K (and V) of one
    type, d ≤ ``BLOCK_MAX_D``, Q and K rows in 16-byte loads."""
    if q.dtype not in _common.FLOAT_TYPES or k.dtype != q.dtype \
            or (v is not None and v.dtype != q.dtype):
        return False
    d = q.shape[1]
    return (0 < d <= BLOCK_MAX_D and d % (16 // q.element_size()) == 0
            and q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0)


def _route(kernel, design, blocks, rows, cols, shape, q, k, v=None):
    """The design a launch takes, ``("block", layout)`` or ``("slot",
    None)``.  ``design`` ``None`` applies the routing rule; ``"block"`` or
    ``"slot"`` forces one and raises if the block design cannot take the
    call."""
    if design not in (None, "block", "slot"):
        raise ValueError(f"{kernel}: design must be None, 'block' or 'slot'; "
                         f"got {design!r}")
    if design == "slot":
        return "slot", None
    layout = (blocks or AttnBlocks())(rows, cols, shape)
    if layout is not None and _block_operands(q, k, v):
        return "block", layout
    if design == "block":
        raise ValueError(f"{kernel}: the block design does not take this "
                         "call (pattern fill, head width or operand types)")
    return "slot", None


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
    stats = torch.zeros((m, 2), dtype=torch.float32, device=rows.device)
    stats[:, 0] = SOFTMAX_NEG
    lib = _build.lib()
    if design == "block":
        if layout.work.shape[0]:
            err = lib.repro_attn_stats_blocks(
                layout.work.data_ptr(), layout.work.shape[0],
                layout.block_col.data_ptr(), layout.masks.data_ptr(),
                layout.starts.data_ptr(), q.data_ptr(), k.data_ptr(),
                _common.is_bf16(q), bias.data_ptr(), stats.data_ptr(), m,
                k.shape[0], q.shape[1], float(scale), _common.stream_of(q))
            _build.check(err, "attn_stats (block design)")
            _count("attn_stats", design)
    elif m and rows.numel():
        err = lib.repro_attn_stats(
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
              if stats is None else
              torch.stack([s[:m].float() for s in stats], dim=1).contiguous())
    y = torch.zeros((m, n), dtype=torch.float32, device=v2.device)
    lib = _build.lib()
    if route == "block":
        if y.numel() and layout.work.shape[0]:
            err = lib.repro_attn_blocks(
                layout.work.data_ptr(), layout.work.shape[0],
                layout.block_col.data_ptr(), layout.masks.data_ptr(),
                layout.starts.data_ptr(), q.data_ptr(), k.data_ptr(),
                _common.is_bf16(q), bias.data_ptr(), packed.data_ptr(),
                v2.data_ptr(), y.data_ptr(), m, k.shape[0], n, q.shape[1],
                float(scale), _common.stream_of(v2))
            _build.check(err, "attn_chain (block design)")
            _count("attn_chain", route)
    elif y.numel() and rows.numel():
        err = lib.repro_attn(
            rows.data_ptr(), cols.data_ptr(), q.data_ptr(), k.data_ptr(),
            _common.is_bf16(q), bias.data_ptr(), packed.data_ptr(),
            v2.data_ptr(), _common.is_bf16(v2), y.data_ptr(), rows.shape[0],
            rows.shape[1], m, n, q.shape[1], float(scale),
            _common.stream_of(v2))
        _build.check(err, "attn_chain")
        _count("attn_chain", route)
    y = y.to(v2.dtype)
    return y[:, 0] if v.ndim == 1 else y


def attn_unfused(rows, cols, q, k, bias, v, *, shape, scale=1.0,
                 stats=None, blocks: AttnBlocks | None = None
                 ) -> torch.Tensor:
    """Attention as separate kernels, the edge stream materialised: K6
    scores, K9 statistics, the weights by elementwise tensor ops (the
    reference does that step outside any kernel too), then the nnz-balanced
    SpMM of the ``"hopper"`` backend (K1, or K2 for 1-D v) on
    ``BalancedCOO(rows, cols, w)``."""
    m = int(shape[0])
    e = fused_chain.sddmm_fused(rows, cols, q, k, shape=shape)
    if stats is None:
        stats = attn_stats_fused(rows, cols, q, k, bias, shape=shape,
                                 scale=scale, blocks=blocks)
    r = rows.reshape(-1)
    w = attn_weights(e.reshape(-1), bias.reshape(-1).float(), r, r < m, m,
                     scale, stats=stats)
    bal = BalancedCOO(rows, cols, w.reshape(rows.shape), tuple(shape))
    return registry.resolve("nb_pr", "hopper").fn(bal, v)


# ---------------------------------------------------------------------------
# registry: the Hopper entry of attention with a bias.  Its prep hook is the
# NB entries' geometry check and an empty ``AttnBlocks``, filled on the
# plan's first attention call.
# ---------------------------------------------------------------------------

def _prep_attn(bal: BalancedCOO, *,
               geometry: TileGeometry | None = None) -> dict:
    return dict(_prep_geometry(bal, geometry=geometry), blocks=AttnBlocks())


def _hopper_attn(rows, cols, q, k, bias, v, *, fuse: bool = True, **kw):
    run = attn_chain_fused if fuse else attn_unfused
    return run(rows, cols, q.contiguous(), k.contiguous(), bias.contiguous(),
               v.contiguous(), **kw)


registry.register("attn_chain", "hopper", "balanced", _hopper_attn,
                  prep=_prep_attn)
