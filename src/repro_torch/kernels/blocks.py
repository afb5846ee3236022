"""The block design of the softmax-chain kernels: K7/K8 (no bias) and K9/K10
(with a bias) as 64-query-row kernels on the tensor cores.

A CTA owns 64 query rows and walks the 64×64 blocks of keys its row block
touches, the scores and ``P·V`` on the tensor cores; its CUDA source is
``repro_torch/csrc/attention.cu``, whose note gives the design.  It reads
the pattern through a ``BlockLayout`` (the touched blocks, a 64-bit mask of
kept keys and the slot of the first kept key for every (block, row)), built
on the pattern's device once per plan (``AttnBlocks``).

The block design takes a call when the pattern keeps at least
``BLOCK_FILL_MIN`` of the entries of the blocks it touches, d ≤
``BLOCK_MAX_D`` and the operands (Q, K and V; A, B and X) share one type
whose rows take 16-byte loads (``_route``); the slot-tile kernels of
``fused_chain`` and ``attention`` take the others.  ``attn_*_blocks_plain``
evaluate the design's arithmetic in PyTorch: dense masked 64×64 tiles, a
bias (if any) through the masks' popcount ranks, and V's non-finite entries
added only where a row keeps their key, as the kernel adds them.

This module holds what both kernel modules share; ``fused_chain`` and
``attention`` launch the kernels through ``launch_stats`` /
``launch_chain`` and count the launches themselves.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.spmm import SOFTMAX_EPS, SOFTMAX_NEG

from . import _build, _common

__all__ = ["BLOCK", "BLOCK_FILL_MIN", "BLOCK_MAX_D", "BlockLayout",
           "AttnBlocks", "build_block_layout", "chunk_row_blocks",
           "layout_entries", "attn_stats_blocks_plain",
           "attn_chain_blocks_plain"]

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
    the plan's first softmax-chain or attention call and kept (``None``
    kept too, for a pattern the block design does not take).  A later call
    must give the same pattern — the same ``(rows, cols)`` tensors, or equal
    ones, and shape — or it raises ``ValueError``: the kernels trust the
    layout."""

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


def plan_blocks(shared: dict) -> AttnBlocks:
    """The plan's one ``AttnBlocks``, kept in the dict its prep hooks share
    (``PlanBuilder``'s ``shared`` context): the ``chain`` and
    ``attn_chain`` entries of a plan read one layout."""
    return shared.setdefault("blocks", AttnBlocks())


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
# the design's plain evaluators
# ---------------------------------------------------------------------------

def _block_tiles(layout: BlockLayout, x: torch.Tensor, row_blocks: bool
                 ) -> torch.Tensor:
    """``(nb, 64, w)`` f32 tiles of ``x`` at each block's row block
    (``row_blocks``) or column block, zero past ``x``'s last row (as the
    kernels' zero fill: selected, so a non-finite row 0 stays out)."""
    ids = _block_rows(layout) if row_blocks else layout.block_col.long()
    r = ids[:, None] * BLOCK + torch.arange(BLOCK, device=x.device)
    ok = r < x.shape[0]
    tiles = x.float().index_select(0, torch.where(ok, r, 0).reshape(-1))
    tiles = tiles.reshape(layout.n_blocks, BLOCK, -1)
    return torch.where(ok[..., None], tiles, 0.0)


def _block_scores(layout, q, k, bias, scale):
    """Dense masked 64×64 tiles of ``z = scale·QKᵀ (+ bias)``: ``(z, kept,
    row)``, ``row`` the query row of each (block, local row).  Without a
    bias (``None``) nothing is gathered."""
    kept, slot = _kept_slots(layout)
    z = scale * torch.bmm(_block_tiles(layout, q, True),
                          _block_tiles(layout, k, False).transpose(1, 2))
    if bias is not None:
        flat = bias.reshape(-1).float()
        z = z + torch.where(kept, flat[torch.where(kept, slot, 0)], 0.0)
    row = (_block_rows(layout)[:, None] * BLOCK
           + torch.arange(BLOCK, device=z.device))
    return z, kept, row


def attn_stats_blocks_plain(layout: BlockLayout, q, k, bias=None, *,
                            scale=1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The block design's K9 arithmetic (K7's with ``bias=None``) in
    PyTorch: dense masked tiles, each kept entry starting from ``max(z,
    SOFTMAX_NEG)``; ``(row_max, row_sum)`` each ``(M,)`` f32, empty rows at
    ``(SOFTMAX_NEG, 0)``."""
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
    """The block design's K10 arithmetic (K8's softmax with ``bias=None``)
    in PyTorch: the weights of each dense masked tile times the tile of V
    with its non-finite entries zeroed, summed into the rows; then each
    non-finite entry ``V[c, j]`` added as ``w·V[c, j]`` to the rows that
    keep key ``c`` only (the kernel does the same, so a masked key's ``inf``
    or NaN reaches no row, a kept one's reaches its rows as in the
    reference).  K9's statistics from ``attn_stats_blocks_plain`` unless
    ``stats`` are given.  ``(M, N)`` (``(M,)`` for 1-D ``v``) of
    ``v.dtype``."""
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
    vt = _block_tiles(layout, v2, False)
    bad = ~torch.isfinite(vt)
    part = torch.bmm(p, torch.where(bad, 0.0, vt))
    b, key, col = torch.nonzero(bad, as_tuple=True)       # (E,) each
    lr = torch.arange(BLOCK, device=p.device).expand(b.numel(), BLOCK)
    add = torch.where(kept[b, :, key], p[b, :, key] * vt[b, key, col][:, None],
                      0.0)
    part.index_put_((b[:, None].expand_as(lr), lr, col[:, None].expand_as(lr)),
                    add, accumulate=True)
    y = torch.zeros((m + 1, v2.shape[1]), dtype=torch.float32, device=z.device)
    y.index_add_(0, idx, part.reshape(-1, v2.shape[1]))
    y = y[:m].to(v.dtype)
    return y[:, 0] if v.ndim == 1 else y


# ---------------------------------------------------------------------------
# routing and launching
# ---------------------------------------------------------------------------

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


def new_stats(m: int, device) -> torch.Tensor:
    """An ``(M, 2)`` f32 buffer of ``(row_max, row_sum)`` pairs at
    ``(SOFTMAX_NEG, 0)``, which the statistics kernels fill."""
    stats = torch.zeros((m, 2), dtype=torch.float32, device=device)
    stats[:, 0] = SOFTMAX_NEG
    return stats


def pack_stats(stats, m: int) -> torch.Tensor:
    """Given statistics ``(row_max, row_sum)`` (indexable by row id) as the
    ``(M, 2)`` f32 buffer the ``P·V`` kernels read."""
    return torch.stack([s[:m].float() for s in stats], dim=1).contiguous()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch_stats(kernel: str, layout: BlockLayout, q, k, bias,
                 stats: torch.Tensor, scale) -> bool:
    """The block statistics kernel into ``stats`` (``(M, 2)`` f32, filled
    with ``(SOFTMAX_NEG, 0)``): K9 with an f32 ``bias`` slab, K7 (the bias
    compiled out) with ``None``.  Returns whether it launched (a layout with
    no work launches nothing)."""
    if not layout.work.shape[0]:
        return False
    err = _build.lib().repro_attn_stats_blocks(
        layout.work.data_ptr(), layout.work.shape[0],
        layout.block_col.data_ptr(), layout.masks.data_ptr(),
        layout.starts.data_ptr(), q.data_ptr(), k.data_ptr(),
        _common.is_bf16(q), _ptr(bias), stats.data_ptr(), layout.shape[0],
        k.shape[0], q.shape[1], float(scale), _common.stream_of(q))
    _build.check(err, f"{kernel} (block design)")
    return True


def launch_chain(kernel: str, layout: BlockLayout, q, k, bias,
                 stats: torch.Tensor, v: torch.Tensor, y: torch.Tensor,
                 scale) -> bool:
    """The block ``P·V`` kernel into the zeroed ``y`` (``(M, N)`` f32) from
    the packed ``stats``: K10 with a ``bias`` slab, K8's softmax with
    ``None``.  Returns whether it launched."""
    if not (y.numel() and layout.work.shape[0]):
        return False
    err = _build.lib().repro_attn_blocks(
        layout.work.data_ptr(), layout.work.shape[0],
        layout.block_col.data_ptr(), layout.masks.data_ptr(),
        layout.starts.data_ptr(), q.data_ptr(), k.data_ptr(),
        _common.is_bf16(q), _ptr(bias), stats.data_ptr(), v.data_ptr(),
        y.data_ptr(), layout.shape[0], k.shape[0], v.shape[1], q.shape[1],
        float(scale), _common.stream_of(v))
    _build.check(err, f"{kernel} (block design)")
    return True
