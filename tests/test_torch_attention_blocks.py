"""The block design of K9 and K10 on the CPU: the pattern's ``BlockLayout``
(exactly the pattern's (row, col, slot) triples, no others), the work list
that splits only heavy row blocks, the routing rule between the two
designs, and the block design's plain evaluator (dense masked 64×64 tiles,
the bias through the masks' popcount ranks) against the reference's Pallas
kernels in interpret mode and the port's plain versions.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance, float32: rtol 1e-5 and atol 1e-5 of the result's largest
magnitude (the tiles sum the dot products and the rows' exponentials in
another order than the slot stream)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.attention import patterns as ref_patterns
from repro.core import formats as ref_formats
from repro.kernels import attention as ref_attention
from repro.kernels import vsr as ref_vsr
import repro_torch
from repro_torch import interop
from repro_torch.attention import patterns
from repro_torch.configs import gemma3_12b
from repro_torch.core import formats
from repro_torch.core.plan import _stream_to_balanced
from repro_torch.core.rmat import rmat
from repro_torch.kernels import attention, launch_counts, reset_launch_counts
from repro_torch.models import transformer

TILE = 512
GEMMA = dataclasses.replace(gemma3_12b.CONFIG, attn_pattern="block_sparse")


def _empty_block_row_mask(nb=8, row=3):
    bm = np.tril(np.ones((nb, nb), bool))
    bm[row, :] = False
    return bm


#: patterns of the layout tests: Gemma-3-12B's local band (ragged at seq
#: 1000), a narrower causal window, BigBird, an empty block row
LAYOUT_SPECS = {
    "gemma_512_causal": lambda: transformer._block_sparse_spec(GEMMA, 512, True),
    "gemma_1000_causal": lambda: transformer._block_sparse_spec(GEMMA, 1000, True),
    "gemma_1000": lambda: transformer._block_sparse_spec(GEMMA, 1000, False),
    "window_1000_causal": lambda: patterns.sliding_window(1000, 2, block=64,
                                                          causal=True),
    "bigbird_1024": lambda: patterns.bigbird(1024, 1, 2, 3, block=64, seed=0),
    "bigbird_600_block32": lambda: patterns.bigbird(600, 1, 1, 2, block=32,
                                                    seed=2),
    "empty_block_row": lambda: patterns.from_block_mask(
        _empty_block_row_mask(), 500, block=64, causal=True),
}

#: reference specs of the parity tests: small enough for the Pallas kernels
#: in interpret mode, ragged against the 64-row block
PARITY_SPECS = {
    "window_causal_150": ref_api.sliding_window(150, 3, block=16, causal=True),
    "window_100": ref_api.sliding_window(100, 1, block=32),
    "bigbird_160": ref_api.bigbird(160, 1, 1, 1, block=16, seed=3),
    "empty_block_row": ref_api.from_block_mask(
        _empty_block_row_mask(4, 2), 256, block=64, causal=True),
}


def _port_csr(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr),
                                   np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [100, TILE])
@pytest.mark.parametrize("name", sorted(LAYOUT_SPECS))
def test_layout_reproduces_the_pattern_exactly(name, tile):
    csr = patterns.build_mask(LAYOUT_SPECS[name]()).csr
    bal = formats.csr_to_balanced(csr, tile)
    layout = attention.build_block_layout(bal.rows, bal.cols, csr.shape)
    assert layout is not None and layout.nnz == csr.nnz
    assert layout.fill >= attention.BLOCK_FILL_MIN
    rows, cols, slots = attention.layout_entries(layout)
    order = torch.argsort(slots)
    got = torch.stack([rows[order], cols[order], slots[order]], dim=1)
    flat_rows = bal.rows.reshape(-1)[:csr.nnz].long()
    flat_cols = bal.cols.reshape(-1)[:csr.nnz].long()
    want = torch.stack([flat_rows, flat_cols, torch.arange(csr.nnz)], dim=1)
    assert torch.equal(got, want)
    # the layout's arrays: one CSR over row blocks, int32 throughout
    mb = -(-csr.shape[0] // attention.BLOCK)
    assert layout.block_ptr.shape == (mb + 1,)
    assert int(layout.block_ptr[-1]) == layout.n_blocks
    assert layout.masks.shape == (layout.n_blocks * attention.BLOCK, 2)
    for t in (layout.block_ptr, layout.block_col, layout.masks, layout.starts,
              layout.work):
        assert t.dtype == torch.int32 and t.is_contiguous()
    # empty row blocks have no chunk and no block
    per_rb = torch.diff(layout.block_ptr)
    assert set(layout.work[:, 0].tolist()) == set(
        torch.nonzero(per_rb).reshape(-1).tolist())


@pytest.mark.parametrize("scale,edge", [(12, 16), (14, 8)])
def test_scattered_graph_gets_no_layout(scale, edge):
    """An R-MAT graph keeps ~1/4096 of each touched block: the fill rule
    routes it to the slot-tile design, and no masks are built."""
    g = rmat(scale, edge, seed=0)
    bal = formats.csr_to_balanced(g, TILE)
    assert attention.build_block_layout(bal.rows, bal.cols, g.shape) is None
    blocks = attention.AttnBlocks()
    assert blocks(bal.rows, bal.cols, g.shape) is None
    q = torch.zeros(g.shape[0], 64)
    assert attention._route("attn_stats", None, blocks, bal.rows, bal.cols,
                            g.shape, q, q) == ("slot", None)
    with pytest.raises(ValueError):
        attention._route("attn_stats", "block", blocks, bal.rows, bal.cols,
                         g.shape, q, q)


@pytest.mark.parametrize("case", ["shuffled_slots", "padding_inside"])
def test_layout_refuses_slabs_that_are_not_a_csr_stream(case):
    """The popcount rank names a kept key's slot only when each row's keys
    in a block are one run of slots in column order."""
    csr = patterns.build_mask(patterns.sliding_window(256, 1, block=64)).csr
    bal = formats.csr_to_balanced(csr, TILE)
    rows, cols = bal.rows.clone(), bal.cols.clone()
    flat_r, flat_c = rows.view(-1), cols.view(-1)
    if case == "shuffled_slots":      # two keys of row 0 swapped
        flat_c[[0, 1]] = flat_c[[1, 0]]
    else:                             # a padding slot inside row 0's run
        flat_r[1] = csr.shape[0]
    assert attention.build_block_layout(rows, cols, csr.shape) is None


@pytest.mark.parametrize("counts", [
    [16] * 8,                                   # a band: nothing splits
    [2, 64, 64, 9, 10, 11, 0, 8, 10, 9, 12],    # BigBird-like global rows
    [1, 3, 0, 0, 40, 2],
    [5],
    [0, 0, 7],
    [128] + [1] * 63,
])
def test_chunking_splits_only_heavy_row_blocks(counts):
    counts = np.asarray(counts)
    work = attention.chunk_row_blocks(counts)
    busy = counts[counts > 0]
    mean = busy.sum() / len(busy)
    ptr = np.concatenate([[0], np.cumsum(counts)])
    covered = np.zeros(counts.sum(), int)
    for rb, first, count, split in work:
        assert count >= 1 and ptr[rb] <= first and first + count <= ptr[rb + 1]
        covered[first:first + count] += 1
        assert split == int(counts[rb] > 2 * mean)
        if split:
            assert count <= np.ceil(mean)
    assert (covered == 1).all()                 # every block once
    per_rb = np.bincount(work[:, 0], minlength=len(counts))
    assert ((per_rb > 1) == (counts > 2 * mean)).all()
    assert ((per_rb == 0) == (counts == 0)).all()


def test_bigbird_global_rows_split_into_chunks_of_about_the_mean():
    csr = patterns.build_mask(patterns.bigbird(4096, 1, 2, 3, block=64,
                                               seed=0)).csr
    bal = formats.csr_to_balanced(csr, TILE)
    layout = attention.build_block_layout(bal.rows, bal.cols, csr.shape)
    work = layout.work.numpy()
    per_rb = np.diff(layout.block_ptr.numpy())
    heavy = np.nonzero(per_rb > 2 * per_rb.mean())[0]
    assert len(heavy) == 2 and (per_rb[heavy] == 64).all()
    for rb in heavy:
        parts = work[work[:, 0] == rb]
        assert len(parts) == 7 and parts[:, 3].all()
    assert not work[~np.isin(work[:, 0], heavy), 3].any()


def test_plan_prep_caches_one_layout_per_plan():
    spec = patterns.sliding_window(256, 1, block=64, causal=True)
    p = repro_torch.attention_plan(spec, backend="hopper", device="cpu",
                                   cache=False)
    opts = p.kernel_opts(p.entry("attn_chain"))
    blocks = opts["blocks"]
    assert isinstance(blocks, attention.AttnBlocks)
    assert p.kernel_opts(p.entry("attn_chain"))["blocks"] is blocks
    bal = p.substrate("balanced")
    first = blocks(bal.rows, bal.cols, p.csr.shape)
    assert first is not None and blocks(bal.rows, bal.cols, p.csr.shape) is first


@pytest.mark.parametrize("case", ["equal_copy", "other_pattern",
                                  "other_shape", "graph_after_band"])
def test_layout_cache_refuses_another_pattern(case):
    """One ``AttnBlocks`` serves one pattern: equal copies of its tensors
    get the cached layout, another pattern (even of the same slab shape and
    nonzero count) raises instead of reusing it."""
    band = patterns.sliding_window(256, 1, block=64, causal=True)
    csr = patterns.build_mask(band).csr
    bal = formats.csr_to_balanced(csr, TILE)
    blocks = attention.AttnBlocks()
    first = blocks(bal.rows, bal.cols, csr.shape)
    assert first is not None
    if case == "equal_copy":
        assert blocks(bal.rows.clone(), bal.cols.clone(), csr.shape) is first
        return
    if case == "other_pattern":
        # the band mirrored in its column blocks: same slab, nnz and shape
        rows, cols = bal.rows, torch.where(bal.rows < 256, 255 - bal.cols,
                                           bal.cols)
        shape = csr.shape
    elif case == "other_shape":
        rows, cols, shape = bal.rows, bal.cols, (256, 320)
    else:
        g = rmat(8, 4, seed=3)
        gbal = formats.csr_to_balanced(g, TILE)
        rows, cols, shape = gbal.rows, gbal.cols, g.shape
    with pytest.raises(ValueError, match="another pattern"):
        blocks(rows, cols, shape)
    assert blocks(bal.rows, bal.cols, csr.shape) is first


@pytest.mark.parametrize("case", ["f32", "bf16", "d_256", "d_264", "d_6",
                                  "mixed_types", "v_other_type"])
def test_routing_rule_on_operands(case):
    csr = patterns.build_mask(patterns.sliding_window(256, 1, block=64)).csr
    bal = formats.csr_to_balanced(csr, TILE)
    blocks = attention.AttnBlocks()
    d, qdt, vdt = {"f32": (64, torch.float32, torch.float32),
                   "bf16": (64, torch.bfloat16, torch.bfloat16),
                   "d_256": (256, torch.float32, torch.float32),
                   "d_264": (264, torch.float32, torch.float32),
                   "d_6": (6, torch.float32, torch.float32),
                   "mixed_types": (64, torch.bfloat16, None),
                   "v_other_type": (64, torch.float32, torch.bfloat16)}[case]
    q = torch.zeros(256, d, dtype=qdt)
    k = torch.zeros(256, d, dtype=torch.float32 if vdt is None else qdt)
    v = torch.zeros(256, 8, dtype=vdt or torch.float32)
    route, layout = attention._route("attn_chain", None, blocks, bal.rows,
                                     bal.cols, csr.shape, q, k, v)
    want = "block" if case in ("f32", "bf16", "d_256") else "slot"
    assert route == want and (layout is not None) == (want == "block")
    assert attention._route("attn_chain", "slot", blocks, bal.rows, bal.cols,
                            csr.shape, q, k, v) == ("slot", None)
    with pytest.raises(ValueError):
        attention._route("attn_chain", "tiles", blocks, bal.rows, bal.cols,
                         csr.shape, q, k, v)


# ---------------------------------------------------------------------------
# the block design's plain evaluator
# ---------------------------------------------------------------------------

def _operands(spec, rng, d, n):
    csr = ref_patterns.build_mask(spec).csr
    rb = ref_formats.csr_to_balanced(csr, TILE)
    pb = formats.csr_to_balanced(_port_csr(csr), TILE)
    seq = csr.shape[0]
    q = (rng.standard_normal((seq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((seq, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((seq, n)).astype(np.float32)
    bias = (rng.standard_normal(csr.nnz) * 0.5).astype(np.float32)
    bias[::11] = -np.inf               # masked by the bias: weight 0
    slab = np.zeros(rb.rows.size, np.float32)
    slab[:csr.nnz] = bias
    return csr, rb, pb, q, k, v, slab.reshape(rb.rows.shape)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol = atol_rel * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("scale", [0.25, 1.0])
@pytest.mark.parametrize("name", sorted(PARITY_SPECS))
def test_block_stats_match_pallas_and_plain(name, scale):
    csr, rb, pb, q, k, _, slab = _operands(PARITY_SPECS[name],
                                           np.random.default_rng(0), 24, 1)
    m = csr.shape[0]
    layout = attention.build_block_layout(pb.rows, pb.cols, csr.shape)
    assert layout is not None
    tq, tk, ts = (torch.from_numpy(a) for a in (q, k, slab))
    got = attention.attn_stats_blocks_plain(layout, tq, tk, ts, scale=scale)
    wb = 8
    visits = dict(zip(("visit_tile", "visit_block", "visit_start"),
                      map(jnp.asarray, ref_vsr.plan_visits(rb, wb))))
    pm, ps = ref_attention.attn_stats_pallas(
        rb.rows, rb.cols, jnp.asarray(q), jnp.asarray(k), jnp.asarray(slab),
        shape=csr.shape, scale=scale, wb=wb, interpret=True, **visits)
    pallas = (np.asarray(pm).reshape(-1)[:m], np.asarray(ps).reshape(-1)[:m])
    plain = attention.attn_stats_plain(pb.rows, pb.cols, tq, tk, ts,
                                       shape=csr.shape, scale=scale)
    empty = np.diff(np.asarray(csr.indptr)) == 0
    assert (got[0].numpy()[empty] == -1e30).all()
    assert (got[1].numpy()[empty] == 0).all()
    live = got[0].numpy() > -1e29       # rows with a finite z
    for want in (pallas, (plain[0].numpy(), plain[1].numpy())):
        _close(got[0].numpy()[live], want[0][live])
        np.testing.assert_array_equal(got[0].numpy()[~live], want[0][~live])
        _close(got[1], want[1])


@pytest.mark.parametrize("n", [1, 5, 24])
@pytest.mark.parametrize("name", sorted(PARITY_SPECS))
def test_block_chain_matches_pallas_and_plain(name, n):
    csr, rb, pb, q, k, v, slab = _operands(PARITY_SPECS[name],
                                           np.random.default_rng(1), 16, n)
    v = v[:, 0] if n == 1 else v
    layout = attention.build_block_layout(pb.rows, pb.cols, csr.shape)
    tq, tk, ts, tv = (torch.from_numpy(np.ascontiguousarray(a))
                      for a in (q, k, slab, v))
    kw = dict(scale=0.25)
    got = attention.attn_chain_blocks_plain(layout, tq, tk, ts, tv, **kw)
    want_pallas = ref_attention.attn_chain_pallas(
        rb.rows, rb.cols, jnp.asarray(q), jnp.asarray(k), jnp.asarray(slab),
        jnp.asarray(v), shape=csr.shape, interpret=True, **kw)
    plain = attention.attn_chain_plain(pb.rows, pb.cols, tq, tk, ts, tv,
                                       shape=csr.shape, **kw)
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    _close(got, np.asarray(want_pallas))
    _close(got, plain.numpy())
    empty = np.diff(np.asarray(csr.indptr)) == 0
    assert (got.numpy()[empty] == 0).all()
    # given statistics, as K10 takes K9's
    stats = attention.attn_stats_plain(pb.rows, pb.cols, tq, tk, ts,
                                       shape=csr.shape, **kw)
    _close(attention.attn_chain_blocks_plain(layout, tq, tk, ts, tv,
                                             stats=stats, **kw), plain.numpy())


@pytest.mark.parametrize("name", ["gemma_1000_causal", "bigbird_600_block32",
                                  "empty_block_row"])
def test_block_evaluator_matches_plain_at_model_blocks(name):
    """The evaluator on 64-token blocks (the Pallas kernels are too slow in
    interpret mode here): against the port's plain versions, with bf16
    operands too (rtol 2e-2: V and the output rounded to 8 bits)."""
    csr = patterns.build_mask(LAYOUT_SPECS[name]()).csr
    bal = formats.csr_to_balanced(csr, TILE)
    layout = attention.build_block_layout(bal.rows, bal.cols, csr.shape)
    rng = np.random.default_rng(4)
    seq, d = csr.shape[0], 32
    q, k, v = (torch.from_numpy((rng.standard_normal((seq, d)) * s)
                                .astype(np.float32)) for s in (0.3, 0.3, 1.0))
    bias = torch.from_numpy(interop.alibi_bias(csr, 0.05))
    bias[::13] = -float("inf")
    slab = _stream_to_balanced(bias, bal)
    kw = dict(scale=d ** -0.5)
    got = attention.attn_chain_blocks_plain(layout, q, k, slab, v, **kw)
    want = attention.attn_chain_plain(bal.rows, bal.cols, q, k, slab, v,
                                      shape=csr.shape, **kw)
    _close(got, want.numpy())
    got16 = attention.attn_chain_blocks_plain(layout, q.bfloat16(),
                                              k.bfloat16(), slab,
                                              v.bfloat16(), **kw)
    assert got16.dtype == torch.bfloat16
    _close(got16, want.numpy(), rtol=2e-2, atol_rel=2e-2)


def test_cpu_wrappers_take_the_plain_version_with_blocks():
    spec = patterns.sliding_window(256, 1, block=64, causal=True)
    csr = patterns.build_mask(spec).csr
    bal = formats.csr_to_balanced(csr, TILE)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((256, 16))
                                .astype(np.float32)) for _ in range(3))
    slab = _stream_to_balanced(torch.from_numpy(interop.alibi_bias(csr, 0.1)),
                               bal)
    blocks = attention.AttnBlocks()
    kw = dict(shape=csr.shape, scale=0.25, blocks=blocks)
    reset_launch_counts()
    y = attention.attn_chain_fused(bal.rows, bal.cols, q, k, slab, v, **kw)
    rm, rs = attention.attn_stats_fused(bal.rows, bal.cols, q, k, slab, **kw)
    assert set(launch_counts().values()) == {0}
    assert all(c == {"block": 0, "slot": 0}
               for c in attention.DESIGN_LAUNCHES.values())
    _close(y, attention.attn_chain_plain(bal.rows, bal.cols, q, k, slab, v,
                                         shape=csr.shape, scale=0.25).numpy())
    _close(rs, attention.attn_stats_plain(bal.rows, bal.cols, q, k, slab,
                                          shape=csr.shape, scale=0.25)[1])
