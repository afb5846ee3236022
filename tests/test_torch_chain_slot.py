"""The slot-tile K7/K8's order of work on the CPU: which slots are a tile's
edge runs (``fused_chain.edge_slots``), K7's edge mode
(``chain_stats_edge_plain``: per-tile partials of the edge runs merged by
the online-softmax update, every other row left at ``(SOFTMAX_NEG, 0)``)
and K8 folding every other run from its own tile
(``chain_tiles_plain``), against the reference's xla lowerings and its
Pallas kernels (``chain_stats_pallas`` / ``chain_pallas``, interpret
mode).

Patterns: a row spanning one, two and many tiles, runs that end exactly at
a tile's end, tiles that are one row, empty rows, an all-padding last tile
and nnz = 0.  Inputs are made with numpy from a seed and handed to both
packages.  Tolerance, float32: rtol 1e-5 and atol 2e-5 of the result's
largest magnitude (exp and sums reassociated); a bfloat16 x: 2e-2."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import csr_from_dense
from repro.core import formats as ref_formats
from repro.core import spmm as ref_spmm
from repro.kernels import fused_chain as ref_chain
from repro.kernels import vsr as ref_vsr
from repro_torch import interop
from repro_torch.core import formats, spmm
from repro_torch.kernels import fused_chain

ALPHA = 0.7
TRANSFORMS = (("identity", None), ("scale", 0.5), ("softmax", ALPHA))


def _features(rng, m, k, d=8):
    a = (rng.standard_normal((m, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((k, d)) * 0.3).astype(np.float32)
    return a, b


def _rows_of(lengths, k, rng):
    """A dense (len(lengths), k) matrix whose row i keeps lengths[i] random
    columns."""
    dense = np.zeros((len(lengths), k), np.float32)
    for i, n in enumerate(lengths):
        cols = rng.choice(k, size=n, replace=False)
        dense[i, cols] = rng.standard_normal(n).astype(np.float32)
    return dense


def _pattern(name):
    """(dense, tile, padding tiles to append) for each pattern."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one_tile":          # every row inside one tile, empty rows
        dense = ((rng.random((37, 29)) < 0.15)
                 * rng.standard_normal((37, 29))).astype(np.float32)
        dense[[5, 30]] = 0.0
        return dense, 512, 0
    if name == "two_tiles":         # row 3 spans two tiles
        return _rows_of([4, 2, 0, 600, 7, 5, 0, 9], 700, rng), 512, 0
    if name == "many_tiles":        # a hub row over ~20 tiles, one-row tiles
        return _rows_of([3, 0, 5, 650, 2, 31, 6, 0, 1, 40, 4], 700, rng), 32, 0
    if name == "tile_ends":         # runs that end exactly at a tile's end
        return _rows_of([16, 10, 6, 5, 11, 3, 3, 3, 3, 4, 0, 16, 2], 40,
                        rng), 16, 0
    if name == "padding_tile":      # empty rows, an all-padding last tile
        dense = _rows_of([7, 0, 0, 12, 3, 0, 9, 2, 0], 30, rng)
        return dense, 16, 1
    if name == "empty":             # nnz = 0
        return np.zeros((6, 5), np.float32), 16, 0
    raise KeyError(name)


PATTERNS = ("one_tile", "two_tiles", "many_tiles", "tile_ends",
            "padding_tile", "empty")


def _slabs(dense, tile, pad_tiles):
    """The same balanced slabs in both packages, with `pad_tiles` tiles of
    padding (row M, column 0) appended: (ref rows, ref cols), (port rows,
    port cols), shape."""
    csr = csr_from_dense(dense)
    rb = ref_formats.csr_to_balanced(csr, tile)
    pc = interop.csr_from_arrays(np.asarray(csr.indptr),
                                 np.asarray(csr.indices),
                                 np.asarray(csr.data), csr.shape)
    pb = formats.csr_to_balanced(pc, tile)
    rows, cols = np.array(rb.rows), np.array(rb.cols)
    np.testing.assert_array_equal(pb.rows.numpy(), rows)
    if pad_tiles:
        rows = np.concatenate([rows, np.full((pad_tiles, tile), csr.shape[0],
                                             np.int32)])
        cols = np.concatenate([cols, np.zeros((pad_tiles, tile), np.int32)])
    return ((jnp.asarray(rows), jnp.asarray(cols)),
            (torch.from_numpy(rows), torch.from_numpy(cols)), csr.shape)


def _close(got, want, rtol=1e-5, atol_rel=2e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol = atol_rel * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _pallas_stats(rows, cols, a, b, shape, alpha):
    bal = ref_formats.BalancedCOO(rows, cols, jnp.zeros(rows.shape, jnp.float32),
                                  shape)
    wb = 8
    vt, vb, vs = map(jnp.asarray, ref_vsr.plan_visits(bal, wb))
    rm, rs = ref_chain.chain_stats_pallas(
        rows, cols, a, b, shape=shape, alpha=alpha, wb=wb, visit_tile=vt,
        visit_block=vb, visit_start=vs, interpret=True)
    m = shape[0]
    return np.asarray(rm).reshape(-1)[:m], np.asarray(rs).reshape(-1)[:m]


# ---------------------------------------------------------------------------
# the edge-run selection
# ---------------------------------------------------------------------------

def test_edge_slots_are_the_first_and_last_runs_of_each_tile():
    m = 9
    rows = torch.tensor([[0, 0, 0, 0],          # one row: all edge
                         [0, 1, 1, 2],          # head 0, interior 1, tail 2
                         [2, 2, 3, 3],          # two runs, both edge
                         [4, 5, 6, 6],          # interior 5
                         [6, 7, 8, 9],          # tail is padding (row m)
                         [9, 9, 9, 9]],         # all padding: nothing
                        dtype=torch.int32)
    want = torch.tensor([[1, 1, 1, 1],
                         [1, 0, 0, 1],
                         [1, 1, 1, 1],
                         [1, 0, 1, 1],
                         [1, 0, 0, 0],
                         [0, 0, 0, 0]], dtype=torch.bool)
    assert torch.equal(fused_chain.edge_slots(rows, m), want)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_edge_runs_continue_only_into_edge_runs(pattern):
    """A row that holds an edge run in one tile holds only edge runs: it is
    either inside one tile (and may be an edge run there) or crosses a
    tile boundary, where it is the last run of one tile and the first of
    the next."""
    dense, tile, pad = _pattern(pattern)
    _, (rows, _), shape = _slabs(dense, tile, pad)
    m = shape[0]
    edge = fused_chain.edge_slots(rows, m)
    for r in torch.unique(rows[rows < m]).tolist():
        tiles = torch.nonzero((rows == r).any(dim=1)).reshape(-1)
        if tiles.numel() > 1:
            assert edge[rows == r].all(), (pattern, r)
            assert bool((rows[tiles[1:], 0] == r).all())
            assert bool((rows[tiles[:-1], -1] == r).all())


# ---------------------------------------------------------------------------
# K7's edge mode and K8's order of work against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", PATTERNS)
def test_edge_stats_match_reference_on_edge_rows(pattern):
    dense, tile, pad = _pattern(pattern)
    (jr, jc), (tr, tc), shape = _slabs(dense, tile, pad)
    m = shape[0]
    a, b = _features(np.random.default_rng(3), *shape)
    want_xla = ref_spmm.chain_stats_xla(jr, jc, jnp.asarray(a), jnp.asarray(b),
                                        shape=shape, alpha=ALPHA)
    want_pallas = _pallas_stats(jr, jc, jnp.asarray(a), jnp.asarray(b), shape,
                                ALPHA)
    rm, rs = fused_chain.chain_stats_edge_plain(
        tr, tc, *map(torch.from_numpy, (a, b)), shape=shape, alpha=ALPHA)
    assert rm.shape == (m,) and rs.shape == (m,)
    edge_rows = torch.zeros(m, dtype=torch.bool)
    edge_rows[tr[fused_chain.edge_slots(tr, m)].long()] = True
    er = edge_rows.numpy()
    for wm, ws in ((np.asarray(want_xla[0])[:m], np.asarray(want_xla[1])[:m]),
                   want_pallas):
        _close(rm[edge_rows], wm[er])
        _close(rs[edge_rows], ws[er])
    # every other row, interior or empty, is left for K8
    assert (rm[~edge_rows] == spmm.SOFTMAX_NEG).all()
    assert (rs[~edge_rows] == 0).all()


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("transform,alpha", TRANSFORMS)
def test_order_of_work_matches_reference(pattern, transform, alpha):
    dense, tile, pad = _pattern(pattern)
    (jr, jc), (tr, tc), shape = _slabs(dense, tile, pad)
    rng = np.random.default_rng(4)
    a, b = _features(rng, *shape)
    x = rng.standard_normal((shape[1], 32)).astype(np.float32)
    kw = dict(shape=shape, transform=transform, alpha=alpha)
    ja, jb, jx = map(jnp.asarray, (a, b, x))
    want_xla = ref_spmm.chain_xla(jr, jc, ja, jb, jx, **kw)
    want_pallas = ref_chain.chain_pallas(jr, jc, ja, jb, jx, interpret=True,
                                         **kw)
    ta, tb, tx = map(torch.from_numpy, (a, b, x))
    got = fused_chain.chain_tiles_plain(tr, tc, ta, tb, tx, **kw)
    _close(got, want_xla)
    _close(got, want_pallas)
    empty = np.diff(np.asarray(csr_from_dense(dense).indptr)) == 0
    assert (got.numpy()[empty] == 0).all()          # empty rows exactly 0
    # the wrapper on CPU operands takes the "torch" backend's chain
    _close(fused_chain.chain_fused(tr, tc, ta, tb, tx, **kw), got)


@pytest.mark.parametrize("n", [1, 3, 4, 32, 128, 200])
@pytest.mark.parametrize("pattern", ["many_tiles", "tile_ends"])
def test_order_of_work_across_n(pattern, n):
    dense, tile, pad = _pattern(pattern)
    (jr, jc), (tr, tc), shape = _slabs(dense, tile, pad)
    rng = np.random.default_rng(n)
    a, b = _features(rng, *shape)
    x = rng.standard_normal((shape[1], n)).astype(np.float32)
    x = x[:, 0] if n == 1 else x
    kw = dict(shape=shape, transform="softmax", alpha=ALPHA)
    ja, jb, jx = map(jnp.asarray, (a, b, x))
    want_pallas = ref_chain.chain_pallas(jr, jc, ja, jb, jx, interpret=True,
                                         **kw)
    got = fused_chain.chain_tiles_plain(tr, tc, *map(torch.from_numpy, (a, b, x)),
                                        **kw)
    assert got.shape == tuple(want_pallas.shape)
    _close(got, ref_spmm.chain_xla(jr, jc, ja, jb, jx, **kw))
    _close(got, want_pallas)


def test_order_of_work_bf16_x_and_given_stats():
    dense, tile, pad = _pattern("many_tiles")
    (jr, jc), (tr, tc), shape = _slabs(dense, tile, pad)
    rng = np.random.default_rng(5)
    a, b = _features(rng, *shape)
    x = rng.standard_normal((shape[1], 24)).astype(np.float32)
    kw = dict(shape=shape, transform="softmax", alpha=ALPHA)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = ref_chain.chain_pallas(jr, jc, ja, jb, xb, interpret=True, **kw)
    got = fused_chain.chain_tiles_plain(tr, tc, ta, tb,
                                        torch.from_numpy(x).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), rtol=2e-2, atol_rel=2e-2)
    # given statistics (the sharded merge's contract) hold for every row;
    # the edge statistics alone leave interior rows unnormalised
    stats = fused_chain.chain_stats_plain(tr, tc, ta, tb, shape=shape,
                                          alpha=ALPHA)
    tx = torch.from_numpy(x)
    want = ref_spmm.chain_xla(jr, jc, ja, jb, jnp.asarray(x), **kw)
    _close(fused_chain.chain_tiles_plain(tr, tc, ta, tb, tx, stats=stats, **kw),
           want)
    edge = fused_chain.chain_stats_edge_plain(tr, tc, ta, tb, shape=shape,
                                              alpha=ALPHA)
    with pytest.raises(AssertionError):
        _close(fused_chain.chain_tiles_plain(tr, tc, ta, tb, tx, stats=edge,
                                             **kw), want)


def test_order_of_work_rejects_an_unknown_transform():
    dense, tile, pad = _pattern("one_tile")
    _, (tr, tc), shape = _slabs(dense, tile, pad)
    a, b = _features(np.random.default_rng(6), *shape)
    with pytest.raises(ValueError):
        fused_chain.chain_tiles_plain(tr, tc, *map(torch.from_numpy, (a, b)),
                                      torch.ones(shape[1], 2), shape=shape,
                                      transform="sigmoid")
