"""K11's tensor-core design on the CPU: its group layout, its routing rule,
the plan's one layout, and the layout-walking plain evaluator against the
reference.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``.  The
layout must reproduce the BSR's (block row, column, block) triples exactly;
products are float32 at rtol 1e-5 with atol 1e-5 of the result's largest
magnitude (the port sums a block row in another order).  The kernel itself
runs only on the card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.core import formats as ref_formats
from repro.kernels import bsr as ref_bsr
import repro_torch
from repro_torch import interop
from repro_torch.core import formats, plan as plan_mod, registry
from repro_torch.kernels import bsr

from conftest import random_csr

BLOCKS = [(8, 16), (8, 128), (16, 64)]


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _close(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    atol = 1e-5 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _mats():
    """Ragged M and K, empty block rows (an empty band), nnz = 0."""
    rng = np.random.default_rng(17)
    out = {"rand_33x70": random_csr(rng, 33, 70, 0.08)[0],
           "rand_203x333": random_csr(rng, 203, 333, 0.05)[0]}
    a = (rng.random((120, 300)) < 0.1) * rng.standard_normal((120, 300))
    a[17:90] = 0.0
    out["empty_band"] = ref_formats.csr_from_dense(a.astype(np.float32))
    out["nnz0"] = ref_formats.csr_from_dense(np.zeros((9, 6), np.float32))
    return out


MATS = _mats()


def _triples(b):
    """{(block row, column): block index} of a port BSR."""
    rows = formats.bsr_block_rows(b).tolist()
    return {(r, c): i for i, (r, c) in enumerate(zip(rows, b.indices.tolist()))}


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("group", ["one", "divisor", "non_divisor"])
def test_group_layout_reproduces_bsr_triples(block, group):
    bm = block[0]
    for name, csr in MATS.items():
        b = formats.csr_to_bsr(_port(csr), *block)
        mb = b.indptr.shape[0] - 1
        g = {"one": 1,
             "divisor": next((d for d in range(2, mb + 1) if mb % d == 0), 1),
             "non_divisor": next((d for d in range(2, mb + 2) if mb % d), 2)}[group]
        lay = bsr.build_groups(b, group_rows=g * bm)
        assert lay.group_blocks == g and lay.n_groups == -(-mb // g), name
        assert lay.ptr.dtype == lay.cols.dtype == lay.blocks.dtype == torch.int32
        assert lay.distinct and lay.matches(b)
        ptr = lay.ptr.tolist()
        assert ptr[0] == 0 and ptr[-1] == lay.cols.shape[0]
        assert lay.blocks.shape == (lay.cols.shape[0], g)
        got = {}
        for i in range(lay.n_groups):
            cols = lay.cols[ptr[i]:ptr[i + 1]].tolist()
            assert cols == sorted(set(cols)), (name, i)    # ascending, distinct
            for e, c in zip(range(ptr[i], ptr[i + 1]), cols):
                members = lay.blocks[e].tolist()
                assert max(members) >= 0, (name, i, c)     # no empty entry
                for j, blk in enumerate(members):
                    assert blk >= -1
                    if blk >= 0:
                        got[(i * g + j, c)] = blk
        assert got == _triples(b), name
        # the kernel's view: the first block-array row of each n8 tile
        if g * bm > bsr.GROUP_ROWS:
            assert lay.tiles is None
            continue
        sub = bm // 8
        assert lay.tiles.shape == (lay.cols.shape[0], bsr.GROUP_ROWS // 8)
        for e, members in enumerate(lay.blocks.tolist()):
            want = [members[j // sub] * bm + (j % sub) * 8
                    if j < g * sub and members[j // sub] >= 0 else -1
                    for j in range(bsr.GROUP_ROWS // 8)]
            assert lay.tiles[e].tolist() == want, (name, e)


def test_group_layout_flags_repeated_blocks():
    """A BSR that holds two blocks at one (block row, column) — never one
    from ``csr_to_bsr`` — is not ``distinct``: the layout cannot list both,
    so the routing sends it to the fma design and the layout's plain walk
    refuses it; the wrapper's plain version still sums both."""
    blocks = torch.arange(3 * 8 * 16, dtype=torch.float32).reshape(3, 8, 16)
    b = formats.BSR(torch.tensor([0, 2, 3], dtype=torch.int32),
                    torch.tensor([1, 1, 0], dtype=torch.int32), blocks,
                    (16, 32), (8, 16))
    lay = bsr.build_groups(b)
    assert not lay.distinct
    x = torch.ones(32, 3)
    with pytest.raises(ValueError, match="repeated"):
        bsr.spmm_bsr_groups_plain(b, x, lay)
    want = blocks[0].sum(1) + blocks[1].sum(1)
    torch.testing.assert_close(bsr.spmm_bsr(b, x)[:8, 0], want)
    assert bsr.build_groups(formats.csr_to_bsr(_port(MATS["rand_33x70"]),
                                               8, 16)).distinct


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", [0, 20])
def test_groups_plain_matches_pallas(block, n):
    """``test_kernels_pallas.py::test_bsr_sweep``'s shapes and densities
    (1-D x at n = 0), the layout-walking evaluator against the Pallas kernel
    in interpret mode."""
    rng = np.random.default_rng(20 + n)
    for m, k in ((64, 300), (100, 80)):
        for density in (0.05, 0.3):
            csr, _ = random_csr(rng, m, k, density)
            x = rng.standard_normal((k, n) if n else (k,)).astype(np.float32)
            want = ref_bsr.spmm_bsr(ref_formats.csr_to_bsr(csr, *block),
                                    jnp.asarray(x), interpret=True)
            b = formats.csr_to_bsr(_port(csr), *block)
            got = bsr.spmm_bsr_groups_plain(b, torch.from_numpy(x))
            assert got.shape == tuple(want.shape) and got.dtype == torch.float32
            _close(got, want)
            _close(bsr.spmm_bsr_groups_plain(b, torch.from_numpy(x),
                                             bsr.build_groups(b, 16)), want)


@pytest.mark.parametrize("block", BLOCKS)
def test_groups_plain_on_empty_rows_and_nnz0(block):
    rng = np.random.default_rng(3)
    for name in ("empty_band", "nnz0", "rand_203x333"):
        csr = MATS[name]
        x = rng.standard_normal((csr.shape[1], 7)).astype(np.float32)
        b = formats.csr_to_bsr(_port(csr), *block)
        got = bsr.spmm_bsr_groups_plain(b, torch.from_numpy(x))
        _close(got, np.asarray(ref_formats.bsr_to_dense(
            ref_formats.csr_to_bsr(csr, *block))) @ x)
        if name == "empty_band":
            assert (got[24:80] == 0).all()


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("bm,bk,wdtype,xdtype,n,design", [
    (8, 128, F32, F32, bsr.TC_MIN_N, "tc"),
    (8, 128, F32, F32, 128, "tc"),
    (8, 128, F32, F32, 4, "fma"),
    (8, 128, F32, F32, 1, "fma"),
    (8, 128, F32, F32, bsr.TC_MIN_N - 1, "fma"),
    (8, 128, BF16, BF16, 32, "tc"),
    (16, 64, F32, F32, 32, "tc"),
    (64, 128, BF16, BF16, 200, "tc"),
    (8, 8, F32, F32, 32, "tc"),          # bk of one TF32 MMA depth
    (8, 8, BF16, BF16, 32, "fma"),       # below bf16's depth of 16
    (8, 24, BF16, BF16, 32, "fma"),
    (12, 16, F32, F32, 32, "fma"),       # bm not a multiple of 8
    (128, 8, F32, F32, 32, "fma"),       # over a group's 64 rows
    (8, 128, BF16, F32, 32, "fma"),      # mixed types
    (8, 128, F32, BF16, 32, "fma"),
])
def test_routing_rule(bm, bk, wdtype, xdtype, n, design):
    b = formats.BSR(torch.zeros(2, dtype=torch.int32),
                    torch.zeros(0, dtype=torch.int32),
                    torch.zeros((0, bm, bk), dtype=wdtype), (bm, 3 * bk),
                    (bm, bk))
    assert bsr._design(b, torch.zeros((3 * bk, n), dtype=xdtype)) == design


def test_routing_rule_unaligned_blocks():
    """Blocks that do not start on 16 bytes (a view into a larger buffer)
    go to the fma design: the tensor-core kernel copies them 16 bytes at a
    time."""
    buf = torch.zeros(1 + 2 * 8 * 128)
    for blocks, design in ((buf[1:].view(2, 8, 128), "fma"),
                           (buf[:-1].view(2, 8, 128), "tc")):
        b = formats.BSR(torch.tensor([0, 2], dtype=torch.int32),
                        torch.tensor([0, 1], dtype=torch.int32), blocks,
                        (8, 256), (8, 128))
        assert bsr._design(b, torch.zeros((256, 32))) == design


def test_tc_columns():
    assert [bsr.tc_columns(n) for n in (1, 16, 17, 32, 33, 64, 65, 128, 200)] \
        == [32, 32, 32, 32, 64, 64, 128, 128, 128]


def test_prep_hook_builds_one_layout_per_plan(monkeypatch):
    """The four logical kernels resolve to the one K11 entry; its prep hook
    builds the group layout once per plan, and a live value stream reuses
    it unchanged."""
    built, seen = [], []
    real_build, real_spmm = bsr.build_groups, bsr.spmm_bsr

    def counting_build(b, *a, **kw):
        built.append(b)
        return real_build(b, *a, **kw)

    def spying_spmm(b, x, layout=None):
        seen.append(layout)
        return real_spmm(b, x, layout=layout)

    monkeypatch.setattr(bsr, "build_groups", counting_build)
    monkeypatch.setattr(bsr, "spmm_bsr", spying_spmm)
    csr = MATS["rand_203x333"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((csr.shape[1], 6)).astype(np.float32)
    p = plan_mod.plan(_port(csr), backend="bsr", bsr_block=(8, 16))
    dense = np.asarray(ref_formats.bsr_to_dense(ref_formats.csr_to_bsr(csr, 8, 16)))
    for impl in registry.MATMUL_KERNELS:
        _close(plan_mod.execute(p, torch.from_numpy(x), impl=impl), dense @ x)
    layouts = {id(p.kernel_opts(p.entry(impl))["layout"])
               for impl in registry.MATMUL_KERNELS}
    assert len(built) == 1 and len(layouts) == 1
    layout = p.kernel_opts(p.entry("nb_pr"))["layout"]
    assert all(s is layout for s in seen) and len(seen) == 4
    vals = 2 * np.asarray(csr.data)
    got = plan_mod.execute(p, torch.from_numpy(x), vals=torch.from_numpy(vals))
    _close(got, 2 * (dense @ x))
    assert len(built) == 1 and seen[-1] is layout
    # a live stream rebuilds the blocks in the same order: the layout still
    # describes them
    live = formats.BSR(layout.indptr, layout.indices,
                       2 * p.substrate("bsr").blocks, (203, 333), (8, 16))
    assert layout.matches(live)
    _close(bsr.spmm_bsr_groups_plain(live, torch.from_numpy(x), layout),
           2 * (dense @ x))


def test_nonfinite_x_is_confined_to_rows_with_a_block_there():
    """W (16, 32) at ``bsr_block=(8, 16)``: block row 0 holds blocks at
    columns 0 and 1, block row 1 only at column 1; x is ones with
    ``x[3, 0] = nan`` and ``x[5, 1] = inf`` (both in X's slab 0).  Block row
    1 never multiplies slab 0, so its rows are the sum 16.  The reference's
    own ``"bsr"`` backend gives NaN there: its block-ELL padding slot of
    block row 1 gathers X's block column 0 and multiplies it by a zero
    block.  The port follows the reference's ``"xla"`` backend, which gives
    16; the reference is not changed."""
    w = np.zeros((16, 32), np.float32)
    w[0:8, :] = 1.0
    w[8:16, 16:32] = 1.0
    x = np.ones((32, 4), np.float32)
    x[3, 0] = np.nan
    x[5, 1] = np.inf
    ref_csr = ref_formats.csr_from_dense(w)
    want = np.asarray(ref_api.sparse(ref_csr, backend="xla", cache=False)
                      @ jnp.asarray(x))
    assert np.isnan(want[:8, 0]).all() and np.isinf(want[:8, 1]).all()
    assert (want[8:] == 16).all()
    A = repro_torch.sparse(_port(ref_csr), device="cpu", backend="bsr",
                           bsr_block=(8, 16), cache=False)
    got = A @ torch.from_numpy(x)
    np.testing.assert_array_equal(got.numpy(), want)
    b = A.plan.substrate("bsr")
    for y in (bsr.spmm_bsr_plain(b, torch.from_numpy(x)),
              bsr.spmm_bsr_groups_plain(b, torch.from_numpy(x))):
        np.testing.assert_array_equal(y.numpy(), want)
