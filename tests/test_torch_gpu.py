"""Each CUDA kernel of the port (K1-K11) against its plain PyTorch
version, on the card.  Marked ``gpu``: they skip without a CUDA device (the kernels have no
CPU mode).  This file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: relative inf-norm error 1e-4 in float32 (sums in another order,
atomics in no fixed order), 2e-2 with a bfloat16 x."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.attention import patterns
from repro_torch.core import formats
from repro_torch.core.plan import _stream_to_balanced
from repro_torch.core.rmat import rmat
from repro_torch.kernels import (attention, bsr, csc, fused_chain,
                                 launch_counts, reset_launch_counts, spmv, vsr)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _graphs(device):
    a = np.zeros((300, 90), np.float32)
    rng = np.random.default_rng(0)
    a[:40] = (rng.random((40, 90)) < 0.3) * rng.standard_normal((40, 90))
    a[250:] = (rng.random((50, 90)) < 0.3) * rng.standard_normal((50, 90))
    return {"skewed": rmat(9, 8, seed=3, device=device),
            "uniform": rmat(9, 8, 0.25, 0.25, 0.25, seed=4, device=device),
            "empty_band": formats.csr_from_dense(a, device=device)}


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 20, 32, 64, 128, 200])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, n, xdtype):
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, csr in _graphs(cuda).items():
        x = torch.randn(csr.shape[1], n, device=cuda).to(xdtype)
        for tile in (32, 100, 512):
            bal = formats.csr_to_balanced(csr, tile)
            assert _rel(vsr.spmm_vsr_fused(bal, x), vsr.spmm_vsr_plain(bal, x)) < tol, name
            x1 = x[:, 0].contiguous()
            assert _rel(spmv.spmv_vsr_fused(bal, x1), spmv.spmv_vsr_plain(bal, x1)) < tol, name
        ell = formats.csr_to_ell(csr)
        assert _rel(csc.spmm_csc(ell, x), csc.spmm_csc_plain(ell, x)) < tol, name
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_bf16_values(cuda):
    csr = _graphs(cuda)["skewed"]
    csr = formats.CSR(csr.indptr, csr.indices, csr.data.bfloat16(), csr.shape)
    x = torch.randn(csr.shape[1], 16, device=cuda)
    bal, ell = formats.csr_to_balanced(csr, 256), formats.csr_to_ell(csr)
    assert _rel(vsr.spmm_vsr_fused(bal, x), vsr.spmm_vsr_plain(bal, x)) < 1e-4
    assert _rel(spmv.spmv_vsr_fused(bal, x[:, 0].contiguous()),
                spmv.spmv_vsr_plain(bal, x[:, 0].contiguous())) < 1e-4
    assert _rel(csc.spmm_csc(ell, x), csc.spmm_csc_plain(ell, x)) < 1e-4


@pytest.mark.gpu
def test_cuda_kernels_count_launches_and_reject(cuda):
    csr = _graphs(cuda)["skewed"]
    bal = formats.csr_to_balanced(csr, 64)
    reset_launch_counts()
    vsr.spmm_vsr_fused(bal, torch.randn(csr.shape[1], 8, device=cuda))
    spmv.spmv_vsr_fused(bal, torch.randn(csr.shape[1], device=cuda))
    csc.spmm_csc(formats.csr_to_ell(csr), torch.randn(csr.shape[1], 8, device=cuda))
    one_each = {"vsr_spmm": 1, "vsr_spmv": 1, "csc_spmm": 1, "sddmm": 0,
                "chain_stats": 0, "chain": 0, "attn_stats": 0,
                "attn_chain": 0, "bsr_spmm": 0, "vsr_spmm_spill": 0,
                "vsr_spmv_spill": 0, "spill_combine": 0}
    assert launch_counts() == one_each
    with pytest.raises(ValueError):          # no float64 kernel
        vsr.spmm_vsr_fused(bal, torch.randn(csr.shape[1], 8, device=cuda,
                                            dtype=torch.float64))
    with pytest.raises(ValueError):          # strided x
        vsr.spmm_vsr_fused(bal, torch.randn(8, csr.shape[1], device=cuda).t())
    with pytest.raises(ValueError):          # over the shared-memory staging
        vsr.spmm_vsr_fused(formats.csr_to_balanced(csr, 8192),
                           torch.randn(csr.shape[1], 8, device=cuda))
    with pytest.raises(ValueError):          # operands on two devices
        vsr.spmm_vsr_fused(bal, torch.randn(csr.shape[1], 8))
    assert launch_counts() == one_each


@pytest.mark.gpu
def test_cuda_facade_main_path(cuda):
    import repro_torch
    for name, csr in _graphs(cuda).items():
        for n in (1, 4, 32):
            x = torch.randn(csr.shape[1], n, device=cuda)
            x = x[:, 0].contiguous() if n == 1 else x
            A = repro_torch.sparse(csr, cache=False)
            assert A.backend == "hopper"
            reset_launch_counts()
            y = A @ x
            assert sum(launch_counts().values()) == 1
            assert _rel(y, A.matmul(x, backend="torch")) < 1e-4, (name, n)


def _chain_operands(csr, d, n, dtype=torch.float32, xdtype=torch.float32):
    m, k = csr.shape
    a = (0.3 * torch.randn(m, d, device=csr.device)).to(dtype)
    b = (0.3 * torch.randn(k, d, device=csr.device)).to(dtype)
    x = torch.randn(k, n, device=csr.device).to(xdtype)
    return a, b, x


def _offset_view(t):
    """``t``'s values in a contiguous view one element past an aligned
    buffer's start: the kernels take their scalar loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 4, 6, 8, 16, 64, 128, 200, 256, 264])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sddmm_and_stats_match_plain(cuda, d, dtype):
    """K6 as routed by d and in each design, forced ("seq": a thread a
    slot; "par": lane groups over ranges), against the plain version at
    tiles of 32, 100, 512 and 4096 slots: a hub row longer than most tiles
    and rows that cross a "par" group's range (``_nb_mats``), on aligned
    operands and on A and B views offset by one element (scalar loads),
    padding slots exactly 0, the design each launch took in
    ``DESIGN_LAUNCHES["sddmm"]``; then K7 on the same operands."""
    routed = fused_chain._sddmm_design(d, dtype)
    assert routed == ("seq" if d <= 16 // torch.empty((), dtype=dtype).element_size()
                      else "par")
    for name, csr in _nb_mats(cuda):
        a, b, _ = _chain_operands(csr, d, 1, dtype)
        offset = tuple(_offset_view(t) for t in (a, b))
        for tile in (32, 100, 512, 4096):
            bal = formats.csr_to_balanced(csr, tile)
            pat = (bal.rows, bal.cols)
            want = fused_chain.sddmm_plain(*pat, a, b, shape=csr.shape)
            for design in (None, "seq", "par"):
                for ab in ((a, b), offset):
                    reset_launch_counts()
                    e = (fused_chain.sddmm_fused(*pat, *ab, shape=csr.shape)
                         if design is None else fused_chain._launch_sddmm(
                             design, *pat, *ab, shape=csr.shape))
                    ran = design or routed
                    label = (name, tile, design, ab is offset)
                    assert fused_chain.DESIGN_LAUNCHES["sddmm"] == {
                        "seq": int(ran == "seq"), "par": int(ran == "par")}, label
                    assert launch_counts()["sddmm"] == 1, label
                    assert e.dtype == torch.float32 and e.shape == bal.rows.shape
                    assert _rel(e, want) < 1e-4, label
                    assert (e.reshape(-1)[csr.nnz:] == 0).all(), label
    with pytest.raises(ValueError):
        fused_chain._launch_sddmm("tc", *pat, a, b, shape=csr.shape)
    for name, csr in _graphs(cuda).items():
        a, b, _ = _chain_operands(csr, d, 1, dtype)
        for tile in (32, 100, 512):
            bal = formats.csr_to_balanced(csr, tile)
            args = (bal.rows, bal.cols, a, b)
            rm, rs = fused_chain.chain_stats_fused(*args, shape=csr.shape, alpha=0.7)
            pm, ps = fused_chain.chain_stats_plain(*args, shape=csr.shape, alpha=0.7)
            empty = torch.diff(csr.indptr) == 0
            assert (rm[empty] == -1e30).all() and (rs[empty] == 0).all(), name
            assert _rel(rm[~empty], pm[~empty]) < 1e-4, name
            assert _rel(rs, ps) < 1e-4, name
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 32, 128, 200])
@pytest.mark.parametrize("transform,alpha", [("identity", None), ("scale", 0.5),
                                             ("softmax", None), ("softmax", 0.7)])
def test_cuda_chain_matches_plain(cuda, n, transform, alpha):
    for name, csr in _graphs(cuda).items():
        a, b, x = _chain_operands(csr, 16, n)
        empty = torch.diff(csr.indptr) == 0
        for tile in (32, 512):
            bal = formats.csr_to_balanced(csr, tile)
            args = (bal.rows, bal.cols, a, b, x)
            kw = dict(shape=csr.shape, transform=transform, alpha=alpha)
            y = fused_chain.chain_fused(*args, **kw)
            assert _rel(y, fused_chain.chain_plain(*args, **kw)) < 1e-4, name
            assert (y[empty] == 0).all(), name
            y1 = fused_chain.chain_fused(*args[:4], x[:, 0].contiguous(), **kw)
            assert y1.shape == (csr.shape[0],)
            assert _rel(y1, y[:, 0]) < 1e-4, name
            yu = fused_chain.chain_unfused(*args, **kw)
            assert _rel(yu, y) < 1e-4, name
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_chain_bf16_and_external_stats(cuda):
    csr = _graphs(cuda)["skewed"]
    bal = formats.csr_to_balanced(csr, 256)
    a, b, x = _chain_operands(csr, 64, 32, torch.bfloat16, torch.bfloat16)
    kw = dict(shape=csr.shape, transform="softmax", alpha=0.125)
    y = fused_chain.chain_fused(bal.rows, bal.cols, a, b, x, **kw)
    assert y.dtype == torch.bfloat16
    assert _rel(y, fused_chain.chain_plain(bal.rows, bal.cols, a, b, x, **kw)) < 2e-2
    stats = fused_chain.chain_stats_fused(bal.rows, bal.cols, a, b,
                                          shape=csr.shape, alpha=0.125)
    reset_launch_counts()
    ys = fused_chain.chain_fused(bal.rows, bal.cols, a, b, x, stats=stats, **kw)
    assert launch_counts()["chain_stats"] == 0 and launch_counts()["chain"] == 1
    assert torch.equal(ys, y) or _rel(ys, y) < 1e-6
    with pytest.raises(ValueError):          # A and B of two types
        fused_chain.sddmm_fused(bal.rows, bal.cols, a, b.float(), shape=csr.shape)
    with pytest.raises(ValueError):          # B of the wrong height
        fused_chain.sddmm_fused(bal.rows, bal.cols, a, b[1:], shape=csr.shape)
    with pytest.raises(ValueError):
        fused_chain.chain_fused(bal.rows, bal.cols, a, b, x, shape=csr.shape,
                                transform="sigmoid")


@pytest.mark.gpu
def test_cuda_chain_facade_main_path(cuda):
    import dataclasses
    import repro_torch
    for name, csr in _graphs(cuda).items():
        a, b, x = _chain_operands(csr, 64, 32)
        A = repro_torch.sparse(csr, cache=False, chain_op="softmax")
        assert A.backend == "hopper"
        reset_launch_counts()
        y = A.chain(a, b, x, alpha=0.125)
        assert launch_counts()["chain_stats"] == 1 and launch_counts()["chain"] == 1
        assert _rel(y, A.chain(a, b, x, alpha=0.125, backend="torch")) < 1e-4, name
        e = repro_torch.sddmm(csr, a, b)
        assert e.shape == (csr.nnz,)
        assert _rel(e, A.sddmm(a, b, backend="torch")) < 1e-4, name
        th = dataclasses.replace(repro_torch.SelectorThresholds(),
                                 chain_fuse_min_n=1 << 30)
        reset_launch_counts()
        yu = repro_torch.sparse_chain(csr, a, b, x, alpha=0.125, thresholds=th,
                                      cache=False)
        counts = launch_counts()
        assert (counts["sddmm"], counts["chain_stats"], counts["vsr_spmm"],
                counts["chain"]) == (1, 1, 1, 0), counts
        assert _rel(yu, y) < 1e-4, name
        # an operand requiring grad: the card's backward, x's alone (the
        # recompute's K6 and K7, then Aᵀ's SpMM), against the plain one
        from repro_torch.core.vjp import chain_bwd_plain
        xg = x.clone().requires_grad_()
        yg = A.chain(a, b, xg, alpha=0.125)
        reset_launch_counts()
        yg.sum().backward()
        counts = launch_counts()
        assert (counts["sddmm"], counts["chain_stats"]) == (1, 1), counts
        rows, cols = formats.balanced_pattern(csr, A.plan.tile)
        want = chain_bwd_plain(rows, cols, a, b, x, torch.ones_like(y), csr.shape,
                               "softmax", 0.125)
        assert _rel(xg.grad, want[2]) < 1e-4, name



def _fault_33(device, inf_nan=True):
    """Fault 3.3's input: every score of row 10 is −inf (A[10] = (−inf, 0,
    ...), B[:, 0] = 1, alpha > 0); in a 512-slot tile row 10 is neither
    the first run nor the last.  With ``inf_nan``, row 20 scores +inf and
    row 25 NaN."""
    rng = np.random.default_rng(7)
    m, k, d = 40, 30, 8
    dense = ((rng.random((m, k)) < 0.3)
             * rng.standard_normal((m, k))).astype(np.float32)
    dense[10] = 0.0
    dense[10, [3, 7, 20]] = 1.0
    a = (rng.standard_normal((m, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((k, d)) * 0.3).astype(np.float32)
    b[:, 0] = 1.0
    a[10] = 0.0
    a[10, 0] = -np.inf
    if inf_nan:
        a[20] = 0.0
        a[20, 0] = np.inf
        a[25, 3] = np.nan
    x = rng.standard_normal((k, 5)).astype(np.float32)
    csr = formats.csr_from_dense(dense, device=device)
    return csr, *(torch.from_numpy(t).to(device) for t in (a, b, x))


def _same_stats(got, want):
    """K7's statistics against the plain version's: the same NaN and inf
    pattern of the sums, and the maxima of the rows whose sum is a number
    (where a NaN or +inf score makes the sum NaN, the max is not compared:
    the kernel's floored max drops a NaN)."""
    (rm, rs), (pm, ps) = got, want
    _same_nonfinite(rs, ps, 1e-4)
    keep = ~torch.isnan(ps)
    _same_nonfinite(rm[keep], pm[keep], 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [8, 16, 512])
@pytest.mark.parametrize("inf_nan", [False, True], ids=["minus_inf", "inf_nan"])
def test_cuda_chain_fault_33_public_calls(cuda, tile, inf_nan):
    """Fault 3.3 through the public wrappers (K7 full mode, the fused chain):
    the −inf row has statistics (−1e30, 0) and Y exactly 0."""
    csr, a, b, x = _fault_33(cuda, inf_nan)
    bal = formats.csr_to_balanced(csr, tile)
    args = (bal.rows, bal.cols, a, b)
    kw = dict(shape=csr.shape, alpha=0.7)
    rm, rs = fused_chain.chain_stats_fused(*args, **kw)
    assert rm[10] == -1e30 and rs[10] == 0
    _same_stats((rm, rs), fused_chain.chain_stats_plain(*args, **kw))
    for xx in (x, x[:, 0].contiguous()):
        y = fused_chain.chain_fused(*args, xx, transform="softmax", **kw)
        assert (y[10] == 0).all()
        _same_nonfinite(y, fused_chain.chain_plain(*args, xx, transform="softmax",
                                                   **kw), 1e-4)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [8, 16, 512])
def test_cuda_chain_fault_33_both_modes(cuda, tile):
    """Fault 3.3 in K7's full and edge modes and in K8 on edge statistics
    and on given statistics."""
    csr, a, b, x = _fault_33(cuda)
    bal = formats.csr_to_balanced(csr, tile)
    args = (bal.rows, bal.cols, a, b)
    kw = dict(shape=csr.shape, alpha=0.7)
    full = fused_chain._launch_stats("slot", *args, **kw)
    _same_stats(full, fused_chain.chain_stats_plain(*args, **kw))
    edge = fused_chain._launch_stats("slot", *args, edge=True, **kw)
    _same_stats(edge, fused_chain.chain_stats_edge_plain(*args, **kw))
    ck = dict(kw, transform="softmax")
    want = fused_chain.chain_plain(*args, x, **ck)
    for n in (1, 4, 5):
        xx = x[:, :n].contiguous()
        w = want[:, :n]
        for y in (fused_chain.chain_fused(*args, xx, **ck),
                  fused_chain.chain_fused(*args, xx, stats=full, **ck)):
            assert (y[10] == 0).all()
            _same_nonfinite(y, w, 1e-4)
    torch.cuda.synchronize()


class _Shape:
    """A stand-in with the ``shape`` and ``device`` of a CSR, for
    ``_chain_operands``."""

    def __init__(self, shape, device):
        self.shape, self.device = shape, device


def _slot_patterns(device):
    """(name, BalancedCOO) of the slot-tile chain's cases: the test graphs
    at tiles 32 and 512, a hub row that covers whole tiles (one-run tiles)
    with short rows around it, runs that end at a tile's end, and the
    skewed graph with an all-padding tile appended."""
    rng = np.random.default_rng(11)
    hub = np.zeros((50, 3000), np.float32)
    hub[:20] = (rng.random((20, 3000)) < 0.004)
    hub[20] = 1.0
    hub[21:] = (rng.random((29, 3000)) < 0.004)
    ends = np.zeros((13, 40), np.float32)
    for i, n in enumerate([16, 10, 6, 5, 11, 3, 3, 3, 3, 4, 0, 16, 2]):
        ends[i, rng.choice(40, n, replace=False)] = 1.0
    graphs = _graphs(device)
    for name, csr in graphs.items():
        for tile in (32, 512):
            yield f"{name}_t{tile}", formats.csr_to_balanced(csr, tile)
    for tile in (64, 512):
        yield f"hub_t{tile}", formats.csr_to_balanced(
            formats.csr_from_dense(hub, device=device), tile)
    yield "tile_ends_t16", formats.csr_to_balanced(
        formats.csr_from_dense(ends, device=device), 16)
    bal = formats.csr_to_balanced(graphs["skewed"], 100)
    m = bal.shape[0]
    pad = lambda t, v: torch.cat([t, torch.full_like(t[:1], v)])
    yield "padding_tile_t100", formats.BalancedCOO(
        pad(bal.rows, m), pad(bal.cols, 0), pad(bal.vals, 0), bal.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chain_stats_modes_match_plain(cuda, dtype):
    """K7's full mode (every row) and edge mode (the rows of each tile's
    first and last runs; every other row exactly (−1e30, 0))."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, bal in _slot_patterns(cuda):
        m = bal.shape[0]
        for d in (16, 64):
            a, b, _ = _chain_operands(_Shape(bal.shape, cuda), d, 1, dtype)
            args = (bal.rows, bal.cols, a, b)
            kw = dict(shape=bal.shape, alpha=0.7)
            pm, ps = fused_chain.chain_stats_plain(*args, **kw)
            reset_launch_counts()
            rm, rs = fused_chain._launch_stats("slot", *args, **kw)
            em, es = fused_chain._launch_stats("slot", *args, edge=True, **kw)
            assert fused_chain.STATS_MODES == {"full": 1, "edge": 1}, name
            held = ps > 0
            assert _rel(rm[held], pm[held]) < tol and _rel(rs, ps) < tol, name
            assert (rm[~held] == -1e30).all() and (rs[~held] == 0).all(), name
            edge_rows = torch.zeros(m, dtype=torch.bool, device=cuda)
            edge_rows[bal.rows[fused_chain.edge_slots(bal.rows, m)].long()] = True
            assert _rel(em[edge_rows], pm[edge_rows]) < tol, name
            assert _rel(es[edge_rows], ps[edge_rows]) < tol, name
            assert (em[~edge_rows] == -1e30).all(), name
            assert (es[~edge_rows] == 0).all(), name
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 32, 128, 200])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_cuda_chain_slot_k8_matches_plain(cuda, n, xdtype, aligned):
    """The slot-tile K8 on K7's edge statistics (the fused chain), and on
    given statistics, identity and scale: N = 1 through the sum scan, N > 1
    by 4-column gathers (16-byte where N % 4 == 0 and X is aligned)."""
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, bal in _slot_patterns(cuda):
        m, k = bal.shape
        a, b, _ = _chain_operands(_Shape(bal.shape, cuda), 16, 1)
        buf = torch.randn(k * n + 1, device=cuda).to(xdtype)
        x = (buf[:-1] if aligned else buf[1:]).view(k, n)
        x = x[:, 0] if n == 1 else x
        args = (bal.rows, bal.cols, a, b, x)
        empty = torch.ones(m, dtype=torch.bool, device=cuda)
        empty[bal.rows[bal.rows < m].long()] = False
        for transform, alpha in (("softmax", 0.7), ("identity", None),
                                 ("scale", 0.5)):
            kw = dict(shape=bal.shape, transform=transform, alpha=alpha)
            reset_launch_counts()
            y = fused_chain._launch_chain("slot", *args, **kw)
            assert fused_chain.STATS_MODES == {
                "full": 0, "edge": int(transform == "softmax")}, name
            assert y.dtype == xdtype and y.shape == ((m, n) if n > 1 else (m,))
            want = fused_chain.chain_plain(*args, **kw)
            assert _rel(y, want) < tol, (name, transform)
            assert _rel(y, fused_chain.chain_tiles_plain(*args, **kw)) < tol, name
            assert (y[empty] == 0).all(), (name, transform)
        stats = fused_chain.chain_stats_plain(*args[:4], shape=bal.shape,
                                              alpha=0.7)
        reset_launch_counts()
        y = fused_chain._launch_chain("slot", *args, shape=bal.shape,
                                      transform="softmax", alpha=0.7,
                                      stats=stats)
        assert launch_counts()["chain_stats"] == 0
        assert fused_chain.STATS_MODES == {"full": 0, "edge": 0}
        assert _rel(y, fused_chain.chain_plain(*args, shape=bal.shape,
                                               transform="softmax", alpha=0.7,
                                               stats=stats)) < tol, name
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [2048, 4096])
def test_cuda_chain_slot_large_tiles(cuda, tile):
    """Tiles past 48 KB of K8's shared memory (its per-slot run statistics
    at 4,096 slots): K7 in both modes and K8 at N = 1 and 128."""
    for name, bal in _slot_patterns(cuda):
        if not name.startswith(("hub_t512", "skewed_t512")):
            continue
        rows = bal.rows.reshape(-1)
        cols = bal.cols.reshape(-1)
        pad = (-rows.numel()) % tile
        m = bal.shape[0]
        rows = torch.cat([rows, rows.new_full((pad,), m)]).view(-1, tile)
        cols = torch.cat([cols, cols.new_zeros(pad)]).view(-1, tile)
        a, b, _ = _chain_operands(_Shape(bal.shape, cuda), 64, 1)
        kw = dict(shape=bal.shape, alpha=0.7)
        args = (rows, cols, a, b)
        pm, ps = fused_chain.chain_stats_plain(*args, **kw)
        rm, rs = fused_chain._launch_stats("slot", *args, **kw)
        assert _rel(rs, ps) < 1e-4, name
        em, es = fused_chain._launch_stats("slot", *args, edge=True, **kw)
        wm, ws = fused_chain.chain_stats_edge_plain(*args, **kw)
        assert _rel(es, ws) < 1e-4 and torch.equal(es == 0, ws == 0), name
        for n in (1, 128):
            x = torch.randn(bal.shape[1], n, device=cuda)
            ck = dict(kw, transform="softmax")
            y = fused_chain._launch_chain("slot", *args, x, **ck)
            assert _rel(y, fused_chain.chain_plain(*args, x, **ck)) < 1e-4, name
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_chain_bf16_features_on_edge_stats(cuda):
    """bf16 A and B (and X) through the fused chain on the hub pattern."""
    for name, bal in _slot_patterns(cuda):
        if not name.startswith(("hub", "skewed")):
            continue
        a, b, x = _chain_operands(_Shape(bal.shape, cuda), 64, 32,
                                  torch.bfloat16, torch.bfloat16)
        kw = dict(shape=bal.shape, transform="softmax", alpha=0.125)
        y = fused_chain.chain_fused(bal.rows, bal.cols, a, b, x, **kw)
        want = fused_chain.chain_plain(bal.rows, bal.cols, a, b, x, **kw)
        assert y.dtype == torch.bfloat16 and _rel(y, want) < 2e-2, name


@pytest.mark.gpu
def test_cuda_chain_stats_mode_counters(cuda):
    """The fused chain's softmax launches K7 in edge mode; chain_stats_fused,
    the unfused pair and the facade with the fuse gate shut launch it in full
    mode; identity, scale, given statistics and the block design launch
    neither."""
    import repro_torch
    csr = _graphs(cuda)["skewed"]
    bal = formats.csr_to_balanced(csr, 512)
    a, b, x = _chain_operands(csr, 64, 32)
    args = (bal.rows, bal.cols, a, b)
    kw = dict(shape=csr.shape, alpha=0.125)

    def modes(call):
        reset_launch_counts()
        call()
        torch.cuda.synchronize()
        return dict(fused_chain.STATS_MODES)

    assert modes(lambda: fused_chain.chain_fused(
        *args, x, transform="softmax", **kw)) == {"full": 0, "edge": 1}
    assert modes(lambda: fused_chain.chain_stats_fused(*args, **kw)) == {
        "full": 1, "edge": 0}
    assert modes(lambda: fused_chain.chain_unfused(
        *args, x, transform="softmax", **kw)) == {"full": 1, "edge": 0}
    for transform in ("identity", "scale"):
        assert modes(lambda: fused_chain.chain_fused(
            *args, x, transform=transform, **kw)) == {"full": 0, "edge": 0}
    stats = fused_chain.chain_stats_plain(*args, **kw)
    assert modes(lambda: fused_chain.chain_fused(
        *args, x, transform="softmax", stats=stats, **kw)) == {"full": 0,
                                                                "edge": 0}
    assert modes(lambda: repro_torch.sparse_chain(
        csr, a, b, x, alpha=0.125, cache=False)) == {"full": 0, "edge": 1}
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               chain_fuse_min_n=1 << 30)
    assert modes(lambda: repro_torch.sparse_chain(
        csr, a, b, x, alpha=0.125, thresholds=shut, cache=False)) == {
            "full": 1, "edge": 0}
    spec = patterns.sliding_window(512, 2, block=64, causal=True)
    band = formats.csr_to_balanced(patterns.build_mask(spec).csr.to(cuda), 512)
    q, kk = (0.3 * torch.randn(512, 64, device=cuda) for _ in range(2))
    assert modes(lambda: fused_chain.chain_fused(
        band.rows, band.cols, q, kk, torch.randn(512, 64, device=cuda),
        shape=(512, 512), transform="softmax", alpha=0.125)) == {"full": 0,
                                                                 "edge": 0}
    assert fused_chain.DESIGN_LAUNCHES["chain"] == {"block": 1, "slot": 0}
    with pytest.raises(ValueError):           # the block design has no edge mode
        fused_chain._launch_stats("block", band.rows, band.cols, q, kk,
                                  shape=(512, 512), edge=True)

def _attention_specs():
    """A causal window (rows of 2-3 blocks), a BigBird encoder whose global
    rows span several 512-slot tiles, and a block mask with an empty block
    row."""
    bm = np.tril(np.ones((8, 8), bool))
    bm[3, :] = False
    return {"window": patterns.sliding_window(512, 2, block=64, causal=True),
            "bigbird": patterns.bigbird(512, 1, 1, 2, block=32, seed=0),
            "empty_row": patterns.from_block_mask(bm, 256, block=32,
                                                  causal=True)}


def _attention_operands(spec, d, dtype, device):
    csr = patterns.build_mask(spec).csr.to(device)
    s = spec.seq
    q = (0.3 * torch.randn(s, d, device=device)).to(dtype)
    k = (0.3 * torch.randn(s, d, device=device)).to(dtype)
    v = torch.randn(s, d, device=device).to(dtype)
    bias = torch.from_numpy(interop.alibi_bias(csr, 0.05)).to(device)
    return csr, q, k, v, bias


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_kernels_match_plain(cuda, d, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, spec in _attention_specs().items():
        csr, q, k, v, bias = _attention_operands(spec, d, dtype, cuda)
        empty = torch.diff(csr.indptr) == 0
        for tile in (32, 100, 512):
            bal = formats.csr_to_balanced(csr, tile)
            slab = _stream_to_balanced(bias, bal)
            args = (bal.rows, bal.cols, q, k, slab)
            kw = dict(shape=csr.shape, scale=d ** -0.5)
            reset_launch_counts()
            rm, rs = attention.attn_stats_fused(*args, **kw)
            pm, ps = attention.attn_stats_plain(*args, **kw)
            assert (rm[empty] == -1e30).all() and (rs[empty] == 0).all(), name
            assert _rel(rm[~empty], pm[~empty]) < 1e-4, name
            assert _rel(rs, ps) < 1e-4, name
            y = attention.attn_chain_fused(*args, v, **kw)
            counts = launch_counts()
            assert (counts["attn_stats"], counts["attn_chain"]) == (2, 1), counts
            assert y.dtype == dtype and (y[empty] == 0).all(), name
            assert _rel(y, attention.attn_chain_plain(*args, v, **kw)) < tol, name
            assert _rel(attention.attn_unfused(*args, v, **kw), y) < tol, name
            # given K9's statistics: the same up to the atomics' order
            ys = attention.attn_chain_fused(*args, v, stats=(rm, rs), **kw)
            assert _rel(ys, y) < tol, name
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_attention_rejects_bad_operands(cuda):
    csr, q, k, v, bias = _attention_operands(_attention_specs()["window"], 64,
                                             torch.float32, cuda)
    bal = formats.csr_to_balanced(csr, 512)
    slab = _stream_to_balanced(bias, bal)
    kw = dict(shape=csr.shape, scale=0.125)
    reset_launch_counts()
    with pytest.raises(ValueError):          # a bias slab of another shape
        attention.attn_stats_fused(bal.rows, bal.cols, q, k, slab[:, 1:], **kw)
    with pytest.raises(ValueError):          # a bfloat16 bias
        attention.attn_chain_fused(bal.rows, bal.cols, q, k, slab.bfloat16(),
                                   v, **kw)
    with pytest.raises(ValueError):          # V of the wrong height
        attention.attn_chain_fused(bal.rows, bal.cols, q, k, slab, v[1:], **kw)
    assert sum(launch_counts().values()) == 0


@pytest.mark.gpu
def test_cuda_sparse_attention_main_path(cuda):
    import dataclasses
    import repro_torch
    spec = _attention_specs()["window"]
    csr, q, k, v, bias = _attention_operands(spec, 64, torch.float32, cuda)
    qh, kh, vh = (t.expand(2, 3, *t.shape).contiguous() for t in (q, k, v))
    cases = ((None, ("chain_stats", "chain")),
             (bias, ("attn_stats", "attn_chain")))
    for b, kernels in cases:
        reset_launch_counts()
        y = repro_torch.sparse_attention(spec, qh, kh, vh, bias=b, cache=False)
        counts = launch_counts()
        assert {kk: counts[kk] for kk in kernels} == dict.fromkeys(kernels, 6)
        want = repro_torch.sparse_attention(spec, q, k, v, bias=b,
                                            backend="torch", cache=False)
        assert y.shape == (2, 3, spec.seq, 64)
        assert _rel(y[1, 2], want) < 1e-4
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               attn_fuse_min_seq=spec.seq + 1)
    reset_launch_counts()
    yu = repro_torch.sparse_attention(spec, q, k, v, bias=bias,
                                      thresholds=shut, cache=False)
    counts = launch_counts()
    assert (counts["sddmm"], counts["attn_stats"], counts["vsr_spmm"],
            counts["attn_chain"]) == (1, 1, 1, 0), counts
    assert _rel(yu, y[0, 0]) < 1e-4          # y: the last case, with bias
    # an operand requiring grad: the card's backward of V alone against the
    # plain one
    from repro_torch.core.vjp import attn_bwd_plain
    vg = v.clone().requires_grad_()
    yg = repro_torch.sparse_attention(spec, q, k, vg, cache=False)
    assert yg.grad_fn is not None
    yg.sum().backward()
    rows, cols = formats.balanced_pattern(csr, 512)
    want = attn_bwd_plain(rows, cols, q, k, torch.zeros(rows.shape, device=cuda),
                          v, torch.ones_like(yg), csr.shape, 64 ** -0.5)
    assert _rel(vg.grad, want[3]) < 1e-4


def _design_patterns():
    """Patterns of the two designs' checks: a causal window ragged at seq
    1000 (partial diagonal blocks), BigBird at seq 2048 (its two global row
    blocks touch 32 blocks, over twice the mean, so their chunks merge
    atomically), a block mask with an empty block row."""
    bm = np.tril(np.ones((8, 8), bool))
    bm[3, :] = False
    return {"window": patterns.sliding_window(1000, 2, block=64, causal=True),
            "bigbird": patterns.bigbird(2048, 1, 2, 3, block=64, seed=0),
            "empty_row": patterns.from_block_mask(bm, 500, block=64,
                                                  causal=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["block", "slot"])
@pytest.mark.parametrize("n", [1, 64, 256, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_attention_designs_match_plain(cuda, d, dtype, n, design):
    """Each design of K9 and K10 against the plain versions, a bias of −inf
    at every 97th kept key: the output stays finite, empty rows exactly 0,
    and the per-design counter names the design that ran."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, spec in _design_patterns().items():
        csr = patterns.build_mask(spec).csr.to(cuda)
        bal = formats.csr_to_balanced(csr, 512)
        s = spec.seq
        q, k = ((0.5 * torch.randn(s, d, device=cuda)).to(dtype)
                for _ in range(2))
        v = torch.randn(s, n, device=cuda).to(dtype)
        v = v[:, 0].contiguous() if n == 1 else v
        bias = torch.from_numpy(interop.alibi_bias(csr, 0.05)).to(cuda)
        bias[1::97] = -float("inf")
        slab = _stream_to_balanced(bias, bal)
        args = (bal.rows, bal.cols, q, k, slab)
        kw = dict(shape=csr.shape, scale=d ** -0.5)
        blocks = attention.AttnBlocks()
        empty = torch.diff(csr.indptr) == 0
        reset_launch_counts()
        rm, rs = attention._launch_stats(design, *args, blocks=blocks, **kw)
        y = attention._launch_chain(design, *args, v, blocks=blocks, **kw)
        torch.cuda.synchronize()
        assert attention.DESIGN_LAUNCHES["attn_stats"][design] == 2, name
        assert attention.DESIGN_LAUNCHES["attn_chain"][design] == 1, name
        pm, ps = attention.attn_stats_plain(*args, **kw)
        live = pm > -1e29
        assert torch.equal(rm[~live], pm[~live]) and (rs[empty] == 0).all()
        assert _rel(rm[live], pm[live]) < 1e-4, name
        assert _rel(rs, ps) < 1e-4, name
        assert y.dtype == dtype and torch.isfinite(y).all(), name
        assert (y[empty] == 0).all(), name
        assert _rel(y, attention.attn_chain_plain(*args, v, **kw)) < tol, name


@pytest.mark.gpu
def test_cuda_attention_routes_by_pattern_fill(cuda):
    """A block-structured pattern takes the block design, a scattered graph
    the slot-tile design (no layout is built for it), and the facade's plan
    keeps one layout for all heads."""
    import repro_torch
    g = rmat(10, 8, seed=1, device=cuda)
    gbal = formats.csr_to_balanced(g, 512)
    a, b = (0.3 * torch.randn(g.shape[0], 64, device=cuda) for _ in range(2))
    x = torch.randn(g.shape[1], 64, device=cuda)
    gslab = 0.1 * torch.randn(gbal.rows.shape, device=cuda)
    blocks = attention.AttnBlocks()
    reset_launch_counts()
    y = attention.attn_chain_fused(gbal.rows, gbal.cols, a, b, gslab, x,
                                   shape=g.shape, scale=0.125, blocks=blocks)
    assert blocks(gbal.rows, gbal.cols, g.shape) is None
    assert attention.DESIGN_LAUNCHES == {
        "attn_stats": {"block": 0, "slot": 1},
        "attn_chain": {"block": 0, "slot": 1}}
    assert _rel(y, attention.attn_chain_plain(
        gbal.rows, gbal.cols, a, b, gslab, x, shape=g.shape,
        scale=0.125)) < 1e-4
    with pytest.raises(ValueError):
        attention._launch_stats("block", gbal.rows, gbal.cols, a, b, gslab,
                                shape=g.shape)
    spec = _design_patterns()["bigbird"]
    csr, q, k, v, bias = _attention_operands(spec, 64, torch.float32, cuda)
    qh, kh, vh = (t.expand(1, 3, *t.shape).contiguous() for t in (q, k, v))
    reset_launch_counts()
    y = repro_torch.sparse_attention(spec, qh, kh, vh, bias=bias, cache=False)
    assert attention.DESIGN_LAUNCHES == {
        "attn_stats": {"block": 3, "slot": 0},
        "attn_chain": {"block": 3, "slot": 0}}
    want = repro_torch.sparse_attention(spec, q, k, v, bias=bias,
                                        backend="torch", cache=False)
    assert _rel(y[0, 2], want) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 256])
def test_cuda_chain_block_design_matches_plain(cuda, d, dtype, n):
    """K7 and K8's softmax in the block design (no bias, ``scale = alpha``)
    against the plain versions, with computed and with given statistics; the
    BigBird pattern's global row blocks are split over CTAs.  The routed
    calls take the block design."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, spec in _design_patterns().items():
        csr = patterns.build_mask(spec).csr.to(cuda)
        bal = formats.csr_to_balanced(csr, 512)
        s = spec.seq
        a, b = ((0.5 * torch.randn(s, d, device=cuda)).to(dtype)
                for _ in range(2))
        x = torch.randn(s, n, device=cuda).to(dtype)
        x = x[:, 0].contiguous() if n == 1 else x
        args = (bal.rows, bal.cols, a, b)
        kw = dict(shape=csr.shape, alpha=0.7 * d ** -0.5)
        cache = attention.AttnBlocks()
        empty = torch.diff(csr.indptr) == 0
        reset_launch_counts()
        rm, rs = fused_chain.chain_stats_fused(*args, blocks=cache, **kw)
        y = fused_chain.chain_fused(*args, x, transform="softmax",
                                    blocks=cache, **kw)
        ys = fused_chain._launch_chain("block", *args, x, transform="softmax",
                                       stats=(rm, rs), blocks=cache, **kw)
        torch.cuda.synchronize()
        assert fused_chain.DESIGN_LAUNCHES == {
            "sddmm": {"seq": 0, "par": 0},
            "chain_stats": {"block": 2, "slot": 0},
            "chain": {"block": 2, "slot": 0}}, name
        pm, ps = fused_chain.chain_stats_plain(*args, **kw)
        live = pm > -1e29
        assert torch.equal(rm[~live], pm[~live]) and (rs[empty] == 0).all()
        assert _rel(rm[live], pm[live]) < 1e-4, name
        assert _rel(rs, ps) < 1e-4, name
        want = fused_chain.chain_plain(*args, x, transform="softmax", **kw)
        for got in (y, ys):
            assert got.dtype == dtype and got.shape == want.shape, name
            assert torch.isfinite(got).all() and (got[empty] == 0).all(), name
            assert _rel(got, want) < tol, name


@pytest.mark.gpu
def test_cuda_chain_routes_by_pattern_and_operands(cuda):
    """The chain's softmax on a band takes the block design; a scattered
    graph, identity and scale, X of another type and d > 256 take the
    slot-tile design; the facade's attention without a bias and the GAT
    chain show the same in ``DESIGN_LAUNCHES``."""
    import repro_torch
    spec = patterns.sliding_window(512, 2, block=64, causal=True)
    csr = patterns.build_mask(spec).csr.to(cuda)
    bal = formats.csr_to_balanced(csr, 512)
    g = rmat(10, 8, seed=1, device=cuda)
    gbal = formats.csr_to_balanced(g, 512)

    def route(pat, shape, d, transform="softmax", xdtype=torch.float32):
        a, b = (0.3 * torch.randn(shape[0], d, device=cuda) for _ in range(2))
        x = torch.randn(shape[1], 16, device=cuda).to(xdtype)
        reset_launch_counts()
        y = fused_chain.chain_fused(pat.rows, pat.cols, a, b, x, shape=shape,
                                    transform=transform, alpha=0.25)
        want = fused_chain.chain_plain(pat.rows, pat.cols, a, b, x,
                                       shape=shape, transform=transform,
                                       alpha=0.25)
        assert _rel(y, want) < (1e-4 if xdtype == torch.float32 else 2e-2)
        return {kk: [dd for dd, nn in vv.items() if nn]
                for kk, vv in fused_chain.DESIGN_LAUNCHES.items()
                if kk != "sddmm"}

    both = {"chain_stats": ["block"], "chain": ["block"]}
    slot = {"chain_stats": ["slot"], "chain": ["slot"]}
    assert route(bal, csr.shape, 64) == both
    assert route(gbal, g.shape, 64) == slot
    assert route(bal, csr.shape, 264) == slot
    assert route(bal, csr.shape, 64, xdtype=torch.bfloat16) == slot
    for transform in ("identity", "scale"):
        assert route(bal, csr.shape, 64, transform) == {"chain_stats": [],
                                                        "chain": ["slot"]}
    with pytest.raises(ValueError):
        fused_chain._launch_chain("block", bal.rows, bal.cols,
                                  *(torch.zeros(512, 64, device=cuda),) * 3,
                                  shape=csr.shape, transform="identity")
    q, k, v = (torch.randn(1, 2, 512, 64, device=cuda) for _ in range(3))
    reset_launch_counts()
    y = repro_torch.sparse_attention(spec, q, k, v, cache=False)
    assert fused_chain.DESIGN_LAUNCHES == {
        "sddmm": {"seq": 0, "par": 0},
        "chain_stats": {"block": 2, "slot": 0},
        "chain": {"block": 2, "slot": 0}}
    assert attention.DESIGN_LAUNCHES == {
        "attn_stats": {"block": 0, "slot": 0},
        "attn_chain": {"block": 0, "slot": 0}}
    want = repro_torch.sparse_attention(spec, q[0, 1], k[0, 1], v[0, 1],
                                        backend="torch", cache=False)
    assert _rel(y[0, 1], want) < 1e-4
    a, b = (0.3 * torch.randn(g.shape[0], 64, device=cuda) for _ in range(2))
    reset_launch_counts()
    repro_torch.sparse_chain(g, a, b, torch.randn(g.shape[1], 32, device=cuda),
                             alpha=0.125, cache=False)
    assert fused_chain.DESIGN_LAUNCHES == {
        "sddmm": {"seq": 0, "par": 0},
        "chain_stats": {"block": 0, "slot": 1},
        "chain": {"block": 0, "slot": 1}}


def _fault_operands(cuda, dtype, n):
    """The causal band of 4 blocks at d = 64 (rows 64-69 do not keep key 70,
    rows 70-127 do), Q, K, V from seed 0."""
    spec = patterns.sliding_window(256, 1, block=64, causal=True)
    csr = patterns.build_mask(spec).csr.to(cuda)
    bal = formats.csr_to_balanced(csr, 512)
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k = (torch.randn(256, 64, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    v = torch.randn(256, n, device=cuda, generator=gen).to(dtype)
    rows = torch.repeat_interleave(torch.arange(256, device=cuda),
                                   torch.diff(csr.indptr))
    keeps = torch.zeros(256, dtype=torch.bool, device=cuda)
    keeps[rows[csr.indices == 70]] = True
    return csr, bal, q, k, v, keeps


def _same_class(got, want, tol):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert not fin.any() or _rel(got[fin], want[fin]) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("value", [float("nan"), float("inf")])
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True], ids=["chain", "attention"])
def test_cuda_block_design_nonfinite_v_at_masked_keys(cuda, bias, dtype, n,
                                                      value):
    """A non-finite V row reaches only the rows that keep its key, in the
    block K8 (no bias) and K10 (zero bias): rows 64-69 stay finite and equal
    the plain version's, rows that keep key 70 are NaN or inf as there.  A
    NaN K row at the masked key changes none of rows 64-69."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    csr, bal, q, k, v, keeps = _fault_operands(cuda, dtype, n)
    v[70] = value
    cache = attention.AttnBlocks()
    slab = torch.zeros(bal.rows.shape, device=cuda)

    def run(design, kk, vv):
        if bias:
            return attention._launch_chain(design, bal.rows, bal.cols, q, kk,
                                           slab, vv, shape=csr.shape,
                                           scale=0.125, blocks=cache)
        return fused_chain._launch_chain(design, bal.rows, bal.cols, q, kk,
                                         vv, shape=csr.shape,
                                         transform="softmax", alpha=0.125,
                                         blocks=cache)

    if bias:
        want = attention.attn_chain_plain(bal.rows, bal.cols, q, k, slab, v,
                                          shape=csr.shape, scale=0.125)
    else:
        want = fused_chain.chain_plain(bal.rows, bal.cols, q, k, v,
                                       shape=csr.shape, transform="softmax",
                                       alpha=0.125)
    want2 = want if n > 1 else want[:, None]
    assert torch.isfinite(want2[64:70]).all()
    assert not torch.isfinite(want2[keeps]).any()
    y = run("block", k, v)
    torch.cuda.synchronize()
    y2 = y if n > 1 else y[:, None]
    assert torch.isfinite(y2[64:70]).all() and torch.isfinite(y2[~keeps]).all()
    _same_class(y, want, tol)
    _same_class(y, run("slot", k, v), tol)
    k_nan = k.clone()
    k_nan[70] = float("nan")
    v[70] = 0.0
    y_fin, y_k = run("block", k, v), run("block", k_nan, v)
    torch.cuda.synchronize()
    yk2 = y_k if n > 1 else y_k[:, None]
    assert torch.isfinite(yk2[64:70]).all()
    assert torch.equal(y_k[64:70], y_fin[64:70])


@pytest.mark.gpu
def test_cuda_block_design_after_a_nonfinite_call(cuda):
    """A block K10 call on all-NaN V, then a call at seq < 64 (one ragged
    block, whose rows past K must read as zeros) with finite V: the second
    result is finite and equals the plain version.  Shared memory need not
    keep the first call's NaNs, so a pass proves less than a fail would."""
    spec = patterns.bigbird(2048, 1, 2, 3, block=64, seed=0)
    csr = patterns.build_mask(spec).csr.to(cuda)
    bal = formats.csr_to_balanced(csr, 512)
    q, k = (torch.randn(2048, 64, device=cuda) for _ in range(2))
    v = torch.full((2048, 64), float("nan"), device=cuda)
    slab = torch.zeros(bal.rows.shape, device=cuda)
    y = attention._launch_chain("block", bal.rows, bal.cols, q, k, slab, v,
                                shape=csr.shape, scale=0.125)
    small = patterns.build_mask(patterns.dense_attention(40, block=8)).csr
    small = small.to(cuda)
    sbal = formats.csr_to_balanced(small, 512)
    q, k, v = (torch.randn(40, 64, device=cuda) for _ in range(3))
    sslab = torch.zeros(sbal.rows.shape, device=cuda)
    ys = attention._launch_chain("block", sbal.rows, sbal.cols, q, k, sslab,
                                 v, shape=small.shape, scale=0.125)
    torch.cuda.synchronize()
    assert torch.isnan(y).all()
    assert torch.isfinite(ys).all()
    assert _rel(ys, attention.attn_chain_plain(
        sbal.rows, sbal.cols, q, k, sslab, v, shape=small.shape,
        scale=0.125)) < 1e-4


def _block_matrices(device):
    """Ragged M and K (neither a multiple of any block shape), an empty
    block row (rows 16-47), and a matrix without nonzeros."""
    rng = np.random.default_rng(1)
    a = ((rng.random((203, 333)) < 0.05) * rng.standard_normal((203, 333))
         ).astype(np.float32)
    a[16:48] = 0.0
    return {"ragged": formats.csr_from_dense(a, device=device),
            "nnz0": formats.csr_from_dense(np.zeros((70, 90), np.float32),
                                           device=device)}


@pytest.mark.gpu
@pytest.mark.parametrize("block", [(8, 16), (8, 128), (16, 64), (64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bsr_matches_plain(cuda, block, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, csr in _block_matrices(cuda).items():
        csr = formats.CSR(csr.indptr, csr.indices, csr.data.to(dtype), csr.shape)
        b = formats.csr_to_bsr(csr, *block)
        for n in (1, 3, 32, 128, 200):
            x = torch.randn(csr.shape[1], n, device=cuda).to(dtype)
            x = x[:, 0].contiguous() if n == 1 else x
            y = bsr.spmm_bsr(b, x)
            want = bsr.spmm_bsr_plain(b, x)
            assert y.dtype == dtype and y.shape == want.shape, (name, n)
            if name == "nnz0":
                assert b.nblocks == 0 and (y == 0).all()
            else:
                assert (y[16:48] == 0).all(), (name, n)
                assert _rel(y, want) < tol, (name, block, n)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_bsr_facade_and_rejects(cuda):
    import repro_torch
    csr = _block_matrices(cuda)["ragged"]
    x = torch.randn(csr.shape[1], 16, device=cuda)
    A = repro_torch.sparse(csr, backend="bsr", bsr_block=(16, 64), cache=False)
    want = A.matmul(x, backend="torch")
    for impl in (None, "rs_sr", "nb_pr"):
        reset_launch_counts()
        y = A.matmul(x, impl=impl)
        assert launch_counts()["bsr_spmm"] == 1
        assert sum(launch_counts().values()) == 1
        assert _rel(y, want) < 1e-4
    new = torch.randn(csr.nnz, device=cuda)
    reset_launch_counts()
    y2 = A.with_values(new) @ x
    assert launch_counts()["bsr_spmm"] == 1
    assert _rel(y2, A.with_values(new).matmul(x, backend="torch")) < 1e-4
    b = A.plan.substrate("bsr")
    # blocks over the registers' 64 rows run the fma design in row chunks
    # (Aᵀ's blocks in the backward of an (8, 128) weight)
    tall = formats.csr_to_bsr(csr, 128, 8)
    reset_launch_counts()
    assert _rel(bsr.spmm_bsr(tall, x), bsr.spmm_bsr_plain(tall, x)) < 1e-4
    assert bsr.DESIGN_LAUNCHES["bsr_spmm"]["fma"] == 1
    reset_launch_counts()
    with pytest.raises(ValueError):          # x of the wrong height
        bsr.spmm_bsr(b, x[1:])
    with pytest.raises(ValueError):          # no float64 kernel
        bsr.spmm_bsr(b, x.double())
    assert launch_counts()["bsr_spmm"] == 0


def _padded_x(cuda, k, n, dtype):
    """X (k, n) as the head of a larger buffer whose rows past k are NaN: a
    kernel that read X's rows past K (the ragged last block column) instead
    of zero-filling them would carry NaN into its sums."""
    buf = torch.full((k + 64, n), float("nan"), device=cuda, dtype=dtype)
    buf[:k] = torch.randn(k, n, device=cuda).to(dtype)
    return buf[:k]


@pytest.mark.gpu
@pytest.mark.parametrize("block", [(8, 16), (8, 128), (16, 64), (64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 32, 128, 200])
def test_cuda_bsr_tc_design_matches_plain(cuda, block, dtype, n):
    """The tensor-core design, forced and routed, at every column tile: N
    tiles that are ragged (200), ragged M and K, empty block rows, nnz = 0."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, csr in _block_matrices(cuda).items():
        csr = formats.CSR(csr.indptr, csr.indices, csr.data.to(dtype), csr.shape)
        b = formats.csr_to_bsr(csr, *block)
        layout = bsr.build_groups(b)
        x = _padded_x(cuda, csr.shape[1], n, dtype)
        want = bsr.spmm_bsr_plain(b, x)
        for cols in (32, 64, 128):
            y = bsr._launch("tc", b, x, layout, ncols=cols)
            assert y.shape == want.shape and torch.isfinite(y).all(), (name, cols)
            if name == "nnz0":
                assert b.nblocks == 0 and (y == 0).all()
            else:
                assert (y[16:48] == 0).all(), (name, cols)
                assert _rel(y, want) < tol, (name, cols)
        reset_launch_counts()
        y = bsr.spmm_bsr(b, x, layout=layout)
        assert bsr.DESIGN_LAUNCHES["bsr_spmm"] == {
            "tc": int(b.shape[0] > 0), "fma": 0}
        assert y.dtype == dtype and _rel(y, want) < tol
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_bsr_routes_by_rule(cuda):
    """``DESIGN_LAUNCHES`` shows the design each call took: the tensor-core
    design from ``TC_MIN_N`` on for bm a multiple of 8, bk of the MMA's depth
    and one operand type; the fma design otherwise."""
    csr = _block_matrices(cuda)["ragged"]
    f32 = formats.csr_to_bsr(csr, 8, 16)
    b16 = formats.BSR(f32.indptr, f32.indices, f32.blocks.bfloat16(),
                      f32.shape, f32.block_shape)
    b12 = formats.csr_to_bsr(csr, 12, 16)
    buf = torch.empty(f32.blocks.numel() + 1, device=cuda)
    buf[1:] = f32.blocks.reshape(-1)             # blocks 4 bytes past 16
    unaligned = formats.BSR(f32.indptr, f32.indices,
                            buf[1:].view(f32.blocks.shape), f32.shape,
                            f32.block_shape)
    bf16_k8 = formats.csr_to_bsr(formats.CSR(csr.indptr, csr.indices,
                                             csr.data.bfloat16(), csr.shape),
                                 8, 8)
    cases = [(f32, torch.float32, 1, "fma"), (f32, torch.float32, 4, "fma"),
             (f32, torch.float32, bsr.TC_MIN_N - 1, "fma"),
             (f32, torch.float32, bsr.TC_MIN_N, "tc"),
             (f32, torch.float32, 128, "tc"), (b16, torch.bfloat16, 32, "tc"),
             (b16, torch.float32, 32, "fma"), (f32, torch.bfloat16, 32, "fma"),
             (b12, torch.float32, 32, "fma"), (bf16_k8, torch.bfloat16, 32, "fma"),
             (unaligned, torch.float32, 32, "fma")]
    for b, xdtype, n, design in cases:
        x = torch.randn(csr.shape[1], n, device=cuda).to(xdtype)
        x = x[:, 0].contiguous() if n == 1 else x
        reset_launch_counts()
        y = bsr.spmm_bsr(b, x)
        assert bsr.DESIGN_LAUNCHES["bsr_spmm"] == {
            dd: int(dd == design) for dd in ("tc", "fma")}, (b.block_shape, n)
        assert launch_counts()["bsr_spmm"] == 1
        tol = 1e-4 if (b.blocks.dtype, xdtype) == (torch.float32,) * 2 else 2e-2
        assert _rel(y, bsr.spmm_bsr_plain(b, x)) < tol
    with pytest.raises(ValueError):          # forced onto a design that refuses
        bsr._launch("tc", b12, torch.randn(csr.shape[1], 32, device=cuda),
                    bsr.build_groups(b12))
    with pytest.raises(ValueError):          # a layout of another pattern
        bsr._launch("tc", f32, torch.randn(csr.shape[1], 32, device=cuda),
                    bsr.build_groups(formats.csr_to_bsr(
                        _block_matrices(cuda)["nnz0"], 8, 16)))


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["tc", "fma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 128])
def test_cuda_bsr_nonfinite_x_stays_in_its_rows(cuda, design, dtype, n):
    """NaN and inf in X's block column 0: block rows with no block there
    stay finite (the sum of their own blocks), rows that hold one give what
    the plain version gives, inf and NaN alike."""
    rng = np.random.default_rng(4)
    a = (rng.random((96, 64)) < 0.5) * rng.standard_normal((96, 64))
    a[:, :16] *= (np.arange(96) // 8 % 2 == 0)[:, None]    # odd block rows: none
    w = formats.csr_to_bsr(formats.csr_from_dense(a.astype(np.float32),
                                                  device=cuda), 8, 16)
    w = formats.BSR(w.indptr, w.indices, w.blocks.to(dtype), w.shape,
                    w.block_shape)
    x = torch.randn(64, n, device=cuda).to(dtype)
    x[3, 0], x[5, 1], x[7, 2] = float("nan"), float("inf"), float("-inf")
    y = bsr._launch(design, w, x, bsr.build_groups(w))
    want = bsr.spmm_bsr_plain(w, x).float()
    odd = (torch.arange(96, device=cuda) // 8) % 2 == 1
    assert torch.isfinite(y[odd]).all()
    assert torch.equal(y.isnan(), want.isnan())
    assert torch.equal(y.isinf(), want.isinf())
    fin = torch.isfinite(want)
    assert torch.equal(y[~fin & ~want.isnan()], want[~fin & ~want.isnan()])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel(torch.where(fin, y, 0), torch.where(fin, want, 0)) < tol


def _poison(*shapes, device):
    """Hand the caching allocator blocks of these shapes filled with NaN,
    so that the next ``torch.empty`` of each shape is likely to get one
    back: an entry a kernel leaves unwritten then shows as NaN."""
    blocks = [torch.full(s, float("nan"), device=device) for s in shapes]
    del blocks


def _hold_spill(bal, x, base, win, tol, label):
    """K4 (x of shape (K, N)) or K5 (x of shape (K,)), the combine and the
    spill call against their plain versions; every partial and every
    output entry written (``_poison``)."""
    shapes = ((bal.n_tiles, win) + tuple(x.shape[1:]),
              (bal.shape[0],) + tuple(x.shape[1:]))
    _poison(shapes[0], device=x.device)
    if x.ndim == 1:
        part = spmv.spmv_vsr_partials(bal, x, base, win)
        want = vsr.spill_partials_plain(bal, x[:, None], base, win)[..., 0]
        call, plain = spmv.spmv_vsr, spmv.spmv_vsr_spill_plain
    else:
        part = vsr.spmm_vsr_partials(bal, x, base, win)
        want = vsr.spill_partials_plain(bal, x, base, win)
        call, plain = vsr.spmm_vsr, vsr.spmm_vsr_spill_plain
    assert part.shape == want.shape and torch.isfinite(part).all(), label
    assert _rel(part, want) < tol, label
    _poison(shapes[1], device=x.device)
    y = vsr.spill_combine(part, base, bal.shape[0])
    want_y = vsr.spill_combine_plain(part, base, bal.shape[0])
    assert torch.isfinite(y).all() and _rel(y, want_y) < 1e-4, label
    del part, want, y
    _poison(*shapes, device=x.device)
    y = call(bal, x, row_base=base, win=win)
    want_y = plain(bal, x, row_base=base, win=win)
    assert y.dtype == x.dtype and y.shape == want_y.shape, label
    assert torch.isfinite(y).all() and _rel(y, want_y) < tol, label


def _unaligned(x):
    """The same values one element past an aligned start (no 16-byte
    loads of X rows)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 32, 128, 200])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_cuda_spill_kernels_match_plain(cuda, n, xdtype):
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, csr in _graphs(cuda).items():
        x = torch.randn(csr.shape[1], n, device=cuda).to(xdtype)
        for tile in (32, 100, 512, 4096):
            bal = formats.csr_to_balanced(csr, tile)
            base, win = vsr.SpillWindows()(bal)
            _hold_spill(bal, x, base, win, tol, (name, tile))
            _hold_spill(bal, x[:, 0].contiguous(), base, win, tol, (name, tile, 1))
            if tile == 100:
                _hold_spill(bal, _unaligned(x), base, win, tol, (name, "unaligned"))
                _hold_spill(bal, _unaligned(x[:, 0].contiguous()), base, win,
                            tol, (name, "unaligned", 1))
    torch.cuda.synchronize()


def _narrow_cases(device):
    """(label, bal, win) with a window narrower than a tile's span, so that
    runs of several rows clamp onto the window's last row: the 12×6 matrix
    of fault 3.4 (rows 0-7, one tile of 8, win 2), a random matrix of ~2
    nonzeros a row at tile 32 and win 8, and the uniform R-MAT graph at
    tile 512 and win 8."""
    a = np.zeros((12, 6), np.float32)
    for i in range(8):
        a[i, i % 6] = 6.0 if i == 7 else 1.0
    rng = np.random.default_rng(34)
    b = ((rng.random((200, 60)) < 0.035) * rng.standard_normal((200, 60))
         ).astype(np.float32)
    return (("fault_34", formats.csr_to_balanced(
                formats.csr_from_dense(a, device=device), 8), 2),
            ("rand_t32", formats.csr_to_balanced(
                formats.csr_from_dense(b, device=device), 32), 8),
            ("uniform_t512", formats.csr_to_balanced(
                _graphs(device)["uniform"], 512), 8))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4, 32, 128])
def test_cuda_spill_narrow_window(cuda, n):
    """Fault 3.4: with ``win`` below a tile's span, the runs clamped onto
    window row ``win - 1`` add there (K5 stored them over each other)."""
    for label, bal, win in _narrow_cases(cuda):
        base, span_win = vsr.SpillWindows()(bal)
        assert win < span_win, label
        x = torch.randn(bal.shape[1], n, device=cuda)
        if label == "fault_34":
            x = torch.arange(6.0, device=cuda)[:, None].repeat(1, n)
        _hold_spill(bal, x[:, 0].contiguous() if n == 1 else x, base, win,
                    1e-4, label)
        if label == "fault_34" and n == 1:
            y = spmv.spmv_vsr(bal, x[:, 0].contiguous(), row_base=base, win=win)
            assert y[1] == 21.0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_spill_nonfinite_x_stays_in_its_rows(cuda, n, dtype):
    """A NaN or inf row of X reaches only the output rows that gather it
    (the reference's "xla" semantics; its Pallas K4 spreads a NaN over the
    tile's window)."""
    csr = _graphs(cuda)["uniform"]
    bal = formats.csr_to_balanced(csr, 512)
    base, win = vsr.SpillWindows()(bal)
    x = torch.randn(csr.shape[1], n, device=cuda).to(dtype)
    x[3, 0], x[7] = float("nan"), float("inf")
    x = x[:, 0].contiguous() if n == 1 else x
    call = spmv.spmv_vsr if n == 1 else vsr.spmm_vsr
    plain = spmv.spmv_vsr_spill_plain if n == 1 else vsr.spmm_vsr_spill_plain
    y = call(bal, x, row_base=base, win=win)
    want = plain(bal, x, row_base=base, win=win)
    fin = torch.isfinite(want)
    assert 0 < int((~fin).reshape(fin.shape[0], -1).any(1).sum()) < 64
    assert torch.equal(y.isnan(), want.isnan())
    assert torch.equal(y[~fin & ~want.isnan()], want[~fin & ~want.isnan()])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel(torch.where(fin, y, 0), torch.where(fin, want, 0)) < tol


def _pad_tile(bal):
    """``bal`` with an all-padding tile appended (rows M, cols 0, vals 0)."""
    m = bal.shape[0]
    return formats.BalancedCOO(
        torch.cat([bal.rows, torch.full_like(bal.rows[:1], m)]),
        torch.cat([bal.cols, torch.zeros_like(bal.cols[:1])]),
        torch.cat([bal.vals, torch.zeros_like(bal.vals[:1])]), bal.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4, 32, 128])
def test_cuda_spill_windows_of_every_kind(cuda, n):
    """A window near ``max_win`` (tiles of 512 spanning 4,089 rows: rows
    with one nonzero every 8th row, win 4,096), a tile spanning ~1,000
    rows, one row of 60 nonzeros over eight tiles of 8 (the combine adds
    its windows), and an all-padding tile (row_base M, its window 0)."""
    rng = np.random.default_rng(n)
    sparse_rows = np.zeros((40000, 64), np.float32)
    sparse_rows[::8, 5] = rng.standard_normal(5000)
    long_row = ((rng.random((40, 64)) < 0.1) * rng.standard_normal((40, 64))
                ).astype(np.float32)
    long_row[20, 2:62] = rng.standard_normal(60)
    cases = (("win_4096", formats.csr_from_dense(sparse_rows, device=cuda), 512),
             ("span_1000", formats.csr_from_dense(sparse_rows[:8000], device=cuda), 125),
             ("long_row", formats.csr_from_dense(long_row, device=cuda), 8))
    for label, csr, tile in cases:
        for bal in (formats.csr_to_balanced(csr, tile),
                    _pad_tile(formats.csr_to_balanced(csr, tile))):
            base, win = vsr.SpillWindows(4096)(bal)
            x = torch.randn(csr.shape[1], n, device=cuda)
            _hold_spill(bal, x[:, 0].contiguous() if n == 1 else x, base, win,
                        1e-4, label)
        assert int(base[-1]) == csr.shape[0]
        if label == "win_4096":
            assert win == 4096
        if label == "long_row":
            covering = (base <= 20) & (base + win > 20)
            assert int(covering.sum()) >= 5
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_spill_rejects_unsorted_row_base(cuda):
    """The combine needs ``row_base`` non-decreasing; a caller's that is
    not raises before anything is launched."""
    bal = formats.csr_to_balanced(_graphs(cuda)["uniform"], 32)
    base, win = vsr.SpillWindows()(bal)
    bad = base.flip(0).contiguous()
    x = torch.randn(bal.shape[1], 8, device=cuda)
    reset_launch_counts()
    for call in (lambda: vsr.spmm_vsr(bal, x, row_base=bad, win=win),
                 lambda: spmv.spmv_vsr(bal, x[:, 0].contiguous(), row_base=bad,
                                       win=win),
                 lambda: vsr.spmm_as_n_spmv_hopper(bal, x, row_base=bad, win=win),
                 lambda: vsr.spill_combine(
                     torch.zeros(bal.n_tiles, win, 8, device=cuda), bad,
                     bal.shape[0])):
        with pytest.raises(ValueError, match="non-decreasing"):
            call()
    assert sum(launch_counts().values()) == 0


@pytest.mark.gpu
def test_cuda_spill_path_and_max_win(cuda):
    import dataclasses
    import repro_torch
    for name, csr in _graphs(cuda).items():
        A = repro_torch.sparse(csr, cache=False)
        opts = A.plan.kernel_opts(A.plan.entry("nb_pr"))
        opts["spill"] = True
        for n, kernel in ((1, "vsr_spmv_spill"), (4, "vsr_spmm_spill"),
                          (64, "vsr_spmm_spill")):
            x = torch.randn(csr.shape[1], n, device=cuda)
            x = x[:, 0].contiguous() if n == 1 else x
            reset_launch_counts()
            y = A.matmul(x, impl="nb_pr")
            assert launch_counts()[kernel] == 1
            assert launch_counts()["spill_combine"] == 1
            assert sum(launch_counts().values()) == 2
            assert _rel(y, A.matmul(x, impl="nb_pr", backend="torch")) < 1e-4
        reset_launch_counts()
        y4 = vsr.spmm_as_n_spmv_hopper(A.plan.substrate("balanced"),
                                       torch.randn(csr.shape[1], 4, device=cuda))
        assert launch_counts()["vsr_spmv"] == 4 and y4.shape == (csr.shape[0], 4)
    # an empty band of rows inside one tile: its window is past max_win
    a = np.zeros((600, 40), np.float32)
    a[0, 3], a[500, 7], a[599, 1] = 1.0, 2.0, 3.0
    th = dataclasses.replace(repro_torch.SelectorThresholds(), max_win=64)
    A = repro_torch.sparse(formats.csr_from_dense(a, device=cuda),
                           thresholds=th, cache=False)
    A.plan.kernel_opts(A.plan.entry("nb_pr"))["spill"] = True
    reset_launch_counts()
    with pytest.raises(ValueError, match="spans 600 rows"):
        A.matmul(torch.randn(40, 8, device=cuda), impl="nb_pr")
    assert sum(launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# K3: the sr and pr designs of the row-split SpMM
# ---------------------------------------------------------------------------

CSC_NS = [1, 3, 4, 5, 8, 20, 32, 127, 128, 200]


def _csc_kinds(device, vdtype=torch.float32):
    """Rows of every kind: empty, one entry at column 0, one entry away
    from it, two rows as wide as the matrix (the ELL's full width), eight
    entries without column 0, random rows."""
    rng = np.random.default_rng(18)
    a = (rng.random((70, 64)) < 0.15) * rng.standard_normal((70, 64))
    a[[0, 1, 2, 5, 40]] = 0.0
    a[1, 0], a[2, 5] = 1.5, -2.0
    a[3] = rng.standard_normal(64)
    a[17] = rng.standard_normal(64)
    a[5, 9:17] = rng.standard_normal(8)
    csr = formats.csr_from_dense(a.astype(np.float32), device=device)
    return formats.CSR(csr.indptr, csr.indices, csr.data.to(vdtype), csr.shape)


def _csc_ells(device, vdtype=torch.float32):
    """(name, ELL) pairs: the test graphs and the row kinds, at their full
    width and cut to 3 slots (lens clipped)."""
    mats = dict(_graphs(device), kinds=_csc_kinds(device))
    for name, csr in mats.items():
        csr = formats.CSR(csr.indptr, csr.indices, csr.data.to(vdtype), csr.shape)
        yield name, formats.csr_to_ell(csr)
        yield f"{name}_w3", formats.csr_to_ell(csr, width=3)


def _csc_x(k, n, xdtype, device):
    x = torch.randn(k, n, device=device).to(xdtype)
    return x[:, 0].contiguous() if n == 1 else x


def _same_nonfinite(got, want, tol):
    got, want = got.float(), want.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert not fin.any() or _rel(got[fin], want[fin]) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["sr", "pr"])
@pytest.mark.parametrize("n", CSC_NS)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
def test_cuda_csc_designs_match_plain(cuda, design, n, xdtype, vdtype):
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, ell in _csc_ells(cuda, vdtype):
        x = _csc_x(ell.shape[1], n, xdtype, cuda)
        y = csc.spmm_csc(ell, x, design)
        want = csc.spmm_csc_plain(ell, x)
        assert y.shape == want.shape and y.dtype == xdtype, name
        assert _rel(y, want) < tol, (name, design, n)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["sr", "pr"])
@pytest.mark.parametrize("n", [4, 32, 128])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_cuda_csc_unaligned_x(cuda, design, n, xdtype):
    """X one element past a 16-byte boundary: the narrower path, no read
    past a row."""
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, ell in _csc_ells(cuda):
        k = ell.shape[1]
        buf = torch.randn(k * n + 1, device=cuda).to(xdtype)
        x = buf[1:].view(k, n)
        assert x.data_ptr() % 16 != 0
        y = csc.spmm_csc(ell, x, design)
        assert _rel(y, csc.spmm_csc_plain(ell, x.clone())) < tol, (name, design)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["sr", "pr"])
@pytest.mark.parametrize("n", [1, 4, 5, 32, 128])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_cuda_csc_nonfinite_x(cuda, design, n, xdtype):
    """inf and NaN in X's row 0 (which every padded row sees through its
    padding slots) and elsewhere: the plain version's pattern exactly."""
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, ell in _csc_ells(cuda):
        k = ell.shape[1]
        x = torch.randn(k, n, device=cuda)
        x[0, 0] = float("nan")
        if n > 1:
            x[0, 1] = float("inf")
        if n > 2:
            x[0, 2] = -float("inf")
        x[7, n - 1] = float("inf")
        x[9, 0] = float("nan")
        x = x.to(xdtype)
        x = x[:, 0].contiguous() if n == 1 else x
        _same_nonfinite(csc.spmm_csc(ell, x, design),
                        csc.spmm_csc_plain(ell, x), tol)
    # the 3x4 case: the row as wide as the ELL gives (nan, inf), the padded
    # rows NaN
    a = np.array([[1, 2, 0, 0], [0, 0, 3, 0], [0, 0, 0, 0]], np.float32)
    ell = formats.csr_to_ell(formats.csr_from_dense(a, device=cuda))
    x = torch.ones(4, 2, device=cuda)
    x[0] = torch.tensor([float("nan"), float("inf")])
    y = csc.spmm_csc(ell, x.to(xdtype), design).float()
    assert torch.isnan(y[0, 0]) and torch.isposinf(y[0, 1])
    assert torch.isnan(y[1:]).all()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["sr", "pr"])
def test_cuda_csc_empty_rows_are_zero(cuda, design):
    for name, ell in _csc_ells(cuda):
        empty = ell.lens == 0
        for n in (1, 4, 32, 128):
            y = csc.spmm_csc(ell, _csc_x(ell.shape[1], n, torch.float32, cuda),
                             design)
            assert (y[empty] == 0).all(), (name, n)
    ell = formats.csr_to_ell(formats.csr_from_dense(np.zeros((9, 6), np.float32),
                                                    device=cuda))
    assert (csc.spmm_csc(ell, torch.randn(6, 8, device=cuda), design) == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [32, 128])
def test_cuda_csc_sr_column_slabs(cuda, lanes, n):
    """The sr design with fewer lanes than N needs: narrower column slabs,
    the slab the grid's slow dimension."""
    for name, ell in _csc_ells(cuda):
        x = torch.randn(ell.shape[1], n, device=cuda)
        y = csc._launch("sr", ell, csc._check(ell, x), lanes=lanes)
        assert _rel(y, csc.spmm_csc_plain(ell, x)) < 1e-4, (name, lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("group", [8, 16, 32])
@pytest.mark.parametrize("n", [1, 3, 4, 9])
def test_cuda_csc_pr_groups(cuda, group, n):
    for name, ell in _csc_ells(cuda):
        x = _csc_x(ell.shape[1], n, torch.float32, cuda)
        y = csc.spmm_csc(ell, x, "pr", group=group)
        assert _rel(y, csc.spmm_csc_plain(ell, x)) < 1e-4, (name, group)


@pytest.mark.gpu
def test_cuda_csc_design_launches(cuda):
    import repro_torch
    csr = _graphs(cuda)["uniform"]
    ell = formats.csr_to_ell(csr)
    for n, design in ((1, "pr"), (4, "pr"), (5, "sr"), (128, "sr")):
        reset_launch_counts()
        csc.spmm_csc(ell, _csc_x(csr.shape[1], n, torch.float32, cuda))
        assert csc.DESIGN_LAUNCHES["csc_spmm"] == {"sr": int(design == "sr"),
                                                   "pr": int(design == "pr")}
        assert launch_counts()["csc_spmm"] == 1
    A = repro_torch.sparse(csr, cache=False)
    assert A.plan.kernel_opts(A.plan.entry("rs_pr"))["group"] == csc.pr_group(ell)
    reset_launch_counts()
    for logical in ("rs_sr", "rs_pr", "rs_pr"):
        for n in (1, 32):
            y = A.matmul(_csc_x(csr.shape[1], n, torch.float32, cuda),
                         impl=logical)
            assert y.shape[0] == csr.shape[0]
    assert csc.DESIGN_LAUNCHES["csc_spmm"] == {"sr": 2, "pr": 4}
    assert launch_counts()["csc_spmm"] == 6
    x = torch.randn(csr.shape[1], 8, device=cuda)
    with pytest.raises(ValueError):          # lens of the wrong type
        csc.spmm_csc(dataclasses.replace(ell, lens=ell.lens.long()), x)
    with pytest.raises(ValueError):
        csc.spmm_csc(ell, x, "tc")
    with pytest.raises(ValueError):          # lens on the host
        csc.spmm_csc(dataclasses.replace(ell, lens=ell.lens.cpu()), x)
    assert launch_counts()["csc_spmm"] == 6
    with pytest.raises(RuntimeError):        # a group the kernel refuses
        csc.spmm_csc(ell, x, "pr", group=12)


# ---------------------------------------------------------------------------
# K1 in its sr and pr designs, and K2
# ---------------------------------------------------------------------------

NB_NS = [1, 2, 3, 4, 5, 8, 31, 32, 33, 64, 128, 200]
NB_TILES = (1, 7, 32, 100, 512, 4096)


def _nb_mats(device, vdtype=torch.float32):
    """(name, CSR) of the K1/K2 checks: the test graphs, a hub row of 900
    nonzeros (it spans many tiles at every tile size but 4096) between
    short rows and empty ones, and a band of rows of ~30 nonzeros (runs
    that cross the sr design's group ranges)."""
    rng = np.random.default_rng(21)
    hub = ((rng.random((400, 1000)) < 0.004) * rng.standard_normal((400, 1000))
           ).astype(np.float32)
    hub[[3, 50, 51, 52, 399]] = 0.0
    hub[77, 50:950] = rng.standard_normal(900)
    band = ((rng.random((300, 200)) < 0.15) * rng.standard_normal((300, 200))
            ).astype(np.float32)
    band[100:140] = 0.0
    mats = dict(_graphs(device),
                hub=formats.csr_from_dense(hub, device=device),
                band=formats.csr_from_dense(band, device=device))
    for name, csr in mats.items():
        yield name, formats.CSR(csr.indptr, csr.indices, csr.data.to(vdtype),
                                csr.shape)


def _nb_x(k, n, xdtype, device, two_d=True):
    x = torch.randn(k, n, device=device).to(xdtype)
    return x if two_d or n > 1 else x[:, 0].contiguous()


def _hold_nb(run, plain, bal, x, empty, tol, label):
    """A K1/K2 call against its plain version: the type, the shape, the
    error, and the empty rows exactly 0."""
    y = run(bal, x)
    want = plain(bal, x)
    assert y.dtype == x.dtype and y.shape == want.shape, label
    assert _rel(y, want) < tol, label
    assert (y[empty] == 0).all(), label


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["sr", "pr"])
@pytest.mark.parametrize("n", NB_NS)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
def test_cuda_nb_designs_match_plain(cuda, design, n, xdtype, vdtype):
    """Each design of K1, forced, against the plain version at every tile
    (tiles of 1 and 7 slots take scalar slot loads), with an all-padding
    tile appended, and on an X whose data pointer is not 16-byte aligned;
    N = 1 as a (K, 1) X."""
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    run = lambda bal, x: vsr.spmm_vsr_fused(bal, x, design)
    for name, csr in _nb_mats(cuda, vdtype):
        empty = torch.diff(csr.indptr) == 0
        x = _nb_x(csr.shape[1], n, xdtype, cuda)
        for tile in NB_TILES:
            bal = formats.csr_to_balanced(csr, tile)
            _hold_nb(run, vsr.spmm_vsr_plain, bal, x, empty, tol, (name, tile))
        bal = _pad_tile(formats.csr_to_balanced(csr, 100))
        _hold_nb(run, vsr.spmm_vsr_plain, bal, x, empty, tol, (name, "padded"))
        ux = _unaligned(x)
        assert ux.data_ptr() % 16 != 0
        _hold_nb(run, vsr.spmm_vsr_plain, formats.csr_to_balanced(csr, 512),
                 ux, empty, tol, (name, "unaligned"))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.bfloat16])
def test_cuda_k2_matches_plain(cuda, xdtype, vdtype):
    """K2 on the same patterns, tiles, padded tile and unaligned x; the
    pr design's (K, 1) X runs K2's kernel and gives K2's result."""
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, csr in _nb_mats(cuda, vdtype):
        empty = torch.diff(csr.indptr) == 0
        x = _nb_x(csr.shape[1], 1, xdtype, cuda, two_d=False)
        bals = [formats.csr_to_balanced(csr, t) for t in NB_TILES]
        bals.append(_pad_tile(formats.csr_to_balanced(csr, 100)))
        for bal in bals:
            _hold_nb(spmv.spmv_vsr_fused, spmv.spmv_vsr_plain, bal, x, empty,
                     tol, (name, bal.tile))
        _hold_nb(spmv.spmv_vsr_fused, spmv.spmv_vsr_plain, bals[4],
                 _unaligned(x), empty, tol, (name, "unaligned"))
        y2 = vsr.spmm_vsr_fused(bals[4], x[:, None], "pr")
        assert _rel(y2[:, 0], spmv.spmv_vsr_fused(bals[4], x)) < tol, name
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("n", [4, 32, 128])
def test_cuda_nb_sr_lanes(cuda, lanes, n):
    """The sr design with every group width: narrow groups walk short
    ranges, so most runs cross them (merged in shared memory) and a CTA
    takes several tiles; with fewer lanes than N needs the column blocks
    are the grid's slow dimension."""
    for name, csr in _nb_mats(cuda):
        x = torch.randn(csr.shape[1], n, device=cuda)
        for tile in (32, 512, 4096):
            bal = formats.csr_to_balanced(csr, tile)
            y = vsr._launch("sr", bal, vsr._check(bal, x), lanes=lanes)
            assert _rel(y, vsr.spmm_vsr_plain(bal, x)) < 1e-4, (name, tile)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_nb_design_launches(cuda):
    """``vsr.DESIGN_LAUNCHES`` shows the design each call took: routed by
    N, forced, through the ``nb_sr`` / ``nb_pr`` entries, and from the
    unfused chain and attention pairs, which route by N."""
    import repro_torch
    csr = _graphs(cuda)["skewed"]
    bal = formats.csr_to_balanced(csr, 64)
    k = csr.shape[1]

    def took(call):
        reset_launch_counts()
        call()
        return dict(vsr.DESIGN_LAUNCHES["vsr_spmm"]), launch_counts()["vsr_spmm"]

    for n, design in ((2, "pr"), (4, "pr"), (5, "sr"), (128, "sr")):
        x = torch.randn(k, n, device=cuda)
        assert took(lambda: vsr.spmm_vsr_fused(bal, x)) == (
            {"sr": int(design == "sr"), "pr": int(design == "pr")}, 1)
        other = "pr" if design == "sr" else "sr"
        assert took(lambda: vsr.spmm_vsr_fused(bal, x, other)) == (
            {"sr": int(other == "sr"), "pr": int(other == "pr")}, 1)
    A = repro_torch.sparse(csr, cache=False)
    for logical, design in (("nb_sr", "sr"), ("nb_pr", "pr")):
        for n in (2, 32):
            x = torch.randn(k, n, device=cuda)
            y = None

            def call():
                nonlocal y
                y = A.matmul(x, impl=logical)
            assert took(call) == ({"sr": int(design == "sr"),
                                   "pr": int(design == "pr")}, 1)
            assert _rel(y, A.matmul(x, impl=logical, backend="torch")) < 1e-4
        reset_launch_counts()
        A.matmul(torch.randn(k, device=cuda), impl=logical)
        assert launch_counts()["vsr_spmv"] == 1
        assert vsr.DESIGN_LAUNCHES["vsr_spmm"] == {"sr": 0, "pr": 0}
    a, b, _ = _chain_operands(csr, 16, 1)
    pat = (bal.rows, bal.cols, a, b)
    for n, design in ((4, "pr"), (32, "sr"), (128, "sr")):
        x = torch.randn(k, n, device=cuda)
        assert took(lambda: fused_chain.chain_unfused(
            *pat, x, shape=csr.shape, transform="softmax", alpha=0.5))[0] \
            == {"sr": int(design == "sr"), "pr": int(design == "pr")}
    # an attention head at d = 256 with the attention gate shut
    spec = _attention_specs()["window"]
    _, q, kq, v, bias = _attention_operands(spec, 256, torch.float32, cuda)
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               attn_fuse_min_seq=spec.seq + 1)
    reset_launch_counts()
    yu = repro_torch.sparse_attention(spec, q, kq, v, bias=bias,
                                      thresholds=shut, cache=False)
    assert vsr.DESIGN_LAUNCHES["vsr_spmm"] == {"sr": 1, "pr": 0}
    assert _rel(yu, repro_torch.sparse_attention(
        spec, q, kq, v, bias=bias, backend="torch", cache=False)) < 1e-4
    with pytest.raises(ValueError):
        vsr.spmm_vsr_fused(bal, torch.randn(k, 8, device=cuda), "tc")
    with pytest.raises(RuntimeError):       # a group the kernel refuses
        vsr._launch("sr", bal, torch.randn(k, 8, device=cuda), lanes=3)


@pytest.mark.gpu
@pytest.mark.parametrize("design,n", [(d, n) for d in ("sr", "pr")
                                      for n in (1, 4, 32, 128)] + [("k2", 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_nb_nonfinite_x_stays_in_its_rows(cuda, design, n, dtype):
    """NaN and inf rows of X reach only the output rows that gather them
    (the reference's "xla" semantics; its Pallas K1 spreads a NaN over its
    output block); padding slots, which read X's row 0, add nothing."""
    for name, csr in _nb_mats(cuda):
        x = torch.randn(csr.shape[1], n, device=cuda)
        x[0] = float("nan")
        x[3, 0], x[7] = float("nan"), float("inf")
        x[9, n - 1] = -float("inf")
        x = x.to(dtype)
        for tile in (7, 100, 512):
            bal = _pad_tile(formats.csr_to_balanced(csr, tile))
            if design == "k2":
                x1 = x[:, 0].contiguous()
                y, want = spmv.spmv_vsr_fused(bal, x1), spmv.spmv_vsr_plain(bal, x1)
            else:
                y = vsr.spmm_vsr_fused(bal, x, design)
                want = vsr.spmm_vsr_plain(bal, x)
            _same_nonfinite(y, want, 1e-4 if dtype == torch.float32 else 2e-2)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the backward of the main path: K6 for the values, the SpMM of Aᵀ for x
# ---------------------------------------------------------------------------

#: (impl forcing the forward, substrate family)
_BWD_IMPLS = (("nb_pr", "balanced"), ("nb_sr", "balanced"),
              ("rs_sr", "ell"), ("rs_pr", "ell"))


def _kernel_of(pick: str, n: int) -> str:
    if pick.startswith("rs_"):
        return "csc_spmm"
    return "vsr_spmv" if n == 1 else "vsr_spmm"


@pytest.mark.gpu
@pytest.mark.parametrize("impl,family", _BWD_IMPLS)
@pytest.mark.parametrize("n", [1, 4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_coo_bwd_plain(cuda, impl, family, n, dtype):
    """``(A.with_values(v) @ x * gy).sum()`` backward on the card against
    the reference's ``_coo_bwd`` in plain PyTorch on the same tensors; K6
    ran in the design N routes to, and the kernel of Aᵀ's pick ran."""
    import repro_torch
    from repro_torch.core.vjp import coo_bwd_plain
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, csr in _graphs(cuda).items():
        A = repro_torch.sparse(csr, cache=False)
        v = torch.randn(A.nnz, device=cuda).to(dtype).requires_grad_()
        x = torch.randn(csr.shape[1], n, device=cuda).to(dtype)
        x = (x[:, 0].contiguous() if n == 1 else x).requires_grad_()
        gy = torch.randn(csr.shape[0], n, device=cuda).to(dtype)
        gy = gy[:, 0].contiguous() if n == 1 else gy
        y = A.with_values(v).matmul(x, impl=impl)
        reset_launch_counts()
        (y.float() * gy.float()).sum().backward()
        counts = launch_counts()
        pt = A.plan.transposed()
        pick = pt.select(n)
        assert counts["sddmm"] == 1, (name, counts)
        design = fused_chain._sddmm_design(n, dtype)
        assert fused_chain.DESIGN_LAUNCHES["sddmm"][design] == 1
        assert counts[_kernel_of(pick, n)] >= 1, (name, pick, counts)
        rows, cols = formats.balanced_pattern(csr, A.plan.tile)
        r, c = rows.reshape(-1)[:A.nnz], cols.reshape(-1)[:A.nnz]
        dv, dx = coo_bwd_plain(r, c, r < csr.shape[0], v.detach(), x.detach(),
                               gy, csr.shape)
        assert v.grad.dtype == dtype and x.grad.dtype == dtype
        assert _rel(v.grad, dv) < tol, (name, family)
        assert _rel(x.grad, dx) < tol, (name, family)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_backward_launches_only_what_is_asked(cuda):
    """x constant: K6 alone; the stream baked: the SpMM of Aᵀ alone; and no
    plain version on the card's path (every product is a launch)."""
    import repro_torch
    csr = _graphs(cuda)["skewed"]
    A = repro_torch.sparse(csr, cache=False)
    x = torch.randn(csr.shape[1], 8, device=cuda)
    v = torch.randn(A.nnz, device=cuda, requires_grad=True)
    spmms = ("vsr_spmm", "vsr_spmv", "csc_spmm")
    y = A.with_values(v) @ x
    reset_launch_counts()
    y.sum().backward()
    counts = launch_counts()
    assert counts["sddmm"] == 1 and sum(counts[k] for k in spmms) == 0
    assert A.plan._transposed is None
    y = A @ x.clone().requires_grad_()
    reset_launch_counts()
    y.sum().backward()
    counts = launch_counts()
    assert counts["sddmm"] == 0 and sum(counts[k] for k in spmms) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k6_at_d2048(cuda, dtype):
    """K6 at d = 2048 (the FFN backward's ``dvals`` at 2,048 tokens), "par"."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    csr = _graphs(cuda)["skewed"]
    rows, cols = formats.balanced_pattern(csr, 512)
    a = torch.randn(csr.shape[0], 2048, device=cuda).to(dtype)
    b = torch.randn(csr.shape[1], 2048, device=cuda).to(dtype)
    reset_launch_counts()
    got = fused_chain.sddmm_fused(rows, cols, a, b, shape=csr.shape)
    assert fused_chain.DESIGN_LAUNCHES["sddmm"]["par"] == 1
    want = fused_chain.sddmm_plain(rows, cols, a, b, shape=csr.shape)
    assert _rel(got, want) < tol
    assert (got.reshape(-1)[csr.nnz:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k1_pr_at_n2048(cuda, dtype):
    """K1's pr design at N = 2048 (the FFN's ``nb_pr`` at 2,048 tokens)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, csr in _graphs(cuda).items():
        bal = formats.csr_to_balanced(csr, 512)
        x = torch.randn(csr.shape[1], 2048, device=cuda).to(dtype)
        got = vsr.spmm_vsr_fused(bal, x, "pr")
        assert _rel(got, vsr.spmm_vsr_plain(bal, x)) < tol, name


@pytest.mark.gpu
def test_cuda_pattern_matmul_backward(cuda):
    """``pattern_matmul`` on the card: grads against ``coo_bwd_plain``; K6
    and K1 pr on Aᵀ's slabs launched; one prep build for the pattern."""
    import repro_torch
    from repro_torch.core.plan import PATTERN_PREP
    from repro_torch.core.vjp import coo_bwd_plain
    from repro_torch.models import SparsePattern
    pat = SparsePattern.random(5, 300, 200, 0.1, 64)
    vals = torch.randn(pat.rows.shape, device=cuda, requires_grad=True)
    before = PATTERN_PREP["builds"]
    for _ in range(2):
        x = torch.randn(200, 40, device=cuda, requires_grad=True)
        gy = torch.randn(300, 40, device=cuda)
        y = repro_torch.pattern_matmul(pat.rows, pat.cols, vals, pat.shape, x)
        vals.grad = None
        reset_launch_counts()
        (y * gy).sum().backward()
        counts = launch_counts()
        assert counts["sddmm"] == 1 and counts["vsr_spmm"] == 1
        r, c = pat.rows.reshape(-1), pat.cols.reshape(-1)
        dv, dx = coo_bwd_plain(r, c, r < 300, vals.detach().reshape(-1),
                               x.detach(), gy, pat.shape)
        assert _rel(vals.grad.reshape(-1), dv) < 1e-4
        assert (vals.grad.reshape(-1)[r >= 300] == 0).all()
        assert _rel(x.grad, dx) < 1e-4
    assert PATTERN_PREP["builds"] == before + 1


@pytest.mark.gpu
def test_cuda_sparse_ffn_grads_match_the_cpu(cuda):
    """One ``SparseFFN`` at SMOKE widths, tile 64: the card's loss and
    grads against the same layer on the CPU (plain versions)."""
    from repro_torch.configs import gemma3_12b
    from repro_torch.models import SparseFFN, sparse_patterns
    from repro_torch.models.config import SparseFFNConfig
    cfg = gemma3_12b.SMOKE.scaled(sparse_ffn=SparseFFNConfig(tile=64))
    pats = {k: v[0] for k, v in sparse_patterns(cfg.scaled(num_layers=1),
                                                device="cpu").items()}
    cpu = SparseFFN(cfg, patterns=pats)
    card = SparseFFN(cfg, patterns={k: type(p)(p.rows.to(cuda), p.cols.to(cuda), p.shape)
                                    for k, p in pats.items()})
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(4, 16, cfg.d_model)
    for ffn, xx in ((cpu, x), (card, x.to(cuda))):
        ffn.zero_grad()
        ffn(xx).square().mean().backward()
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        assert _rel(q.grad.cpu(), p.grad) < 1e-4, name


# ---------------------------------------------------------------------------
# the backward of the SDDMM, the chain, attention and the block family: every
# product a launch through the registry, no plain version on the card's path
# ---------------------------------------------------------------------------

#: selector thresholds that send every pick of a plan (and of its transposed
#: plan) to one substrate family
_FAMILY_THRESHOLDS = {"balanced": dict(pr_avg_row=1e9, sr_cv=-1.0),
                      "ell": dict(pr_avg_row=0.0, sr_cv=1e9)}


@pytest.fixture
def no_plain(monkeypatch):
    """Every plain version a backward could reach on the card, counted: the
    ``"torch"`` registry entries, the flat SDDMM and the local softmax
    statistics of ``core/spmm.py``.  A test asserts the list is empty right
    after the card's forward and backward, and clears it after running a
    plain oracle."""
    from repro_torch.core import registry, spmm, vjp
    calls = []
    for entry in registry.available("torch"):
        def counted(*args, _fn=entry.fn, _name=entry.logical, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setitem(registry._REGISTRY, (entry.logical, "torch"),
                            dataclasses.replace(entry, fn=counted))
    for mod, name in ((spmm, "_sddmm_flat"), (vjp, "_sddmm_flat"),
                      (spmm, "_softmax_stats")):
        real = getattr(mod, name)

        def counted(*args, _fn=real, _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _family_plan(csr, family, **kw):
    import repro_torch
    th = dataclasses.replace(repro_torch.SelectorThresholds(),
                             **_FAMILY_THRESHOLDS[family])
    return repro_torch.sparse(csr, thresholds=th, cache=False, **kw)


def _pattern_flat(csr, tile=512):
    rows, cols = formats.balanced_pattern(csr, tile)
    return rows, cols


_SPMMS = ("vsr_spmm", "vsr_spmv", "csc_spmm")


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["balanced", "ell"])
@pytest.mark.parametrize("d", [4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sddmm_backward_matches_plain(cuda, no_plain, family, d, dtype):
    """``A.sddmm`` backward on the card: ``dA`` by the plan's SpMM and
    ``dB`` by the transposed plan's, against ``sddmm_bwd_plain``."""
    from repro_torch.core.vjp import sddmm_bwd_plain
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, csr in _graphs(cuda).items():
        A = _family_plan(csr, family)
        a = torch.randn(csr.shape[0], d, device=cuda).to(dtype).requires_grad_()
        b = torch.randn(csr.shape[1], d, device=cuda).to(dtype).requires_grad_()
        e = A.sddmm(a, b)
        ge = torch.randn_like(e)
        reset_launch_counts()
        e.backward(ge)
        counts = launch_counts()
        assert no_plain == [], no_plain
        assert sum(counts[k] for k in _SPMMS) == 2, (name, counts)
        assert counts["sddmm"] == 0
        rows, cols = _pattern_flat(csr, A.plan.tile)
        gs = torch.zeros(rows.numel(), device=cuda)
        gs[:csr.nnz] = ge
        da, db = sddmm_bwd_plain(rows, cols, a.detach(), b.detach(),
                                 gs.reshape(rows.shape), csr.shape)
        assert a.grad.dtype == dtype
        assert _rel(a.grad, da) < tol, name
        assert _rel(b.grad, db) < tol, name
        no_plain.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("transform", ["identity", "scale", "softmax"])
@pytest.mark.parametrize("n", [1, 4, 32])
@pytest.mark.parametrize("family", ["balanced", "ell"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chain_backward_matches_plain(cuda, no_plain, transform, n,
                                           family, dtype):
    """``A.chain`` backward on the card against ``chain_bwd_plain``: K6
    twice (the recompute, ``dW``), K7 in full mode for softmax with the
    plan's SpMV for the row sum, and three SpMMs (A, Aᵀ twice), each the
    kernel of its plan's pick."""
    from repro_torch.core.vjp import chain_bwd_plain
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, csr in _graphs(cuda).items():
        A = _family_plan(csr, family, chain_op=transform)
        a = (torch.randn(csr.shape[0], 32, device=cuda) * 0.3).to(dtype).requires_grad_()
        b = (torch.randn(csr.shape[1], 32, device=cuda) * 0.3).to(dtype).requires_grad_()
        x = torch.randn(csr.shape[1], n, device=cuda).to(dtype)
        x = (x[:, 0].contiguous() if n == 1 else x).requires_grad_()
        y = A.chain(a, b, x, transform=transform, alpha=0.4)
        gy = torch.randn_like(y)
        reset_launch_counts()
        y.backward(gy)
        counts = launch_counts()
        assert no_plain == [], no_plain
        assert counts["sddmm"] == 2, (name, counts)
        assert counts["chain_stats"] == int(transform == "softmax")
        if transform == "softmax":
            assert fused_chain.STATS_MODES["full"] == 1
        assert sum(counts[k] for k in _SPMMS) == 3 + int(transform == "softmax")
        rows, cols = _pattern_flat(csr, A.plan.tile)
        want = chain_bwd_plain(rows, cols, a.detach(), b.detach(), x.detach(),
                               gy, csr.shape, transform, 0.4)
        for got, w in zip((a.grad, b.grad, x.grad), want):
            assert got.dtype == dtype
            assert _rel(got, w) < tol, (name, transform)
        no_plain.clear()


@pytest.mark.gpu
def test_cuda_chain_backward_launches_only_what_is_asked(cuda, no_plain):
    """x alone: the recompute (K6) and Aᵀ's SpMM, no ``dW`` and no row sum;
    the K6 of a recompute at d = 4 in the "seq" design."""
    csr = _graphs(cuda)["skewed"]
    A = _family_plan(csr, "balanced", chain_op="softmax")
    a = torch.randn(csr.shape[0], 4, device=cuda)
    b = torch.randn(csr.shape[1], 4, device=cuda)
    x = torch.randn(csr.shape[1], 8, device=cuda, requires_grad=True)
    y = A.chain(a, b, x)
    reset_launch_counts()
    y.sum().backward()
    counts = launch_counts()
    assert counts["sddmm"] == 1 and fused_chain.DESIGN_LAUNCHES["sddmm"]["seq"] == 1
    assert counts["chain_stats"] == 1
    assert sum(counts[k] for k in _SPMMS) == 1
    assert no_plain == []


def _attention_cases(device):
    """A causal band (the block design of K7-K10) and a scattered graph
    (the slot-tile design), each with an ALiBi-like bias."""
    spec = patterns.sliding_window(512, 2, block=64, causal=True)
    return {"band": patterns.build_mask(spec).csr.to(device),
            "graph": rmat(9, 8, seed=3, device=device)}


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_backward_matches_plain(cuda, no_plain, bias, dtype):
    """``execute_attention`` backward on the card against
    ``attn_bwd_plain``: the statistics recomputed in the design the
    pattern routes to (block on the band, slot-tile on the graph), the
    bias's own gradient."""
    import repro_torch
    from repro_torch.core.plan import _stream_to_balanced, execute_attention
    from repro_torch.core.vjp import attn_bwd_plain
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, csr in _attention_cases(cuda).items():
        A = repro_torch.sparse(csr, chain_op="attn", cache=False)
        m = csr.shape[0]
        q = (torch.randn(m, 64, device=cuda) * 0.3).to(dtype).requires_grad_()
        k = (torch.randn(m, 64, device=cuda) * 0.3).to(dtype).requires_grad_()
        v = torch.randn(m, 64, device=cuda).to(dtype).requires_grad_()
        bf = (torch.randn(csr.nnz, device=cuda) * 0.5).requires_grad_() if bias else None
        y = execute_attention(A.plan, q, k, v, bias=bf)
        gy = torch.randn_like(y)
        reset_launch_counts()
        y.backward(gy)
        counts = launch_counts()
        assert no_plain == [], no_plain
        stats = "attn_stats" if bias else "chain_stats"
        design = "block" if name == "band" else "slot"
        mod = attention if bias else fused_chain
        assert counts["sddmm"] == 2 and counts[stats] == 1, (name, counts)
        assert mod.DESIGN_LAUNCHES[stats][design] == 1, (name, mod.DESIGN_LAUNCHES)
        rows, cols = _pattern_flat(csr, A.plan.tile)
        slab = _stream_to_balanced(bf.detach() if bias else
                                   torch.zeros(csr.nnz, device=cuda),
                                   formats.csr_to_balanced(csr, A.plan.tile))
        dq, dk, dbias, dv = attn_bwd_plain(rows, cols, q.detach(), k.detach(),
                                           slab, v.detach(), gy, csr.shape,
                                           64 ** -0.5)
        for got, w in ((q.grad, dq), (k.grad, dk), (v.grad, dv)):
            assert _rel(got, w) < tol, name
        if bias:
            assert _rel(bf.grad, dbias.reshape(-1)[:csr.nnz]) < 1e-4, name
        no_plain.clear()


@pytest.mark.gpu
def test_cuda_block_sparse_attention_backward(cuda):
    """The model's ``_block_sparse_attention`` (GQA, no bias) on the card:
    grads of every head against the same call on the CPU (its plain
    versions)."""
    from repro_torch.configs import gemma3_12b
    from repro_torch.models import transformer
    cfg = dataclasses.replace(gemma3_12b.SMOKE, attn_pattern="block_sparse",
                              attn_block=64)
    b, s, h, hk, hd = 1, 256, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(0)
    ts = [torch.randn(b, hh, s, hd, generator=gen) * 0.3 for hh in (h, hk, hk)]
    gy = torch.randn(b, h, s, hd, generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).clone().requires_grad_() for t in ts]
        y = transformer._block_sparse_attention(*leaves, cfg, True)
        y.backward(gy.to(dev))
        grads.append([t.grad.cpu() for t in leaves])
    for got, want in zip(grads[1], grads[0]):
        assert _rel(got, want) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("block", [(8, 128), (16, 16), (8, 32), (3, 5)])
@pytest.mark.parametrize("n", [1, 4, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bsr_backward_matches_plain(cuda, no_plain, block, n, dtype):
    """``A.with_values(v) @ x`` on the ``"bsr"`` backend, backward on the
    card: ``dvals`` by K6 over the CSR pattern (rounded through the blocks'
    type), ``dX`` by K11 on Aᵀ's BSR at ``(bk, bm)`` in the design it
    routes to (tensor cores where bk ≤ 64 and N ≥ 8, else fma), against
    ``bsr_bwd_plain``."""
    import repro_torch
    from repro_torch.core.vjp import bsr_bwd_plain
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    csr = _block_matrices(cuda)["ragged"]
    csr = formats.CSR(csr.indptr, csr.indices, csr.data.to(dtype), csr.shape)
    A = repro_torch.sparse(csr, backend="bsr", bsr_block=block, cache=False)
    v = csr.data.clone().requires_grad_()
    x = torch.randn(csr.shape[1], n, device=cuda).to(dtype)
    x = (x[:, 0].contiguous() if n == 1 else x).requires_grad_()
    y = A.with_values(v) @ x
    gy = torch.randn_like(y)
    reset_launch_counts()
    y.backward(gy)
    counts = launch_counts()
    assert no_plain == [], no_plain
    assert counts["sddmm"] == 1 and counts["bsr_spmm"] == 1, counts
    sub_t = A.plan.transposed().substrate("bsr")
    assert sub_t.block_shape == block[::-1]
    x2 = gy[:, None] if n == 1 else gy
    assert bsr.DESIGN_LAUNCHES["bsr_spmm"][bsr._design(sub_t, x2)] == 1
    sub = A.plan.substrate("bsr")
    dblocks, dx = bsr_bwd_plain(sub, A.plan.bsr_brow(), x.detach(), gy)
    assert v.grad.dtype == dtype and x.grad.dtype == dtype
    assert _rel(v.grad, dblocks[tuple(A.plan.bsr_map().long())]) < tol
    assert _rel(x.grad, dx) < tol


@pytest.mark.gpu
def test_cuda_backward_unaligned_operands(cuda, no_plain):
    """Operands at an odd element offset (no 16-byte alignment) through the
    chain's and the block family's backward."""
    import repro_torch
    from repro_torch.core.vjp import chain_bwd_plain

    def odd(*shape):
        flat = torch.randn(int(np.prod(shape)) + 1, device=cuda)
        return flat[1:].view(*shape)
    csr = _graphs(cuda)["skewed"]
    A = repro_torch.sparse(csr, chain_op="softmax", cache=False)
    a, b = odd(csr.shape[0], 16).requires_grad_(), odd(csr.shape[1], 16).requires_grad_()
    x = odd(csr.shape[1], 12).requires_grad_()
    y = A.chain(a, b, x, alpha=0.5)
    gy = odd(*y.shape)
    y.backward(gy)
    assert no_plain == [], no_plain
    rows, cols = _pattern_flat(csr, A.plan.tile)
    want = chain_bwd_plain(rows, cols, a.detach(), b.detach(), x.detach(), gy,
                           csr.shape, "softmax", 0.5)
    for got, w in zip((a.grad, b.grad, x.grad), want):
        assert _rel(got, w) < 1e-4
    W = repro_torch.sparse(_block_matrices(cuda)["ragged"], backend="bsr",
                           bsr_block=(8, 16), cache=False)
    xw = odd(W.shape[1], 16).requires_grad_()
    gw = odd(W.shape[0], 16)
    no_plain.clear()
    (W @ xw).backward(gw)
    assert no_plain == [], no_plain
    want_x = bsr.spmm_bsr_plain(W.plan.transposed().substrate("bsr"), gw)
    assert _rel(xw.grad, want_x) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4, 32, 128])
def test_cuda_bsr_tall_blocks_match_plain(cuda, n):
    """K11's fma design on blocks over 64 rows (row chunks of 16 a CTA):
    Aᵀ's (128, 8) blocks of a pruned (8, 128) weight, ragged M and K."""
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        csr = _block_matrices(cuda)["ragged"]
        csr_t, _ = formats.csr_transpose(csr)
        b = formats.csr_to_bsr(formats.CSR(csr_t.indptr, csr_t.indices,
                                           csr_t.data.to(dtype), csr_t.shape),
                               128, 8)
        x = torch.randn(csr_t.shape[1], n, device=cuda).to(dtype)
        reset_launch_counts()
        y = bsr.spmm_bsr(b, x)
        assert bsr.DESIGN_LAUNCHES["bsr_spmm"]["fma"] == 1
        assert _rel(y, bsr.spmm_bsr_plain(b, x)) < tol


# ---------------------------------------------------------------------------
# quantized value slabs: K1 (both designs), K2, K4 and K5 on int8 / fp8 codes
# ---------------------------------------------------------------------------

QUANT_MODES = ("int8", "fp8")
QUANT_TILES = (64, 510, 512)
QUANT_NS = (1, 3, 4, 32, 128)


def _coded(csr, tile, mode, spread=False):
    """The balanced slab of ``csr`` as ``mode`` codes and its scales; with
    ``spread`` every other tile's scale (and the decoded values) 100×
    larger."""
    from repro_torch.core import quant
    bal = formats.csr_to_balanced(csr, tile)
    q, sc = quant.quantize_stream(bal.vals, mode)
    if spread:
        sc = sc * torch.where(torch.arange(sc.numel(), device=sc.device) % 2 == 1,
                              100.0, 1.0)
    return formats.BalancedCOO(bal.rows, bal.cols, q, bal.shape), sc.contiguous()


def _value_launches():
    return {k: dict(v) for mod in (vsr, spmv) for k, v in mod.VALUE_LAUNCHES.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("tile", QUANT_TILES)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_cuda_coded_kernels_match_plain(cuda, mode, tile, xdtype):
    """Each coded variant against its plain version (which decodes, then
    runs the float math): K1 sr and pr forced, K2, K4 and K5, at a tile of
    64 (several tiles a CTA of the sr design at small N), 510 (no multiple
    of 4: scalar code loads) and 512, with scales 100× apart between
    neighbouring tiles, on an aligned and an unaligned X; empty rows exactly
    0, and every launch counted under the mode."""
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    reset_launch_counts()
    launches = 0
    for name, csr in _nb_mats(cuda):
        empty = torch.diff(csr.indptr) == 0
        bal, sc = _coded(csr, tile, mode, spread=True)
        row_base, win = vsr.SpillWindows()(bal)
        for n in QUANT_NS:
            x = torch.randn(csr.shape[1], n, device=cuda).to(xdtype)
            for xx in (x, _unaligned(x)):
                label = (name, n, xx.data_ptr() % 16)
                if n == 1:
                    x1 = xx[:, 0].contiguous() if xx is x else _unaligned(x[:, 0])
                    y = spmv.spmv_vsr_fused(bal, x1, scales=sc)
                    want = spmv.spmv_vsr_plain(bal, x1, sc)
                    assert y.dtype == xdtype and _rel(y, want) < tol, label
                    assert (y[empty] == 0).all(), label
                    part = spmv.spmv_vsr_partials(bal, x1, row_base, win, scales=sc)
                    want = vsr.spill_partials_plain(bal, x1[:, None], row_base,
                                                    win, sc)[..., 0]
                    assert _rel(part, want) < tol, label
                    launches += 2
                    continue
                for design in ("sr", "pr"):
                    y = vsr.spmm_vsr_fused(bal, xx, design, scales=sc)
                    want = vsr.spmm_vsr_plain(bal, xx, sc)
                    assert y.dtype == xdtype and _rel(y, want) < tol, (label, design)
                    assert (y[empty] == 0).all(), (label, design)
                part = vsr.spmm_vsr_partials(bal, xx, row_base, win, scales=sc)
                want = vsr.spill_partials_plain(bal, xx, row_base, win, sc)
                assert _rel(part, want) < tol, label
                launches += 3
    torch.cuda.synchronize()
    counts = _value_launches()
    assert sum(c[mode] for c in counts.values()) == launches
    assert all(c[k] == 0 for c in counts.values() for k in c if k != mode)


def _exact_coded_slab(mode, device):
    """A (3, 64) slab of codes whose products and row sums are exact in
    f32: tile 0 all zero (scale 1.0), tile 1 the mode's extreme codes ±qmax
    at scale 0.5, tile 2 small codes at scale 2.0; rows of 8 slots, the
    last tile's second half padding."""
    from repro_torch.core import quant
    qmax = quant.QMAX[mode]
    codes = torch.zeros(3, 64)
    codes[1] = torch.tensor([qmax, -qmax] * 32)
    codes[2, :32] = torch.arange(32) % 7 - 3.0
    rows = (torch.arange(3 * 64) // 8).reshape(3, 64).int()
    m = 20
    rows[2, 32:] = m
    cols = (torch.arange(3 * 64) * 5 % 40).reshape(3, 64).int()
    cols[2, 32:] = 0
    bal = formats.BalancedCOO(rows.to(device), cols.to(device),
                              codes.to(quant.quant_dtype(mode)).to(device),
                              (m, 40))
    return bal, torch.tensor([1.0, 0.5, 2.0], device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("n", [1, 4, 32])
def test_cuda_coded_extremes_decode_exactly(cuda, mode, n):
    """An all-zero tile and codes at ±127 (int8) / ±448 (fp8) decode exactly:
    on integer X every product and sum is exact, so each kernel equals its
    plain version bit for bit, and the all-zero tile's rows are 0."""
    bal, sc = _exact_coded_slab(mode, cuda)
    x = torch.randint(-3, 4, (40, n), device=cuda).float()
    if n == 1:
        x1 = x[:, 0].contiguous()
        outs = [(spmv.spmv_vsr_fused(bal, x1, scales=sc),
                 spmv.spmv_vsr_plain(bal, x1, sc))]
    else:
        outs = [(vsr.spmm_vsr_fused(bal, x, d, scales=sc),
                 vsr.spmm_vsr_plain(bal, x, sc)) for d in ("sr", "pr")]
    row_base, win = vsr.SpillWindows()(bal)
    if n == 1:
        outs.append((spmv.spmv_vsr(bal, x1, row_base=row_base, win=win,
                                   scales=sc),
                     spmv.spmv_vsr_spill_plain(bal, x1, scales=sc)))
    else:
        outs.append((vsr.spmm_vsr(bal, x, row_base=row_base, win=win,
                                  scales=sc),
                     vsr.spmm_vsr_spill_plain(bal, x, scales=sc)))
    torch.cuda.synchronize()
    for got, want in outs:
        assert torch.equal(got.reshape(want.shape), want)
        assert (got.reshape(20, -1)[:8] == 0).all()     # tile 0: zeros
        assert got.abs().max() > 0


@pytest.mark.gpu
def test_cuda_coded_values_rejected_without_scales_or_elsewhere(cuda):
    """Codes without scales, scales of the wrong shape or type, and codes
    sent to a kernel that takes no codes (K3) raise ``ValueError`` before
    any launch."""
    csr = _graphs(cuda)["skewed"]
    bal, sc = _coded(csr, 64, "int8")
    x = torch.randn(csr.shape[1], 8, device=cuda)
    x1 = x[:, 0].contiguous()
    row_base, win = vsr.SpillWindows()(bal)
    reset_launch_counts()
    calls = [lambda s: vsr.spmm_vsr_fused(bal, x, "sr", scales=s),
             lambda s: vsr.spmm_vsr_fused(bal, x, "pr", scales=s),
             lambda s: spmv.spmv_vsr_fused(bal, x1, scales=s),
             lambda s: vsr.spmm_vsr_partials(bal, x, row_base, win, scales=s),
             lambda s: spmv.spmv_vsr_partials(bal, x1, row_base, win, scales=s)]
    for call in calls:
        for bad in (None, sc[:-1].contiguous(), sc.double(), sc.cpu()):
            with pytest.raises(ValueError):
                call(bad)
    ell = formats.csr_to_ell(csr)
    with pytest.raises(ValueError):
        csc.spmm_csc(dataclasses.replace(ell, vals=ell.vals.to(torch.int8)), x)
    assert sum(launch_counts().values()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_cuda_quantized_plan_main_path(cuda, mode):
    """``sparse(csr, quant=mode) @ x`` on the card: an ``nb_*`` pick on every
    graph, only coded launches (no f32 kernel, no plain version), agreement
    with the ``"torch"`` backend on the same plan, codes made on the card
    bit-equal to the CPU's; a live stream quantized on the card; dX of the
    baked plan equal to the decoded Aᵀ·G."""
    import repro_torch
    from repro_torch.core import quant
    for name, csr in _graphs(cuda).items():
        A = repro_torch.sparse(csr, quant=mode, cache=False)
        bal = A.plan.substrate("balanced")
        assert bal.vals.dtype == quant.quant_dtype(mode), name
        cpu = repro_torch.sparse(csr.to("cpu"), device="cpu", quant=mode,
                                 cache=False).plan
        assert torch.equal(bal.vals.view(torch.uint8).cpu(),
                           cpu.substrate("balanced").vals.view(torch.uint8))
        assert torch.equal(A.plan.quant_scales().cpu(), cpu.quant_scales())
        for n in (1, 4, 32, 128):
            assert A.plan.select(n).startswith("nb_"), (name, n)
            x = torch.randn(csr.shape[1], n, device=cuda)
            x = x[:, 0].contiguous() if n == 1 else x
            reset_launch_counts()
            y = A @ x
            torch.cuda.synchronize()
            counts = _value_launches()
            assert sum(c[mode] for c in counts.values()) == 1, (name, n)
            assert sum(sum(c.values()) for c in counts.values()) == 1
            assert _rel(y, A.matmul(x, backend="torch")) < 1e-4, (name, n)
            v = csr.data * 1.5
            reset_launch_counts()
            yl = A.with_values(v) @ x
            assert sum(c[mode] for c in _value_launches().values()) == 1
            assert _rel(yl, A.with_values(v).matmul(x, backend="torch")) < 1e-4
        x = torch.randn(csr.shape[1], 8, device=cuda, requires_grad=True)
        g = torch.randn(csr.shape[0], 8, device=cuda)
        (A @ x).backward(g)
        dense = torch.zeros(csr.shape, device=cuda)
        dec = quant.dequantize_stream(bal.vals, A.plan.quant_scales())
        valid = bal.rows < csr.shape[0]
        dense.index_put_((bal.rows[valid].long(), bal.cols[valid].long()),
                         dec[valid], accumulate=True)
        assert _rel(x.grad, dense.T @ g) < 1e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq", [40, 100])
def test_cuda_block_design_zero_fill_on_poisoned_staging(cuda, dtype, seq):
    """Fault 3.2: the block design's kernels (K9 / K10, and K7 / K8 with the
    bias compiled out), built with their shared-memory staging filled with
    NaN at CTA entry (``_build.variant("poison_staging")``), at a ragged
    sequence (key rows past K) and a ragged head (depth padded to the
    MMA's), and at a head of 64: the outputs are finite and equal the plain
    versions, so every staged entry the kernels read was written (the zero
    fill of ``stage_tile``).  Without the fill the padded depth's NaN
    reaches every score; a key row past K is masked and, in V, cleared by
    fault 3.1's repair."""
    from repro_torch.kernels import _build
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    spec = patterns.dense_attention(seq, block=8)
    csr = patterns.build_mask(spec).csr.to(cuda)
    bal = formats.csr_to_balanced(csr, 512)
    empty = torch.diff(csr.indptr) == 0
    for d in ((36 if dtype == torch.float32 else 40), 64):
        q, k = ((0.5 * torch.randn(seq, d, device=cuda)).to(dtype)
                for _ in range(2))
        v = torch.randn(seq, 24, device=cuda).to(dtype)
        slab = _stream_to_balanced(
            torch.from_numpy(interop.alibi_bias(csr, 0.05)).to(cuda), bal)
        args = (bal.rows, bal.cols, q, k)
        with _build.variant("poison_staging"):
            reset_launch_counts()
            rm, rs = attention._launch_stats("block", *args, slab,
                                             shape=csr.shape, scale=d ** -0.5)
            y9 = attention._launch_chain("block", *args, slab, v,
                                         shape=csr.shape, scale=d ** -0.5)
            cm, cs = fused_chain._launch_stats("block", *args, shape=csr.shape,
                                               alpha=d ** -0.5)
            y7 = fused_chain._launch_chain("block", *args, v, shape=csr.shape,
                                           transform="softmax", alpha=d ** -0.5)
            torch.cuda.synchronize()
        assert attention.DESIGN_LAUNCHES["attn_chain"]["block"] == 1
        assert fused_chain.DESIGN_LAUNCHES["chain"]["block"] == 1
        pm, ps = attention.attn_stats_plain(*args, slab, shape=csr.shape,
                                            scale=d ** -0.5)
        live = pm > -1e29
        assert torch.isfinite(rs).all() and _rel(rs, ps) < 1e-4, d
        assert _rel(rm[live], pm[live]) < 1e-4, d
        want = attention.attn_chain_plain(*args, slab, v, shape=csr.shape,
                                          scale=d ** -0.5)
        assert torch.isfinite(y9).all() and _rel(y9, want) < tol, d
        cpm, cps = fused_chain.chain_stats_plain(*args, shape=csr.shape,
                                                 alpha=d ** -0.5)
        assert torch.isfinite(cs).all() and _rel(cs, cps) < 1e-4, d
        want = fused_chain.chain_plain(*args, v, shape=csr.shape,
                                       transform="softmax", alpha=d ** -0.5)
        assert torch.isfinite(y7).all() and _rel(y7, want) < tol, d
        assert (y9[empty] == 0).all() and (y7[empty] == 0).all()


# ---------------------------------------------------------------------------
# the frozen artifact on the card: the builder's kernels, no host work, CUDA
# graph capture; fault 3.5 on the card; calibration on the card
# ---------------------------------------------------------------------------

#: (graph, backend, N, impl or None, the launch counter, its design)
_ARTIFACT_CASES = {
    "k1_sr": ("skewed", "hopper", 32, None, "vsr_spmm", "sr"),
    "k1_pr": ("skewed", "hopper", 4, None, "vsr_spmm", "pr"),
    "k2": ("skewed", "hopper", 1, None, "vsr_spmv", None),
    "k3_sr": ("uniform", "hopper", 32, None, "csc_spmm", "sr"),
    "k3_pr": ("uniform", "hopper", 4, "rs_pr", "csc_spmm", "pr"),
    "k11_tc": ("ragged", "bsr", 32, None, "bsr_spmm", "tc"),
    "k11_fma": ("ragged", "bsr", 4, None, "bsr_spmm", "fma"),
}


def _artifact_case(cuda, case):
    import repro_torch
    graph, backend, n, impl, kernel, design = _ARTIFACT_CASES[case]
    csr = (_block_matrices(cuda) if backend == "bsr" else _graphs(cuda))[graph]
    A = repro_torch.sparse(csr, backend=backend, cache=False)
    art = A.plan.finalize(n, impl=impl)
    x = torch.randn(csr.shape[1], n, device=cuda)
    return A, art, (x[:, 0].contiguous() if n == 1 else x), impl, kernel, design


def _designs(kernel):
    mod = {"vsr_spmm": vsr, "csc_spmm": csc, "bsr_spmm": bsr}.get(kernel)
    return None if mod is None else dict(mod.DESIGN_LAUNCHES[kernel])


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_ARTIFACT_CASES))
def test_cuda_artifact_matches_builder(cuda, case):
    """``execute(art, x)`` launches the builder's kernel in the builder's
    design, once, and is bit-equal to ``A @ x`` (these small graphs have no
    row that three tiles hold, so no sum depends on the order of atomics)."""
    import repro_torch
    A, art, x, impl, kernel, design = _artifact_case(cuda, case)
    reset_launch_counts()
    want = A.matmul(x, impl=impl)
    builder = (launch_counts(), _designs(kernel))
    reset_launch_counts()
    got = repro_torch.execute(art, x, impl=impl)
    assert (launch_counts(), _designs(kernel)) == builder
    assert launch_counts()[kernel] == 1 and sum(launch_counts().values()) == 1
    if design is not None:
        assert _designs(kernel)[design] == 1
    assert torch.equal(got, want)
    assert _rel(got, A.matmul(x, impl=impl, backend="torch")) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k1_sr", "k2", "k3_sr", "k11_tc"])
def test_cuda_artifact_graph_capture_and_replay(cuda, case):
    """``execute(art, x)`` and its live-stream form captured in a CUDA
    graph, with the sync guard set to error: each replay bit-equal to the
    eager call, on new values of ``x`` copied into the captured input."""
    import repro_torch
    A, art, x, impl, kernel, _ = _artifact_case(cuda, case)
    vals = torch.randn(A.nnz, device=cuda)
    calls = (lambda: repro_torch.execute(art, x, impl=impl),
             lambda: repro_torch.execute(art, x, vals=vals, impl=impl))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in calls:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                outs.append(f())
            graphs.append(g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(3):
        x.copy_(torch.randn_like(x))
        reset_launch_counts()
        for g in graphs:
            g.replay()
        torch.cuda.synchronize()
        assert sum(launch_counts().values()) == 0    # replays launch no wrapper
        for f, y in zip(calls, outs):
            assert torch.equal(y, f())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k1_sr", "k1_pr", "k2", "k3_sr", "k11_tc",
                                  "k11_fma"])
def test_cuda_artifact_backward_does_no_host_work(cuda, case, no_plain):
    """Forward and backward through an artifact under the sync guard set to
    error: no substrate or pattern prep built, no plain version run, K6
    for ``dvals`` and Aᵀ's pick (K11 on Aᵀ for the block family) for
    ``dX``; both grads within 1e-6 of the builder's."""
    import repro_torch
    from repro_torch.core.plan import PATTERN_PREP
    A, art, x, impl, kernel, _ = _artifact_case(cuda, case)
    gy = torch.randn(A.shape[0], *x.shape[1:], device=cuda)

    def grads(target):
        v = A.values.detach().clone().requires_grad_()
        xx = x.detach().clone().requires_grad_()
        y = repro_torch.execute(target, xx, vals=v, impl=impl)
        return torch.autograd.grad((y * gy).sum(), [v, xx])
    want = grads(A.plan)
    grads(art)                                   # warm-up
    before = (dict(formats.BUILD_COUNTS), PATTERN_PREP["builds"])
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = grads(art)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = launch_counts()
    assert (dict(formats.BUILD_COUNTS), PATTERN_PREP["builds"]) == before
    assert no_plain == [], no_plain
    assert counts["sddmm"] == 1 and sum(counts.values()) == 3, counts
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-6


@pytest.mark.gpu
def test_cuda_fault_35_load_state_dict(cuda):
    """Fault 3.5 on the card: after ``load_state_dict`` writes the pattern
    buffers in place, the backward runs on the loaded pattern's Aᵀ and
    agrees with the freshly loaded module's."""
    from repro_torch.configs import gemma3_12b
    from repro_torch.core.plan import PATTERN_PREP
    from repro_torch.models import SparseFFN
    from repro_torch.models.config import SparseFFNConfig
    cfg = gemma3_12b.SMOKE.scaled(sparse_ffn=SparseFFNConfig(tile=16))
    a, b = SparseFFN(cfg, seed=0), SparseFFN(cfg, seed=1)
    x = torch.randn(4, 8, cfg.d_model, device=cuda)

    def grads(ffn):
        xx = x.clone().requires_grad_()
        return torch.autograd.grad(ffn(xx).square().sum(),
                                   [xx, *ffn.parameters()])
    grads(a)
    builds = PATTERN_PREP["builds"]
    a.load_state_dict(b.state_dict())
    got = grads(a)
    assert PATTERN_PREP["builds"] == builds + 3
    for g, w in zip(got, grads(b)):
        assert _rel(g, w) < 1e-6


@pytest.mark.gpu
def test_cuda_calibrate_backend(cuda, tmp_path):
    """A small calibration on the Hopper kernels: every (matrix, N, kernel)
    timed by CUDA events (finite, positive), the winner saved and
    reloaded, each kernel launched."""
    import math
    import repro_torch
    from repro_torch.core import load_thresholds
    path = str(tmp_path / "th.json")
    reset_launch_counts()
    th, report = repro_torch.calibrate_backend(path, ns=(1, 4, 32), repeats=3)
    assert load_thresholds(path) == th
    assert len(report["times"]) == 2 * 3 * 4
    assert all(math.isfinite(t) and t > 0 for t in report["times"].values())
    assert report["geomean_slowdown_vs_oracle"] >= 1.0
    counts = launch_counts()
    assert counts["vsr_spmm"] and counts["vsr_spmv"] and counts["csc_spmm"]


@pytest.mark.gpu
def test_cuda_quickstart(cuda):
    from repro_torch.examples import quickstart
    out = quickstart.main()
    assert out["agree_n1"] and out["agree_n4"] and out["agree_n64"]
    for key in ("hopper_nb_pr", "hopper_rs_sr", "hopper_spmv", "artifact"):
        assert out[key] < 1e-3, (key, out[key])
    assert out["graph"] < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 32])
def test_cuda_spill_artifact_has_its_windows(cuda, n):
    """The spill opt frozen: ``finalize`` computes the row windows (a host
    scan), so the artifact's call runs K4 (K5 at N = 1) and the combine
    with no sync, equal to the builder's spill call, and a graph captures
    it."""
    import repro_torch
    csr = _graphs(cuda)["uniform"]
    A = repro_torch.sparse(csr, cache=False)
    opts = A.plan.kernel_opts(A.plan.entry("nb_pr"))
    opts["spill"] = True
    art = A.plan.finalize(impl="nb_pr")
    assert art.opts["nb_pr"]["windows"]._value is not None
    x = torch.randn(csr.shape[1], n, device=cuda)
    x = x[:, 0].contiguous() if n == 1 else x
    want = A.matmul(x, impl="nb_pr")
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = repro_torch.execute(art, x, impl="nb_pr")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    kernel = "vsr_spmv_spill" if n == 1 else "vsr_spmm_spill"
    assert launch_counts()[kernel] == 1 and launch_counts()["spill_combine"] == 1
    assert _rel(got, want) < 1e-6
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = repro_torch.execute(art, x, impl="nb_pr")
    g.replay()
    torch.cuda.synchronize()
    assert _rel(y, want) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_cuda_quantized_artifact_calls_capture(cuda, mode):
    """A quantized artifact: its baked codes and a live stream (quantized
    on the card at each call, plain tensor ops, no range check) both run
    the coded K1 under the sync guard and in a CUDA graph, each replay
    equal to the eager call."""
    import repro_torch
    csr = _graphs(cuda)["skewed"]
    A = repro_torch.sparse(csr, quant=mode, cache=False)
    art = A.finalize(32)
    assert art.meta.quant == mode and "quant_scales" in art.aux
    x = torch.randn(csr.shape[1], 32, device=cuda)
    vals = torch.randn(csr.nnz, device=cuda)
    calls = (lambda: repro_torch.execute(art, x),
             lambda: repro_torch.execute(art, x, vals=vals))
    builder = (lambda: A @ x, lambda: A.with_values(vals) @ x)
    for f, b in zip(calls, builder):
        want = b()
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = f()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert vsr.VALUE_LAUNCHES["vsr_spmm"][mode] == 1
        assert torch.equal(got, want)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = f()
        x.copy_(torch.randn_like(x))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, f())


# ---------------------------------------------------------------------------
# the guardrails on the card (core/guardrails.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def health():
    from repro_torch.core import guardrails
    guardrails.HEALTH.reset()
    guardrails.HEALTH.configure()
    yield guardrails.HEALTH
    guardrails.HEALTH.reset()
    guardrails.HEALTH.configure()


@contextlib.contextmanager
def _no_sync():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
@pytest.mark.parametrize("impl,n,kernel", [("nb_pr", 1, "vsr_spmv"),
                                           ("nb_pr", 4, "vsr_spmm"),
                                           ("nb_sr", 32, "vsr_spmm"),
                                           ("rs_sr", 32, "csc_spmm")])
def test_cuda_guardrails_fault_matrix(cuda, health, impl, n, kernel):
    """threshold 2, cooldown 0, three injected Hopper failures: on the card
    there is no rung below, so each call raises with no launch and is
    counted as ``kernel_failure``; the fourth call's half-open probe
    launches the kernel once and closes the breaker.  A failing call with
    grad raises before its backward is built; the next one's grads agree
    with the "torch" backend's."""
    from repro_torch.core.plan import execute, plan
    from repro_torch.runtime.faults import (FaultInjector, FaultSpec,
                                            InjectedFault, inject_faults)
    health.configure(threshold=2, cooldown_s=0.0)
    csr = _graphs(cuda)["skewed"]
    p, ref = plan(csr, backend="hopper"), plan(csr, backend="torch")
    x = torch.randn(csr.shape[1], n, device=cuda)
    x = x[:, 0].contiguous() if n == 1 else x
    want = execute(ref, x, impl=impl)
    fi = FaultInjector({"kernel_execute:hopper": FaultSpec(fail=3)})
    launches = []
    with inject_faults(fi):
        for i in range(4):
            reset_launch_counts()
            if i < 3:
                with pytest.raises(InjectedFault):
                    execute(p, x, impl=impl)
            else:
                y = execute(p, x, impl=impl)
            torch.cuda.synchronize()
            launches.append(launch_counts()[kernel])
    assert launches == [0, 0, 0, 1]
    assert _rel(y, want) < 1e-4
    snap = health.snapshot()
    assert snap["counters"] == {f"kernel_failure:hopper:{impl}": 3}
    assert snap["breakers"][f"hopper:{impl}"] == {
        "state": "closed", "failures": 0, "trips": 2, "recoveries": 1}

    def grads(target):
        v = csr.data.clone().requires_grad_()
        xx = x.clone().requires_grad_()
        out = execute(target, xx, vals=v, impl=impl)
        return (out, *torch.autograd.grad((out * out).sum(), [v, xx]))

    reset_launch_counts()
    with inject_faults(FaultInjector(
            {"kernel_execute:hopper": FaultSpec(fail=1)})):
        with pytest.raises(InjectedFault):
            grads(p)
        got = grads(p)
    torch.cuda.synchronize()
    assert launch_counts()[kernel] >= 1
    for g, w in zip(got, grads(ref)):
        assert _rel(g, w) < 1e-4


@pytest.mark.gpu
def test_cuda_guardrails_fault_launch_variant(cuda, health):
    """The "fault_launch" build: K1, K2 and K3 fail at their launch with
    cudaErrorInvalidConfiguration (9), a real launch error that is not
    sticky — the call raises it and the ladder counts it, the card stays
    usable, and the half-open probe on the default build launches and
    recovers."""
    from repro_torch.core.plan import execute, plan
    from repro_torch.kernels import _build
    health.configure(threshold=1, cooldown_s=0.0)
    csr = _graphs(cuda)["skewed"]
    p, ref = plan(csr, backend="hopper"), plan(csr, backend="torch")
    cases = (("nb_pr", 1, "vsr_spmv"), ("nb_sr", 32, "vsr_spmm"),
             ("rs_sr", 32, "csc_spmm"))
    bal = formats.csr_to_balanced(csr, 512)
    with _build.variant("fault_launch"):
        with pytest.raises(RuntimeError, match="cudaError_t 9"):
            vsr.spmm_vsr_fused(bal, torch.randn(csr.shape[1], 8, device=cuda))
        for impl, n, kernel in cases:
            x = torch.randn(csr.shape[1], n, device=cuda).squeeze(1)
            reset_launch_counts()
            with pytest.raises(RuntimeError, match="cudaError_t 9"):
                execute(p, x, impl=impl)
            assert launch_counts()[kernel] == 0
    torch.cuda.synchronize()                     # the context is healthy
    for impl, n, kernel in cases:
        assert health.counter(f"kernel_failure:hopper:{impl}") == 1
        assert health.counter(f"kernel_reroute:hopper->torch:{impl}") == 0
        assert health.snapshot()["breakers"][f"hopper:{impl}"]["trips"] == 1
        x = torch.randn(csr.shape[1], n, device=cuda).squeeze(1)
        reset_launch_counts()
        y = execute(p, x, impl=impl)
        torch.cuda.synchronize()
        assert launch_counts()[kernel] == 1, impl
        assert _rel(y, execute(ref, x, impl=impl)) < 1e-4
        assert health.snapshot()["breakers"][f"hopper:{impl}"] == {
            "state": "closed", "failures": 0, "trips": 1, "recoveries": 1}


@pytest.mark.gpu
def test_cuda_sentinels_eager_and_captured(cuda, health):
    """A NaN in X: eager "raise" raises, "sanitize" zeroes, and so does
    "fallback" (on the card there is no rung below), each counted as a
    sentinel firing and none as a fallback; under CUDA-graph capture
    "sanitize" and "fallback" stay in the graph, "raise" is refused, no
    counter moves; and the artifact's call with the sentinel off makes no
    host sync."""
    import repro_torch
    from repro_torch.core import guardrails
    csr = _graphs(cuda)["skewed"]
    art = repro_torch.sparse(csr, cache=False).finalize(4)
    name = art.select(4)
    x = torch.randn(csr.shape[1], 4, device=cuda)
    x[int(csr.indices[0])] = float("nan")
    y = repro_torch.execute(art, x)
    assert not bool(torch.isfinite(y).all())
    with _no_sync():
        y_guarded = repro_torch.execute(art, x)
    assert torch.equal(y_guarded.isnan(), y.isnan())
    with pytest.raises(guardrails.NumericFault):
        repro_torch.execute(art, x, sentinel="raise")
    zero = torch.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)
    for policy in ("sanitize", "fallback"):
        reset_launch_counts()
        out = repro_torch.execute(art, x, sentinel=policy)
        assert sum(launch_counts().values()) >= 1, policy
        assert torch.isfinite(out).all()
        assert _rel(out, zero) < 1e-6
    assert health.snapshot()["counters"] == {f"sentinel:execute:{name}": 3}
    health.reset()
    graphs = {}
    for policy in ("sanitize", "fallback"):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = repro_torch.execute(art, x, sentinel=policy)
        graphs[policy] = (g, out)
    with pytest.raises(ValueError, match="eagerly"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            repro_torch.execute(art, x, sentinel="raise")
    for policy, (g, out) in graphs.items():
        g.replay()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), policy
        assert _rel(out, zero) < 1e-4, policy
    x2 = torch.randn_like(x)
    x.copy_(x2)
    graphs["fallback"][0].replay()
    torch.cuda.synchronize()
    assert _rel(graphs["fallback"][1], repro_torch.execute(art, x2)) < 1e-6
    snap = health.snapshot()
    assert snap["counters"] == {}
    assert all(b["trips"] == 0 and b["failures"] == 0
               for b in snap["breakers"].values())


@pytest.mark.gpu
def test_cuda_skip_nonfinite_makes_no_sync(cuda):
    """``TrainConfig(skip_nonfinite=True)`` on the card: the step, its
    all-finite predicate and the selection run under
    ``set_sync_debug_mode("error")`` (the step counter lives on the card);
    the poisoned step keeps params and optimizer state bit for bit."""
    from repro_torch.train import OptConfig, TrainConfig, init_state, make_train_step

    def loss_fn(params, batch):
        poison = torch.where(batch["bad"] > 0, float("nan"), 0.0)
        return ((params["w"] @ batch["x"]) ** 2).mean() + poison, {}

    tcfg = TrainConfig(opt=OptConfig(warmup_steps=1), skip_nonfinite=True)
    state = init_state({"w": torch.randn(8, 16, device=cuda)}, tcfg)
    assert state["opt"]["step"].is_cuda
    step = make_train_step(loss_fn, tcfg)
    xb = torch.randn(16, 4, device=cuda)
    good = {"x": xb, "bad": torch.zeros((), device=cuda)}
    bad = {"x": xb, "bad": torch.ones((), device=cuda)}
    s1, _ = step(state, good)
    with _no_sync():
        s2, m2 = step(s1, bad)
        s3, m3 = step(s2, good)
    assert int(m2["skipped_nonfinite"]) == 1 and int(m3["skipped_nonfinite"]) == 0
    assert torch.equal(s1["params"]["w"], s2["params"]["w"])
    for key in ("m", "v"):
        assert torch.equal(s1["opt"][key]["w"], s2["opt"][key]["w"])
    assert torch.equal(s1["opt"]["step"], s2["opt"]["step"])
    assert not torch.equal(s3["params"]["w"], s2["params"]["w"])


# ---------------------------------------------------------------------------
# the tuner on the card: a geometry sweep, the gates' arms, the timer's modes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_autotune_geometry_small_graph(cuda, no_plain):
    """A sweep over ``HOPPER_CANDIDATES`` on the Hopper kernels of a small
    skewed graph (``nb_pr`` at N = 4, ``nb_sr`` at 32): every candidate
    timed from a CUDA graph, the tuned plan carries the winner's tile,
    launches its kernel and agrees with the plain version (1e-4)."""
    import repro_torch
    from repro_torch.core.cache import pattern_fingerprint
    from repro_torch.kernels import tune
    csr = rmat(12, 16, seed=5, device=cuda)
    timer = tune.Timer()
    th = None
    for n, impl in ((4, "nb_pr"), (32, "nb_sr")):
        th = repro_torch.autotune_geometry(csr, ns=(n,), impl=impl,
                                           thresholds=th, repeats=3,
                                           include_wildcard=False, timer=timer)
    assert len(timer.log) == 2 * len(tune.HOPPER_CANDIDATES)
    assert {e["mode"] for e in timer.log} == {"graph"}, timer.log
    assert all(e["seconds"] > 0 for e in timer.log)
    table = dict(th.geometries)
    fp = pattern_fingerprint(csr)[:12]
    for n, impl in ((4, "nb_pr"), (32, "nb_sr")):
        tile = table[f"hopper|{fp}|n{n}"][0]
        A = repro_torch.sparse(csr, thresholds=th, n_hint=n, cache=False)
        assert A.plan.tile == tile
        x = torch.randn(csr.shape[1], n, device=cuda)
        reset_launch_counts()
        y = A.matmul(x, impl=impl)
        assert launch_counts()["vsr_spmm"] == 1
        assert vsr.DESIGN_LAUNCHES["vsr_spmm"][impl[3:]] == 1
        assert no_plain == []
        assert _rel(y, A.matmul(x, impl=impl, backend="torch")) < 1e-4
        no_plain.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
def test_cuda_measure_chain_arms(cuda, fused, no_plain):
    """``measure_chain``'s arms on the card: the open gate runs the fused
    slot-tile chain (K7 in edge mode, K8) and no SDDMM, the shut gate the
    unfused pair (K6, K7 in full mode, K1) and no K8; no plain version."""
    from repro_torch.kernels import tune
    csr = rmat(11, 8, seed=6, device=cuda)
    reset_launch_counts()
    t = tune.measure_chain(csr, 32, 16, fused=fused, repeats=2)
    counts = launch_counts()
    assert t > 0 and no_plain == []
    if fused:
        assert counts["chain"] > 0 and counts["sddmm"] == 0
        assert counts["vsr_spmm"] == 0
        assert fused_chain.DESIGN_LAUNCHES["chain"]["slot"] == counts["chain"]
        assert fused_chain.STATS_MODES["edge"] > 0
    else:
        assert counts["chain"] == 0 and counts["sddmm"] > 0
        assert counts["vsr_spmm"] == counts["sddmm"]
        assert fused_chain.STATS_MODES["full"] == counts["chain_stats"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("bias", [False, True])
def test_cuda_measure_attention_arms(cuda, fused, bias, no_plain):
    """``measure_attention``'s arms over a causal band: open, the block
    design of K7 + K8 (no bias) or K9 + K10 (bias); shut, K6 → K7 / K9's
    weights → K1; no plain version."""
    from repro_torch.attention import build_mask, sliding_window
    from repro_torch.kernels import tune
    mask = build_mask(sliding_window(1024, 4, block=64, causal=True))
    reset_launch_counts()
    t = tune.measure_attention(mask, 64, fused=fused, bias=bias, repeats=2)
    counts = launch_counts()
    assert t > 0 and no_plain == []
    stats, chain = (("attn_stats", "attn_chain") if bias
                    else ("chain_stats", "chain"))
    designs = attention.DESIGN_LAUNCHES if bias else fused_chain.DESIGN_LAUNCHES
    if fused:
        assert counts[chain] > 0 and counts["sddmm"] == 0
        assert designs[chain]["block"] == counts[chain]
        assert designs[stats]["block"] == counts[stats] == counts[chain]
    else:
        assert counts[chain] == 0 and counts["sddmm"] > 0
        assert counts[stats] == counts["sddmm"] == counts["vsr_spmm"]


@pytest.mark.gpu
def test_cuda_timer_graph_and_eager_agree(cuda):
    """One call timed from its CUDA graph and as back-to-back calls: the
    device times agree within the spread of single calls (25%); a call that
    syncs is timed back-to-back and says why."""
    import repro_torch
    from repro_torch.kernels import tune
    csr = rmat(16, 16, seed=7, device=cuda)
    A = repro_torch.sparse(csr, cache=False)
    x = torch.randn(csr.shape[1], 128, device=cuda)
    call = lambda: A.matmul(x, impl="nb_sr")                  # noqa: E731
    timer = tune.Timer()
    t_graph = timer(call, cuda, 20, "k1")
    assert timer.log[-1]["mode"] == "graph"
    t_b2b = tune._events(call, cuda, 20)
    assert abs(t_graph - t_b2b) <= 0.25 * t_b2b, (t_graph, t_b2b)
    t_sync = timer(lambda: float(call().sum()), cuda, 3, "synced")
    assert timer.log[-1]["mode"] == "b2b" and timer.log[-1]["reason"] == "sync"
    assert t_sync > 0


# ---------------------------------------------------------------------------
# the models: the MoE's SpMM dispatch (K1) and a model's prefill on the card
# ---------------------------------------------------------------------------

def _moe_case(device, e, k, d, f, t, cf, seed=0):
    from repro_torch.models.config import MoEConfig
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {name: torch.randn(s, device=device, generator=gen) * 0.1
         for name, s in (("w_router", (d, e)), ("w_up", (e, d, f)),
                         ("w_gate", (e, d, f)), ("w_down", (e, f, d)))}
    x = torch.randn(t, d, device=device, generator=gen)
    return MoEConfig(e, k, f, capacity_factor=cf), p, x


def _moe_grads(fn, p, x, cfg):
    """``fn``'s output, aux loss and the grads of a fixed projection of
    both w.r.t. ``x`` and every weight."""
    leaves = {n: v.clone().requires_grad_() for n, v in p.items()}
    xg = x.clone().requires_grad_()
    y, aux = fn(leaves, xg, cfg)
    w = torch.cos(torch.arange(y.numel(), device=y.device,
                               dtype=torch.float32)).reshape(y.shape)
    grads = torch.autograd.grad((y * w).sum() + aux,
                                [xg, *leaves.values()])
    return y.detach(), dict(zip(["x", *leaves], grads))


@pytest.mark.gpu
@pytest.mark.parametrize("cf,drops", [(4.0, False), (0.5, True)])
def test_cuda_moe_spmm_matches_torch_backend(cuda, cf, drops):
    """``moe_spmm`` on the card (K1 sr for the dispatch and the combine, K1
    on Aᵀ and K6 in the backward) against the same call on the ``"torch"``
    backend, with and without dropped tokens: forward and grads within
    1e-4."""
    import repro_torch
    from repro_torch.models import moe
    cfg, p, x = _moe_case(cuda, e=16, k=4, d=256, f=64, t=300, cf=cf)
    _, idx, _ = moe.router(p, x, cfg)
    counts_e = torch.bincount(idx.reshape(-1).long(), minlength=16)
    assert bool(counts_e.max() > moe.capacity(300, cfg)) == drops
    reset_launch_counts()
    vsr.reset_counts()
    y, grads = _moe_grads(moe.moe_spmm, p, x, cfg)
    counts = launch_counts()
    assert counts["vsr_spmm"] == 4 and counts["sddmm"] == 1, counts
    assert vsr.DESIGN_LAUNCHES["vsr_spmm"]["sr"] == 4
    with repro_torch.use_backend("torch"):
        reset_launch_counts()
        y_t, grads_t = _moe_grads(moe.moe_spmm, p, x, cfg)
        assert sum(launch_counts().values()) == 0
    assert _rel(y, y_t) < 1e-4
    for name, g in grads.items():
        assert _rel(g, grads_t[name]) < 1e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 3, 4, 64])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_spmm_small_tiles(cuda, t, xdtype):
    """Decode-sized token counts: ``tile = min(512, T·k)`` down to 8 slots;
    K1 takes such a tile (forced dispatch, OLMoE's top-8 of 64 experts)."""
    from repro_torch.models import moe
    cfg, p, x = _moe_case(cuda, e=64, k=8, d=512, f=64, t=t, cf=1.25)
    p, x = {n: v.to(xdtype) if n != "w_router" else v for n, v in p.items()}, \
        x.to(xdtype)
    reset_launch_counts()
    y, _ = moe.moe_spmm(p, x, cfg)
    assert launch_counts()["vsr_spmm"] == 2
    import repro_torch
    with repro_torch.use_backend("torch"):
        y_t, _ = moe.moe_spmm(p, x, cfg)
    assert _rel(y, y_t) < (1e-4 if xdtype == torch.float32 else 2e-2)


@pytest.mark.gpu
def test_cuda_pinned_dispatch_matches_moe_spmm(cuda):
    """The pinned half on the card: the router's own topology frozen into
    two artifacts, the gates a live stream, equal to ``moe_spmm``."""
    from repro_torch.core.cache import PlanCache
    from repro_torch.models import moe
    cfg, p, x = _moe_case(cuda, e=8, k=2, d=64, f=32, t=6, cf=4.0, seed=3)
    y_ref, _ = moe.moe_spmm(p, x, cfg)
    _, idx, _ = moe.router(p, x, cfg)
    topo = tuple(tuple(int(v) for v in row) for row in idx.cpu().numpy())
    cache = PlanCache(capacity=8)
    pinned = moe.dispatch_plans(topo, cfg, cache=cache, n_hint=64)
    assert pinned.dispatch.backend == "hopper" and pinned.idx.is_cuda
    reset_launch_counts()
    y_pin, _ = moe.moe_spmm_pinned(p, x, cfg, pinned)
    # one kernel a product, the selector's pick for each matrix
    assert sum(launch_counts().values()) == 2, launch_counts()
    assert _rel(y_pin, y_ref) < 1e-4
    assert moe.dispatch_plans(topo, cfg, cache=cache, n_hint=64) is pinned


@pytest.mark.gpu
def test_cuda_olmoe_smoke_prefill_matches_torch_backend(cuda):
    """One ``Model.prefill`` of ``olmoe-1b-7b``'s SMOKE config on the card
    (128 tokens: the SpMM dispatch, K1 twice a layer) against the same
    prefill on the ``"torch"`` backend: logits and caches within 1e-4."""
    import repro_torch
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.models import Model, moe
    model = Model(olmoe_1b_7b.SMOKE)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, 256, (4, 32), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = dict(moe.DISPATCH_PATHS)
    reset_launch_counts()
    logits, caches = model.prefill(params, {"tokens": toks}, 40)
    assert launch_counts()["vsr_spmm"] == 2 * olmoe_1b_7b.SMOKE.num_layers
    assert moe.DISPATCH_PATHS["spmm"] - before["spmm"] == 2
    with repro_torch.use_backend("torch"):
        logits_t, caches_t = model.prefill(params, {"tokens": toks}, 40)
    assert bool(torch.isfinite(logits).all())
    assert _rel(logits, logits_t) < 1e-4
    for name in ("k", "v"):
        assert _rel(caches["kv"][name], caches_t["kv"][name]) < 1e-4


def _serve_smoke(cuda, reqs, *, backend=None, **kw):
    """Serve ``reqs`` (rid, prompt, topology) on ``olmoe-1b-7b``'s SMOKE
    config on the card, submits and ticks inside ``use_backend(backend)``;
    returns (tokens by rid, the engine's metrics, launches)."""
    import repro_torch
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine
    model = Model(olmoe_1b_7b.SMOKE)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    scope = (repro_torch.use_backend(backend) if backend is not None
             else contextlib.nullcontext())
    reset_launch_counts()
    with scope:
        eng = ServeEngine(model, params, slots=2, max_len=48, **kw)
        for rid, prompt, topo in reqs:
            eng.submit(Request(rid=rid, prompt=list(prompt), max_new=6,
                               topology=topo))
        done = eng.run_until_done(max_ticks=500)
        eng.close()
    torch.cuda.synchronize()
    assert all(r.done for r in done), [(r.rid, r.status) for r in done]
    return {r.rid: list(r.out) for r in done}, eng.metrics(), launch_counts()


_SERVE_REQS = [(0, [1, 2, 3, 4], (0, 3)), (1, [5, 6], (0, 3)),
               (2, [7, 8, 9], (1, 2))]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["plain", "pinned", "pin_topology"])
def test_cuda_serve_engine_matches_torch_backend(cuda, mode):
    """The serve engine on the card's kernels against the same engine on
    the ``"torch"`` backend: equal tokens, the same plan builds, no plain
    launch on the ``"torch"`` run and no kernel failure."""
    from repro_torch.core.guardrails import HEALTH
    reqs = [(rid, p, topo if mode == "pinned" else None)
            for rid, p, topo in _SERVE_REQS]
    kw = dict(pin_topology=True) if mode == "pin_topology" else {}
    HEALTH.reset()
    out_h, m_h, _ = _serve_smoke(cuda, reqs, async_prefill=False,
                                 async_plans=False, **kw)
    out_t, m_t, launches_t = _serve_smoke(cuda, reqs, backend="torch",
                                          async_prefill=False,
                                          async_plans=False, **kw)
    assert out_h == out_t
    assert m_h["plan_cache"]["builds"] == m_t["plan_cache"]["builds"]
    assert sum(launches_t.values()) == 0
    assert not any(k.startswith(("kernel_failure", "kernel_reroute"))
                   for k in m_h["health"]["counters"])


@pytest.mark.gpu
def test_cuda_serve_engine_pinned_decode_counts_k1(cuda):
    """Pinned lanes decode through the frozen dispatch and combine
    artifacts: K1 launches in every pinned tick (the dispatch, once a MoE
    layer; the combine takes the selector's pick), and the async engine
    decodes the synchronous engine's tokens."""
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.models import moe
    before = moe.DISPATCH_PATHS["pinned"]
    out_s, m_s, launches = _serve_smoke(cuda, _SERVE_REQS, async_prefill=False,
                                        async_plans=False)
    pinned_calls = moe.DISPATCH_PATHS["pinned"] - before
    assert pinned_calls > 0
    assert pinned_calls % olmoe_1b_7b.SMOKE.num_layers == 0
    # the dispatch on K1 a MoE layer, the combine on the selector's pick
    assert launches["vsr_spmm"] >= pinned_calls
    assert sum(launches.values()) >= 2 * pinned_calls
    out_a, m_a, _ = _serve_smoke(cuda, _SERVE_REQS)
    assert out_a == out_s
    assert m_a["plan_cache"]["builds"] >= 1


# ---------------------------------------------------------------------------
# the SSM, hybrid and audio families
# ---------------------------------------------------------------------------

def _family_batch(cfg, cuda, b, s, seed):
    """Tokens (b, s) from ``seed``, and frame embeddings for an audio
    config."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=cuda,
                                     generator=gen)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(b, cfg.num_frames, cfg.d_model,
                                      device=cuda, generator=gen)
    return batch


def _tree_rel(got, want):
    """The largest relative error over the leaves of two cache trees."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        return max(_tree_rel(got[k], want[k]) for k in want)
    if want.is_floating_point():
        return _rel(got, want)
    assert torch.equal(got, want)
    return 0.0


def _family_run(model, params, batch, steps, max_len):
    """Prefill, then ``steps`` greedy decode steps: every step's logits and
    the last caches."""
    logits, caches = model.prefill(params, batch, max_len)
    out = [logits]
    for _ in range(steps):
        tok = logits.argmax(-1, keepdim=True)
        logits, caches = model.decode_step(params, caches, tok)
        out.append(logits)
    return out, caches


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-2.7b", "whisper-tiny"])
def test_cuda_ssm_family_smoke_matches_torch_backend(cuda, name):
    """Each new family's SMOKE model on the card: a prefill of 12 tokens
    and 3 greedy decode steps on ``"hopper"`` (the default) against
    ``"torch"``: logits and caches within 1e-4, all finite."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import Model
    cfg = configs.get_smoke(name)
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = _family_batch(cfg, cuda, 2, 12, 1)
    with torch.no_grad():
        got, caches = _family_run(model, params, batch, 3, 24)
        with repro_torch.use_backend("torch"):
            want, caches_t = _family_run(model, params, batch, 3, 24)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) < 1e-4
    assert _tree_rel(caches, caches_t) < 1e-4
    assert int(caches["length"]) == 15


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zamba2-d80", "whisper-20-frames"])
def test_cuda_block_sparse_families_launch_k7_k8(cuda, case):
    """``block_sparse`` attention in the new families runs K7 and K8, one
    launch each a layer, head and lane: Zamba2's shared attention at head
    width 80 (a causal band of 64-blocks, the block design), and Whisper's
    encoder on a non-causal mask over 20 frames (not a multiple of the
    block) and its decoder's causal prefill.  Prefill and one decode step
    against ``"torch"`` within 1e-4."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import fused_chain
    from repro_torch.models import Model
    if case == "zamba2-d80":
        cfg = configs.get_smoke("zamba2-2.7b").scaled(
            d_model=160, num_heads=2, num_kv_heads=2, head_dim=80,
            attn_pattern="block_sparse", window=128, attn_block=64)
        b, s = 1, 256
        want = (cfg.num_layers // cfg.shared_every) * cfg.num_heads * b
    else:
        cfg = configs.get_smoke("whisper-tiny").scaled(
            attn_pattern="block_sparse", window=16, attn_block=8,
            num_frames=20)
        b, s = 2, 12
        want = (cfg.encoder_layers + cfg.num_layers) * cfg.num_heads * b
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = _family_batch(cfg, cuda, b, s, 2)
    with torch.no_grad():
        reset_launch_counts()
        got, _ = _family_run(model, params, batch, 1, s + 4)
        torch.cuda.synchronize()
        counts = launch_counts()
        designs = {k: dict(fused_chain.DESIGN_LAUNCHES[k])
                   for k in ("chain_stats", "chain")}
        with repro_torch.use_backend("torch"):
            ref, _ = _family_run(model, params, batch, 1, s + 4)
    assert counts["chain_stats"] == counts["chain"] == want, (counts, want)
    if case == "zamba2-d80":
        assert designs["chain_stats"]["block"] == designs["chain"]["block"] \
            == want, designs
    for g, w in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) < 1e-4


@pytest.mark.gpu
def test_cuda_ssd_chunked_matches_the_recurrence_at_head_width_64(cuda):
    """``ssd_chunked`` at Zamba2-2.7B's head shapes (H 80, P 64, N 64,
    chunk 256) on 512 tokens, with a chunk that does not divide them too:
    y and the final state equal the ``ssd_decode_step`` recurrence within
    1e-3."""
    from repro_torch.models import ssm
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, s, h, p, n = 1, 512, 80, 64, 64
    x = torch.randn(b, s, h, p, device=cuda, generator=gen)
    dt = torch.rand(b, s, h, device=cuda, generator=gen) * 0.1 + 0.01
    a_log = torch.rand(h, device=cuda, generator=gen)
    bb = torch.randn(b, s, n, device=cuda, generator=gen) * 0.3
    cc = torch.randn(b, s, n, device=cuda, generator=gen) * 0.3
    d = torch.randn(h, device=cuda, generator=gen)
    state = torch.zeros(b, h, n, p, device=cuda)
    ys = []
    for t in range(s):
        y, state = ssm.ssd_decode_step(state, x[:, t], dt[:, t], a_log,
                                       bb[:, t], cc[:, t], d)
        ys.append(y)
    y_step = torch.stack(ys, 1)
    for chunk in (256, 200):
        y, fin = ssm.ssd_chunked(x, dt, a_log, bb, cc, d, chunk=chunk)
        assert _rel(y, y_step) < 1e-3, chunk
        assert _rel(fin, state) < 1e-3, chunk


# ---------------------------------------------------------------------------
# the sharded backend: four shards of one matrix on cuda:0, each on a stream
# of its own, against the unsharded plan on the same card
# ---------------------------------------------------------------------------

def _shard_mesh(device, n=4):
    from repro_torch.launch import make_local_mesh
    return make_local_mesh(n, 1, devices=[str(device)] * n)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kind", [("skewed", "nnz"), ("uniform", "row")])
def test_cuda_sharded_matmul_matches_unsharded(cuda, name, kind):
    """Every matmul kernel a shard (four launches a call), repeated in one
    process to catch races between the shards' streams."""
    from repro_torch.core import plan as plan_mod
    kernel_of = {"nb_sr": "vsr_spmm", "nb_pr": "vsr_spmm",
                 "rs_sr": "csc_spmm", "rs_pr": "csc_spmm"}
    csr = _graphs(cuda)[name]
    p = plan_mod.plan(csr, mesh=_shard_mesh(cuda), shard_kind=kind)
    assert p.inner_backend == "hopper" and p.shard_spec.kind == kind
    ref = plan_mod.plan(csr, backend="hopper")
    for _ in range(3):
        for n in (1, 4, 32, 128):
            x = torch.randn(csr.shape[1], n, device=cuda)
            x = x[:, 0].contiguous() if n == 1 else x
            for impl, kernel in kernel_of.items():
                kernel = "vsr_spmv" if n == 1 and impl.startswith("nb") else kernel
                want = plan_mod.execute(ref, x, impl=impl)
                reset_launch_counts()
                got = plan_mod.execute(p, x, impl=impl)
                torch.cuda.synchronize()
                assert launch_counts()[kernel] == 4, (impl, n)
                assert got.device == x.device
                assert _rel(got, want) < 1e-4, (impl, n)


@pytest.mark.gpu
def test_cuda_sharded_backward_and_spill(cuda):
    """nnz split at N = 32: ``dvals`` of a live stream (K6 a shard) and
    ``dX`` (K1 on each shard's transposed slabs) against the unsharded
    plan's; the spill inner (K4 / K5 and the combine a shard)."""
    from repro_torch.core import plan as plan_mod
    csr = _graphs(cuda)["skewed"]
    p = plan_mod.plan(csr, mesh=_shard_mesh(cuda), shard_kind="nnz")
    ref = plan_mod.plan(csr, backend="hopper")
    for _ in range(3):
        x = torch.randn(csr.shape[1], 32, device=cuda)
        g = torch.randn(csr.shape[0], 32, device=cuda)
        grads = []
        for plan_ in (p, ref):
            v = csr.data.clone().requires_grad_()
            xx = x.clone().requires_grad_()
            reset_launch_counts()
            (plan_mod.execute(plan_, xx, vals=v) * g).sum().backward()
            torch.cuda.synchronize()
            grads.append((v.grad, xx.grad, launch_counts()))
        (dv, dx, counts), (dv_ref, dx_ref, _) = grads
        assert counts["sddmm"] == 4 and counts["vsr_spmm"] == 8, counts
        assert _rel(dv, dv_ref) < 1e-4 and _rel(dx, dx_ref) < 1e-4
    p.kernel_opts(p.entry("nb_pr"))["spill"] = True
    for n in (1, 8):
        x = torch.randn(csr.shape[1], n, device=cuda)
        x = x[:, 0].contiguous() if n == 1 else x
        reset_launch_counts()
        got = plan_mod.execute(p, x, impl="nb_pr")
        torch.cuda.synchronize()
        counts = launch_counts()
        spill = "vsr_spmv_spill" if n == 1 else "vsr_spmm_spill"
        assert counts[spill] == counts["spill_combine"] == 4, counts
        assert _rel(got, plan_mod.execute(ref, x, impl="nb_pr")) < 1e-4


@pytest.mark.gpu
def test_cuda_sharded_ring_matches_psum(cuda):
    """The overlapped ring (three chunks at N = 300, the ring on a stream of
    its own) against the blocking psum, value and gradient, repeated."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.selector import SelectorThresholds
    csr = _graphs(cuda)["skewed"]
    ring = plan_mod.plan(csr, mesh=_shard_mesh(cuda), shard_kind="nnz",
                         thresholds=SelectorThresholds(overlap_min_n=1))
    psum = plan_mod.plan(csr, mesh=_shard_mesh(cuda), shard_kind="nnz")
    for _ in range(5):
        x = torch.randn(csr.shape[1], 300, device=cuda, requires_grad=True)
        y, y_psum = (plan_mod.execute(q, x, impl="nb_sr") for q in (ring, psum))
        assert _rel(y, y_psum) < 1e-5
        g = torch.randn_like(y)
        gx = torch.autograd.grad((y * g).sum(), x)[0]
        gx_psum = torch.autograd.grad((y_psum * g).sum(), x)[0]
        assert _rel(gx, gx_psum) < 1e-5


@pytest.mark.gpu
def test_cuda_sharded_chain_and_attention(cuda):
    """The softmax chain with the cross-shard merge (nnz split: K7 a shard,
    then K8 a shard on the merged statistics), row split, and one attention
    head on a band (row split: each shard its own block layout) against the
    unsharded plans; with a bias it raises."""
    from repro_torch.attention import sparse_attention
    from repro_torch.core import plan as plan_mod
    for name, kind in (("skewed", "nnz"), ("uniform", "row")):
        csr = _graphs(cuda)[name]
        p = plan_mod.plan(csr, mesh=_shard_mesh(cuda), shard_kind=kind)
        ref = plan_mod.plan(csr, backend="hopper")
        for _ in range(3):
            a, b, x = _chain_operands(csr, 32, 16)
            reset_launch_counts()
            got = plan_mod.execute_chain(p, a, b, x, transform="softmax",
                                         alpha=0.125)
            torch.cuda.synchronize()
            counts = launch_counts()
            assert counts["chain"] == 4, counts
            assert counts["chain_stats"] == 4 or kind == "row", counts
            want = plan_mod.execute_chain(ref, a, b, x, transform="softmax",
                                          alpha=0.125)
            assert _rel(got, want) < 1e-4, (name, kind)
            assert _rel(plan_mod.execute_sddmm(p, a, b),
                        plan_mod.execute_sddmm(ref, a, b)) < 1e-4
    spec = patterns.sliding_window(1024, 2, block=64, causal=True)
    mesh = _shard_mesh(cuda)
    q, k, v = (torch.randn(1024, 64, device=cuda) for _ in range(3))
    for _ in range(3):
        reset_launch_counts()
        got = sparse_attention(spec, q, k, v, mesh=mesh, cache=False)
        torch.cuda.synchronize()
        assert launch_counts()["chain"] == 4
        assert fused_chain.DESIGN_LAUNCHES["chain"]["block"] == 4
        assert _rel(got, sparse_attention(spec, q, k, v, cache=False)) < 1e-4
    with pytest.raises(ValueError, match="bias"):
        sparse_attention(spec, q, k, v, mesh=mesh, cache=False, bias=torch.zeros(
            patterns.build_mask(spec).csr.nnz, device=cuda))


@pytest.mark.gpu
def test_cuda_sharded_artifact_and_pattern(cuda):
    """A finalized sharded artifact: its call equals the builder's and does
    no sync; ``execute_pattern(mesh=)`` and its grads equal the unsharded
    entry's."""
    from repro_torch.core import plan as plan_mod
    csr = _graphs(cuda)["skewed"]
    p = plan_mod.plan(csr, mesh=_shard_mesh(cuda), shard_kind="nnz")
    art = p.finalize(32)
    x = torch.randn(csr.shape[1], 32, device=cuda)
    want = plan_mod.execute(p, x)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = plan_mod.execute(art, x)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert _rel(got, want) < 1e-4
    bal = formats.csr_to_balanced(csr, 64)
    for _ in range(3):
        out = []
        for mesh in (_shard_mesh(cuda), None):
            v = bal.vals.clone().requires_grad_()
            xx = x.clone().requires_grad_()
            y = plan_mod.execute_pattern(bal.rows, bal.cols, v, bal.shape, xx,
                                         mesh=mesh)
            out.append((y, *torch.autograd.grad(y.square().sum(), (v, xx))))
        for a, b in zip(*out):
            assert _rel(a, b) < 1e-4


@pytest.mark.gpu
def test_cuda_sharded_call_captures_in_a_graph(cuda):
    """A sharded call forks the shards' streams from the capturing stream and
    joins them back: ``tune.Timer`` times it from a CUDA graph, and a
    graph of a frozen artifact's call (the ring's too) replays the eager
    result."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.selector import SelectorThresholds
    from repro_torch.kernels import tune
    csr = _graphs(cuda)["skewed"]
    for th in (SelectorThresholds(), SelectorThresholds(overlap_min_n=1)):
        p = plan_mod.plan(csr, mesh=_shard_mesh(cuda), shard_kind="nnz",
                          thresholds=th)
        x = torch.randn(csr.shape[1], 300, device=cuda)
        timer = tune.Timer()
        timer(lambda: plan_mod.execute(p, x, impl="nb_sr"), cuda, 3, "k")
        assert timer.log[-1]["mode"] == "graph", timer.log
        art = p.finalize(kernels=("nb_sr",))
        want = plan_mod.execute(art, x)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            plan_mod.execute(art, x)                    # warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = plan_mod.execute(art, x)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert _rel(y, want) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_cuda_launcher_smoke_matches_the_cpu(cuda, arch, tmp_path):
    """``launch.train`` at ``--scale smoke`` (f32), 3 steps on the card
    from the CPU's initial params: losses within 1e-4 of the CPU run's,
    each leaf's change over the run within 1e-3 and its AdamW moments
    within 1e-4 (2-norm, relative; the CPU run is held to the reference's
    in ``test_torch_launch.py``), the state on the card, the MoE's dispatch
    and combine on K1."""
    from repro_torch.launch import train
    from repro_torch.models import Model
    cfg = train.scale_config(arch, "smoke")
    init = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    runs = {}
    for dev in ("cpu", cuda):
        params = _to(init, dev)
        reset_launch_counts()
        driver, _, state = train.train(
            cfg, steps=3, batch=2, seq=32, device=dev, params=params,
            ckpt_dir=str(tmp_path / str(dev)))
        runs[str(dev)] = ([e.metrics["loss"] for e in driver.events],
                          launch_counts(), state)
        assert state["params"]["embed"].device.type == torch.device(dev).type
    (cpu_losses, cpu_counts, cpu_state), (card_losses, card_counts,
                                          card_state) = runs.values()
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-4)
    init = _flat(init)
    for tree, tol in (("params", 1e-3), ("m", 1e-4), ("v", 1e-4)):
        pick = (lambda st: st["params"]) if tree == "params" else (
            lambda st, t=tree: st["opt"][t])
        got, want = _flat(pick(card_state)), _flat(pick(cpu_state))
        if tree == "params":
            got = {k: v - init[k] for k, v in got.items()}
            want = {k: v - init[k] for k, v in want.items()}
        worst = max(float((got[k] - want[k]).norm()
                          / max(float(want[k].norm()), 1e-30)) for k in want)
        assert worst < tol, (tree, worst)
    assert not any(cpu_counts.values())
    if arch == "olmoe-1b-7b":
        assert card_counts["vsr_spmm"] >= 2 * cfg.num_layers


@pytest.mark.gpu
def test_cuda_launcher_follows_the_cpu_past_warmup(cuda, tmp_path):
    """The launcher's 100m OLMoE cut to 2 layers of 128 and a vocab of
    1,024 (the 100m's capacity factor: experts drop tokens), 100 steps of
    16 x 128 at lr 3e-3 from the same params on the card and on the CPU
    (which ``test_torch_launch.py`` holds to the reference): each 25-step
    mean within 5e-3, the loss falling 0.1, the dispatch and combine on
    K1."""
    from repro_torch.launch import train
    from repro_torch.models import Model
    cfg = train.scale_config("olmoe-1b-7b", "100m")
    cfg = cfg.scaled(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                     head_dim=32, d_ff=512, vocab_size=1024,
                     moe=dataclasses.replace(cfg.moe, d_ff_expert=256))
    init = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    means = {}
    for dev in ("cpu", cuda):
        reset_launch_counts()
        driver, _, _ = train.train(
            cfg, steps=100, batch=16, seq=128, lr=3e-3, device=dev,
            params=_to(init, dev), ckpt_dir=str(tmp_path / str(dev)),
            ckpt_every=101)
        losses = np.array([e.metrics["loss"] for e in driver.events])
        means[str(dev)] = losses.reshape(-1, 25).mean(1)
    card_counts = launch_counts()
    cpu, card = means["cpu"], means[str(cuda)]
    np.testing.assert_allclose(card, cpu, atol=5e-3)
    assert cpu[-1] < cpu[0] - 0.1
    assert card_counts["vsr_spmm"] >= 4 * cfg.num_layers * 100


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _flat(tree, prefix=""):
    """``{"a.b": leaf}`` of a tree of dicts, leaves as f64 on the CPU."""
    if isinstance(tree, dict):
        return {k: v for name in tree
                for k, v in _flat(tree[name], f"{prefix}{name}.").items()}
    return {prefix[:-1]: tree.detach().double().cpu()}


# ---------------------------------------------------------------------------
# the weight-gathered SPMD runtime (models/spmd.py): a (2, 2) mesh whose
# four positions share the card, against the same mesh of CPU positions
# ---------------------------------------------------------------------------

def _tp_state(arch, devices, tcfg):
    """``arch``'s smoke model, its params and a (2, 2) mesh on ``devices``
    with the state placed; ``<arch>+sparse`` adds a sparse FFN whose value
    streams (308 tiles of 8) split over data."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import make_local_mesh
    from repro_torch.launch.train import place_state
    from repro_torch.models import Model
    from repro_torch.models.config import SparseFFNConfig
    from repro_torch.train import init_state
    arch, _, sparse = arch.partition("+")
    cfg = get_smoke(arch)
    if sparse:
        cfg = cfg.scaled(sparse_ffn=SparseFFNConfig(density=0.3, tile=8))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    mesh = make_local_mesh(2, 2, devices=devices)
    state, shardings = place_state(model, init_state(params, tcfg), mesh)
    return model, params, mesh, state, shardings


def _tp_batch(dev):
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 256, (4, 32))).to(dev)
    labels = torch.from_numpy(rng.integers(-1, 256, (4, 32))).to(dev)
    return {"tokens": tokens, "labels": labels}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b",
                                  "llama3.2-1b+sparse", "zamba2-2.7b"])
def test_cuda_tp_train_matches_the_cpu(cuda, arch):
    """Two steps on the card's (2, 2) mesh from the CPU mesh's params:
    losses within 1e-4, each leaf's change within 1e-3 and its AdamW
    moments within 1e-4 (2-norm, relative); every shard on the card.  The
    sparse FFN's steps launch K1 (each shard's forward and dX) and K6
    (each shard's dvals): 2 layers x 3 matrices x 2 shards x 4 positions
    = 48 matmuls a step, K1 twice each."""
    from repro_torch.dist.placement import device_get
    from repro_torch.kernels import (fused_chain, launch_counts,
                                     reset_launch_counts, vsr)
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1))
    runs = {}
    for devs in (["cpu"] * 4, [str(cuda)] * 4):
        model, init, mesh, state, _ = _tp_state(arch, devs, tcfg)
        step = make_train_step(model.loss_fn, tcfg)
        losses = []
        for _ in range(2):
            reset_launch_counts()
            state, metrics = step(state, _tp_batch(devs[0]))
            losses.append(float(metrics["loss"]))
            counts = launch_counts()
            if devs[0] != "cpu" and arch.endswith("+sparse"):
                assert (counts["vsr_spmm"], counts["sddmm"]) == (96, 48), \
                    counts
                assert sum(vsr.DESIGN_LAUNCHES["vsr_spmm"].values()) == 96
                assert sum(fused_chain.DESIGN_LAUNCHES["sddmm"].values()) == 48
            elif devs[0] != "cpu":
                assert not any(counts.values()), counts
        leaf = state["params"]["blocks"]["attn" if "attn" in
                                         state["params"]["blocks"] else
                                         "w_in"]
        leaf = leaf["wq"] if isinstance(leaf, dict) else leaf
        assert all(leaf.local(p).device.type == torch.device(devs[0]).type
                   for p in np.ndindex(2, 2))
        runs[devs[0]] = (losses, device_get(state))
    (cpu_l, cpu_s), (card_l, card_s) = runs.values()
    np.testing.assert_allclose(card_l, cpu_l, rtol=1e-4)
    init = _flat(init)
    for tree, tol in (("params", 1e-3), ("m", 1e-4), ("v", 1e-4)):
        pick = (lambda st: st["params"]) if tree == "params" else (
            lambda st, t=tree: st["opt"][t])
        got, want = _flat(pick(card_s)), _flat(pick(cpu_s))
        if tree == "params":
            got = {k: v - init[k] for k, v in got.items()}
            want = {k: v - init[k] for k, v in want.items()}
        for k in want:
            assert float((got[k] - want[k]).norm()) <= \
                tol * float(want[k].norm()) + 1e-12, (tree, k)


@pytest.mark.gpu
def test_cuda_tp_prefill_matches_the_cpu(cuda):
    from repro_torch.dist.placement import device_get
    from repro_torch.train import TrainConfig
    out = {}
    for devs in (["cpu"] * 4, [str(cuda)] * 4):
        model, _, _, state, _ = _tp_state("llama3.2-1b", devs, TrainConfig())
        logits, caches = model.prefill(state["params"],
                                       {"tokens": _tp_batch(devs[0])["tokens"]},
                                       40)
        out[devs[0]] = (device_get(logits), device_get(caches))
    (lc, cc), (lg, cg) = out.values()
    assert float((lg - lc).abs().max()) <= 1e-4 * float(lc.abs().max())
    for k, v in _flat(cc).items():
        assert float((_flat(cg)[k] - v).abs().max()) <= \
            1e-4 * max(float(v.abs().max()), 1e-30), k


@pytest.mark.gpu
def test_cuda_tp_restore_onto_another_mesh_and_the_log(cuda, tmp_path):
    """A placed state saved at (2, 2) on the card restores at (4, 1) on the
    card bit-equal; one step's log of position (0, 0) equals the plan."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist.placement import Placed, device_get
    from repro_torch.launch import dryrun, make_local_mesh
    from repro_torch.models import spmd
    from repro_torch.launch.train import place_state, train_rules
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import TrainConfig, init_state, make_train_step
    tcfg = TrainConfig()
    model, params, mesh, state, _ = _tp_state("llama3.2-1b",
                                              [str(cuda)] * 4, tcfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    mesh4 = make_local_mesh(4, 1, devices=[str(cuda)] * 4)
    _, sh4 = place_state(model, init_state(params, tcfg), mesh4)
    back = mgr.restore(1, like=state, shardings=sh4)
    assert isinstance(back["params"]["embed"], Placed)
    want, got = _flat(device_get(state)), _flat(device_get(back))
    assert all(torch.equal(got[k], v) for k, v in want.items())
    with spmd.collective_log() as log:
        make_train_step(model.loss_fn, tcfg)(state, _tp_batch(cuda))
    plan = dryrun.plan_collectives(model, ShapeCell("t", 32, 4, "train"),
                                   mesh, train_rules())
    by_kind = {}
    for r in plan:
        by_kind[r.kind] = by_kind.get(r.kind, 0) + r.bytes * r.count
    assert log.bytes_by_kind((0, 0)) == by_kind


# ---------------------------------------------------------------------------
# decode on placed params (models/spmd.py, tensor-parallel): a (2, 2) mesh
# whose four positions share the card, against the card's unsharded decode
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3.2-1b+sparse"])
def test_cuda_tp_decode_matches_the_unsharded_decode(cuda, arch, cell):
    """Three decode steps after an unsharded prefill (batch 4, or 1 under
    the long_500k rules, the cache's sequence split four ways): logits and
    caches within 1e-4 (f32) of the unsharded decode on the card; each
    step's log equals the plan.  The sparse FFN's value streams (308 tiles
    of 8) split over data: K1 pr on each shard's piece, 4 positions x 2
    shards x 3 matrices x 2 layers = 48 a step, no sr; the dense model
    launches no kernel."""
    from repro_torch.configs import get_smoke
    from repro_torch.dist.placement import device_get, device_put
    from repro_torch.kernels import launch_counts, reset_launch_counts, vsr
    from repro_torch.launch import dryrun, input_specs, make_local_mesh
    from repro_torch.launch.train import param_placement
    from repro_torch.models import SHAPES, Model, spmd
    from repro_torch.models.config import ShapeCell, SparseFFNConfig
    from repro_torch.models.sharding_ctx import activation_sharding
    base, _, sparse = arch.partition("+")
    cfg = get_smoke(base)
    if sparse:
        cfg = cfg.scaled(sparse_ffn=SparseFFNConfig(density=0.3, tile=8))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    params = _to(params, cuda)
    b = 1 if cell == "long_500k" else 4
    rules = input_specs.rules_for_cell(
        next(c for c in SHAPES if c.name == cell), cfg, model_axis=2)
    mesh = make_local_mesh(2, 2, devices=[str(cuda)] * 4)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, 256, (b, 12))).to(cuda)
    steps = torch.from_numpy(rng.integers(0, 256, (b, 3))).to(cuda)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": prompt}, 32)
        placed = device_put(params, param_placement(model, params, mesh,
                                                    rules))
        pc = device_put(caches, model.cache_shardings(caches, mesh, rules))
        plan = {}
        for r in dryrun.plan_collectives(model, ShapeCell("t", 32, b,
                                                          "decode"),
                                         mesh, rules):
            key = (r.kind, r.axes, r.n, r.bytes)
            plan[key] = plan.get(key, 0) + r.count
        for i in range(3):
            want, caches = model.decode_step(params, caches, steps[:, i:i + 1])
            reset_launch_counts()
            with activation_sharding(mesh, rules), \
                    spmd.collective_log() as log:
                got, pc = model.decode_step(placed, pc, steps[:, i:i + 1])
            torch.cuda.synchronize()
            counts = launch_counts()
            if sparse:
                assert counts["vsr_spmm"] == 48, counts
                assert vsr.DESIGN_LAUNCHES["vsr_spmm"] == {"sr": 0, "pr": 48}
                assert sum(counts.values()) == 48, counts
            else:
                assert not any(counts.values()), counts
            ran = {}
            for r in log.program((0, 0)):
                key = (r.kind, r.axes, r.n, r.bytes)
                ran[key] = ran.get(key, 0) + r.count
            assert ran == plan
            got = device_get(got, cuda)
            assert float((got - want).abs().max()) <= \
                1e-4 * float(want.abs().max())
    for k, v in _flat(caches).items():
        g = _flat(device_get(pc, cuda))[k]
        assert float((g - v).abs().max()) <= \
            1e-4 * max(float(v.abs().max()), 1e-30), k
