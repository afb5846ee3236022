"""Each CUDA kernel of the port (K1-K11) against its plain PyTorch
version, on the card.  Marked ``gpu``: they skip without a CUDA device (the kernels have no
CPU mode).  This file imports neither JAX nor the reference package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: relative inf-norm error 1e-4 in float32 (sums in another order,
atomics in no fixed order), 2e-2 with a bfloat16 x."""
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
                "vsr_spmv_spill": 0}
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


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 6, 16, 64, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sddmm_and_stats_match_plain(cuda, d, dtype):
    for name, csr in _graphs(cuda).items():
        a, b, _ = _chain_operands(csr, d, 1, dtype)
        for tile in (32, 100, 512):
            bal = formats.csr_to_balanced(csr, tile)
            args = (bal.rows, bal.cols, a, b)
            e = fused_chain.sddmm_fused(*args, shape=csr.shape)
            assert _rel(e, fused_chain.sddmm_plain(*args, shape=csr.shape)) < 1e-4, name
            assert (e.reshape(-1)[csr.nnz:] == 0).all()
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
        with pytest.raises(NotImplementedError):
            A.chain(a, b, x.requires_grad_())



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
    with pytest.raises(NotImplementedError):
        repro_torch.sparse_attention(spec, q, k, v.requires_grad_(), cache=False)


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
    reset_launch_counts()
    with pytest.raises(ValueError):          # over the registers' 64 rows
        bsr.spmm_bsr(formats.csr_to_bsr(csr, 128, 8), x)
    with pytest.raises(ValueError):          # x of the wrong height
        bsr.spmm_bsr(b, x[1:])
    with pytest.raises(ValueError):          # no float64 kernel
        bsr.spmm_bsr(b, x.double())
    assert launch_counts()["bsr_spmm"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 32, 128, 200])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_cuda_spill_kernels_match_plain(cuda, n, xdtype):
    tol = 1e-4 if xdtype == torch.float32 else 2e-2
    for name, csr in _graphs(cuda).items():
        x = torch.randn(csr.shape[1], n, device=cuda).to(xdtype)
        for tile in (32, 100, 512):
            bal = formats.csr_to_balanced(csr, tile)
            base, win = vsr.SpillWindows()(bal)
            kw = dict(row_base=base, win=win)
            assert _rel(vsr.spmm_vsr_partials(bal, x, base, win),
                        vsr.spill_partials_plain(bal, x, base, win)) < tol, name
            assert _rel(vsr.spmm_vsr(bal, x, **kw),
                        vsr.spmm_vsr_spill_plain(bal, x, **kw)) < tol, name
            x1 = x[:, 0].contiguous()
            assert _rel(spmv.spmv_vsr_partials(bal, x1, base, win),
                        vsr.spill_partials_plain(bal, x1[:, None], base, win)[..., 0]
                        ) < tol, name
            assert _rel(spmv.spmv_vsr(bal, x1, **kw),
                        spmv.spmv_vsr_spill_plain(bal, x1, **kw)) < tol, name
    torch.cuda.synchronize()


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
            assert sum(launch_counts().values()) == 1
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
