"""Kernel modules of the port against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (its operands lie on
the CPU); those must match the TPU kernels run in interpret mode, as
``tests/test_kernels_pallas.py`` runs them: float32 at rtol 1e-5 with atol
1e-5 of the result's largest magnitude (sums are reassociated), bf16 x at
rtol 2e-2.  ``tests/test_torch_gpu.py`` holds each CUDA kernel against its
plain version on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import formats as ref_formats
from repro.core.rmat import rmat as ref_rmat
from repro.kernels import csc as ref_csc
from repro.kernels import spmv as ref_spmv
from repro.kernels import vsr as ref_vsr
from repro_torch import interop
from repro_torch.core import formats
from repro_torch.kernels import csc, launch_counts, reset_launch_counts, spmv, vsr

from conftest import random_csr


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _mats():
    rng = np.random.default_rng(21)
    out = {"skewed": ref_rmat(7, 8, seed=3),
           "uniform": ref_rmat(7, 8, 0.25, 0.25, 0.25, seed=4),
           "rand_100x80": random_csr(rng, 100, 80, 0.15)[0]}
    a = (rng.random((150, 60)) < 0.2) * rng.standard_normal((150, 60))
    a[20:110] = 0.0                     # an empty band of rows
    out["empty_band"] = ref_formats.csr_from_dense(a.astype(np.float32))
    return out


MATS = _mats()


def _close(got, want, rtol=1e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _x(rng, k, n, dtype=np.float32):
    x = rng.standard_normal((k, n) if n else (k,)).astype(np.float32)
    return x


@pytest.mark.parametrize("n", [4, 20, 128])
def test_vsr_plain_matches_pallas_fused(n):
    rng = np.random.default_rng(n)
    for name, csr in MATS.items():
        x = _x(rng, csr.shape[1], n)
        want = ref_vsr.spmm_vsr_fused(ref_formats.csr_to_balanced(csr, tile=128),
                                      jnp.asarray(x), interpret=True)
        got = vsr.spmm_vsr_fused(formats.csr_to_balanced(_port(csr), tile=128),
                                 torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
        _close(got, want)


def test_spmv_plain_matches_pallas_fused():
    rng = np.random.default_rng(1)
    for name, csr in MATS.items():
        x = _x(rng, csr.shape[1], 0)
        want = ref_spmv.spmv_vsr_fused(ref_formats.csr_to_balanced(csr, tile=128),
                                       jnp.asarray(x), interpret=True)
        got = spmv.spmv_vsr_fused(formats.csr_to_balanced(_port(csr), tile=128),
                                  torch.from_numpy(x))
        assert got.shape == tuple(want.shape)
        _close(got, want)


@pytest.mark.parametrize("n", [1, 4, 20, 128])
def test_csc_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    for name in ("uniform", "rand_100x80", "empty_band"):
        csr = MATS[name]
        x = _x(rng, csr.shape[1], n)
        xs = x[:, 0] if n == 1 else x
        want = ref_csc.spmm_csc(ref_formats.csr_to_ell(csr), jnp.asarray(xs),
                                interpret=True)
        got = csc.spmm_csc(formats.csr_to_ell(_port(csr)), torch.from_numpy(xs))
        assert got.shape == tuple(want.shape)
        _close(got, want)


def test_bf16_x_matches_pallas():
    rng = np.random.default_rng(2)
    csr = MATS["skewed"]
    x = _x(rng, csr.shape[1], 8)
    xb_j, xb_t = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    bal_r, bal_p = ref_formats.csr_to_balanced(csr, 64), formats.csr_to_balanced(_port(csr), 64)
    got = vsr.spmm_vsr_fused(bal_p, xb_t)
    assert got.dtype == torch.bfloat16
    _close(got, ref_vsr.spmm_vsr_fused(bal_r, xb_j, interpret=True), rtol=2e-2)
    _close(spmv.spmv_vsr_fused(bal_p, xb_t[:, 0].contiguous()),
           ref_spmv.spmv_vsr_fused(bal_r, xb_j[:, 0], interpret=True), rtol=2e-2)
    ell_r, ell_p = ref_formats.csr_to_ell(csr), formats.csr_to_ell(_port(csr))
    _close(csc.spmm_csc(ell_p, xb_t),
           ref_csc.spmm_csc(ell_r, xb_j, interpret=True), rtol=2e-2)


def test_cpu_wrappers_do_not_count_launches():
    reset_launch_counts()
    csr = _port(MATS["rand_100x80"])
    x = torch.randn(80, 3)
    vsr.spmm_vsr_fused(formats.csr_to_balanced(csr, 32), x)
    spmv.spmv_vsr_fused(formats.csr_to_balanced(csr, 32), x[:, 0].contiguous())
    csc.spmm_csc(formats.csr_to_ell(csr), x)
    assert launch_counts() == {"vsr_spmm": 0, "vsr_spmv": 0, "csc_spmm": 0,
                               "sddmm": 0, "chain_stats": 0, "chain": 0,
                               "attn_stats": 0, "attn_chain": 0,
                               "bsr_spmm": 0, "vsr_spmm_spill": 0,
                               "vsr_spmv_spill": 0, "spill_combine": 0}


def test_wrappers_reject_bad_operands():
    csr = _port(MATS["rand_100x80"])
    bal = formats.csr_to_balanced(csr, 32)
    with pytest.raises(ValueError):          # operands on two devices
        vsr.spmm_vsr_fused(bal, torch.randn(80, 3, device="meta"))
    with pytest.raises(ValueError):
        spmv.spmv_vsr_fused(bal, torch.randn(80, 3))


def test_vsr_routes_by_n():
    """A K1 call that names no design takes the pr design up to the
    selector's default ``n_threshold`` (4), the sr design above it."""
    assert [vsr._design(n) for n in (1, 2, 3, 4, 5, 8, 32, 128, 200)] \
        == ["pr"] * 4 + ["sr"] * 5


def _record_designs(monkeypatch):
    """Replace ``vsr.spmm_vsr_fused`` by a recorder of the design each call
    names (``None``: routed by N) that runs the plain version."""
    seen = []

    def fake(bal, x, design=None, *, scales=None):
        seen.append(design)
        return vsr.spmm_vsr_plain(bal, x, scales)
    monkeypatch.setattr(vsr, "spmm_vsr_fused", fake)
    return seen


def test_nb_registry_entries_name_their_design(monkeypatch):
    """``nb_sr`` launches K1's sr design and ``nb_pr`` its pr design,
    whatever N; an x of shape (K,) takes K2, as in the reference's
    ``_pallas_nb``."""
    from repro_torch.core import registry
    seen = _record_designs(monkeypatch)
    bal = formats.csr_to_balanced(_port(MATS["rand_100x80"]), 32)
    rng = np.random.default_rng(7)
    for logical, design in (("nb_sr", "sr"), ("nb_pr", "pr")):
        fn = registry.resolve(logical, "hopper").fn
        for n in (2, 4, 32):
            x = torch.from_numpy(_x(rng, 80, n))
            _close(fn(bal, x), vsr.spmm_vsr_plain(bal, x))
            assert seen.pop() == design, (logical, n)
        x1 = torch.from_numpy(_x(rng, 80, 0))
        _close(fn(bal, x1), spmv.spmv_vsr_plain(bal, x1))
        assert seen == [], logical


@pytest.mark.parametrize("n", [1, 4, 32])
def test_unfused_pairs_route_by_n(monkeypatch, n):
    """The unfused chain and attention pairs call the nnz-balanced product
    routed by N (a GAT layer at N = 32 and an attention head at d = 256
    keep the sr design): K1 with no design named, K2 for an x of shape
    (K,)."""
    from repro_torch.kernels import attention, fused_chain
    seen = _record_designs(monkeypatch)
    csr = _port(MATS["skewed"])
    bal = formats.csr_to_balanced(csr, 64)
    rng = np.random.default_rng(n)
    a, b = (torch.from_numpy(0.3 * _x(rng, k, 8)) for k in csr.shape)
    x = torch.from_numpy(_x(rng, csr.shape[1], n if n > 1 else 0))
    pat = (bal.rows, bal.cols, a, b)
    for transform in ("identity", "softmax"):
        kw = dict(shape=csr.shape, transform=transform, alpha=0.5)
        _close(fused_chain.chain_unfused(*pat, x, **kw),
               fused_chain.chain_plain(*pat, x, **kw))
    bias = torch.from_numpy(_x(rng, bal.rows.numel(), 0)).reshape(bal.rows.shape)
    _close(attention.attn_unfused(*pat, bias, x, shape=csr.shape, scale=0.5),
           attention.attn_chain_plain(*pat, bias, x, shape=csr.shape, scale=0.5))
    assert seen == ([] if n == 1 else [None] * 3)


def test_plain_nb_nonfinite_x_stays_in_its_rows():
    """inf and NaN rows of X reach only the output rows that gather them,
    as the reference's ``"xla"`` backend gives, for K1 (both logical
    kernels) and K2.  The reference's Pallas K1 reduces a tile by a
    one-hot matrix product, so there a NaN reaches every row of its output
    block (a caveat of the reference, kept as it is)."""
    import repro.api as ref_api
    csr = MATS["skewed"]
    rng = np.random.default_rng(3)
    x = _x(rng, csr.shape[1], 4)
    x[5] = np.nan
    x[9, 1:3] = np.inf
    x[11, 0] = -np.inf
    A = ref_api.sparse(csr, backend="xla")
    bal = formats.csr_to_balanced(_port(csr), tile=128)
    for impl in ("nb_sr", "nb_pr"):
        for xs, got in ((x, vsr.spmm_vsr_fused(bal, torch.from_numpy(x))),
                        (x[:, 0].copy(), spmv.spmv_vsr_fused(
                            bal, torch.from_numpy(x[:, 0].copy())))):
            want = np.asarray(A.matmul(jnp.asarray(xs), impl=impl))
            got = got.numpy()
            assert 0 < int(np.isnan(want).sum()) < want.size // 4
            for test in (np.isnan, np.isposinf, np.isneginf):
                assert np.array_equal(test(got), test(want)), (impl, test)
            fin = np.isfinite(want)
            _close(got[fin], want[fin])
    pallas = np.asarray(ref_vsr.spmm_vsr_fused(
        ref_formats.csr_to_balanced(csr, tile=128), jnp.asarray(x),
        interpret=True))
    assert np.isnan(pallas).sum() > np.isnan(np.asarray(A @ jnp.asarray(x))).sum()
