"""The block-granule ``"bsr"`` backend of the port against the reference.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``.
Host structures (``csr_to_bsr``, ``bsr_to_dense``, the block-ELL layout and
its gather map, ``bsr_map`` / ``bsr_brow``) must be element-equal.  Products
are float32 at rtol 1e-5 with atol 1e-5 of the result's largest magnitude
(the port sums a block row in another order).  On the CPU K11's wrapper runs
its plain version; ``tests/test_torch_gpu.py`` holds the CUDA kernel against
it on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.core import formats as ref_formats
from repro.core.plan import execute as ref_execute, plan as ref_plan
from repro.kernels import bsr as ref_bsr
import repro_torch
from repro_torch import interop
from repro_torch.core import formats, plan as plan_mod, registry
from repro_torch.core.cache import PlanCache
from repro_torch.kernels import bsr, launch_counts, reset_launch_counts

from conftest import random_csr

BLOCKS = [(8, 16), (8, 128), (16, 64)]


def _port(csr, data=None):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data if data is None else data),
                                   csr.shape)


def _close(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    atol = 1e-5 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _mats():
    """Ragged shapes, an empty band of rows, duplicate (row, col) entries,
    and nnz = 0 — each as the reference's CSR."""
    rng = np.random.default_rng(14)
    out = {"rand_33x70": random_csr(rng, 33, 70, 0.08)[0],
           "rand_100x80": random_csr(rng, 100, 80, 0.15)[0]}
    a = (rng.random((120, 300)) < 0.1) * rng.standard_normal((120, 300))
    a[17:90] = 0.0                                  # empty rows and block rows
    out["empty_band"] = ref_formats.csr_from_dense(a.astype(np.float32))
    # duplicates: row 0 holds column 5 three times, row 2 column 130 twice
    indptr = np.array([0, 4, 4, 6, 7], np.int32)
    indices = np.array([5, 5, 9, 5, 130, 130, 1], np.int32)
    data = rng.standard_normal(7).astype(np.float32)
    out["duplicates"] = ref_formats.CSR(jnp.asarray(indptr), jnp.asarray(indices),
                                        jnp.asarray(data), (4, 140))
    out["nnz0"] = ref_formats.csr_from_dense(np.zeros((9, 6), np.float32))
    return out


MATS = _mats()


@pytest.mark.parametrize("block", BLOCKS)
def test_csr_to_bsr_and_dense_equal_reference(block):
    for name, csr in MATS.items():
        want = ref_formats.csr_to_bsr(csr, *block)
        got = formats.csr_to_bsr(_port(csr), *block)
        assert got.block_shape == tuple(want.block_shape) and got.shape == csr.shape
        assert got.nblocks == want.nblocks, name
        assert got.indptr.dtype == got.indices.dtype == torch.int32
        _equal(got.indptr, want.indptr)
        _equal(got.indices, want.indices)
        _equal(got.blocks, want.blocks)
        _equal(formats.bsr_to_dense(got), ref_formats.bsr_to_dense(want))


def test_bsr_build_counts_and_roundtrip(rng):
    csr, a = random_csr(rng, 33, 70, 0.08)
    formats.reset_build_counts()
    b = formats.csr_to_bsr(_port(csr), bm=8, bk=16)
    assert formats.reset_build_counts() == {"ell": 0, "balanced": 0, "bsr": 1}
    np.testing.assert_allclose(formats.bsr_to_dense(b).numpy(), a, atol=1e-6)


@pytest.mark.parametrize("block", BLOCKS)
def test_blockell_and_prep_bell_equal_reference(block):
    for name, csr in MATS.items():
        rb, pb = ref_formats.csr_to_bsr(csr, *block), formats.csr_to_bsr(_port(csr), *block)
        want_blocks, want_bcols, want_wb = ref_bsr.bsr_to_blockell(rb)
        blocks, bcols, wb = bsr.bsr_to_blockell(pb)
        assert wb == want_wb, name
        _equal(blocks, want_blocks)
        _equal(bcols, want_bcols)
        assert bcols.dtype == torch.int32
        want = ref_bsr._prep_bell(rb)
        got = bsr._prep_bell(pb)
        assert got["blockell"][2] == want["blockell"][2]
        for i in (0, 1):
            _equal(got["blockell"][i], want["blockell"][i])
        _equal(got["bell_src"], want["bell_src"])
        _equal(got["bell_valid"], want["bell_valid"])


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("n", [0, 1, 20])
def test_plain_k11_matches_pallas(block, n):
    """``test_kernels_pallas.py::test_bsr_sweep``'s shapes and densities,
    with a 1-D x (n = 0) and 2-D x."""
    rng = np.random.default_rng(n)
    for m, k in ((64, 300), (100, 80)):
        for density in (0.05, 0.3):
            csr, _ = random_csr(rng, m, k, density)
            x = rng.standard_normal((k, n) if n else (k,)).astype(np.float32)
            want = ref_bsr.spmm_bsr(ref_formats.csr_to_bsr(csr, *block),
                                    jnp.asarray(x), interpret=True)
            got = bsr.spmm_bsr(formats.csr_to_bsr(_port(csr), *block),
                               torch.from_numpy(x))
            assert got.shape == tuple(want.shape) and got.dtype == torch.float32
            _close(got, want)
    for name in ("empty_band", "duplicates", "nnz0"):
        csr = MATS[name]
        x = rng.standard_normal((csr.shape[1], max(n, 1))).astype(np.float32)
        got = bsr.spmm_bsr_plain(formats.csr_to_bsr(_port(csr), *block),
                                 torch.from_numpy(x))
        _close(got, np.asarray(ref_formats.bsr_to_dense(
            ref_formats.csr_to_bsr(MATS[name], *block))) @ x)


def test_plain_k11_bf16_x():
    rng = np.random.default_rng(3)
    csr = MATS["rand_100x80"]
    x = rng.standard_normal((80, 8)).astype(np.float32)
    want = ref_bsr.spmm_bsr(ref_formats.csr_to_bsr(csr, 8, 16),
                            jnp.asarray(x, jnp.bfloat16), interpret=True)
    got = bsr.spmm_bsr(formats.csr_to_bsr(_port(csr), 8, 16),
                       torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("block", [(8, 16), (16, 64)])
def test_execute_bsr_matches_reference(block):
    """``tests/test_plan.py::test_backend_override_and_bsr_forward`` on both
    packages: baked values and a live stream of twice the values."""
    rng = np.random.default_rng(7)
    for name, csr in MATS.items():
        x = rng.standard_normal((csr.shape[1], 8)).astype(np.float32)
        rp = ref_plan(csr, bsr_block=block)
        pp = plan_mod.plan(_port(csr), bsr_block=block)
        assert pp.backend == "torch" and pp.bsr_block == block
        for vals in (None, 2 * np.asarray(csr.data)):
            want = ref_execute(rp, jnp.asarray(x), backend="bsr", interpret=True,
                               vals=None if vals is None else jnp.asarray(vals))
            got = plan_mod.execute(pp, torch.from_numpy(x), backend="bsr",
                                   vals=None if vals is None else torch.from_numpy(vals))
            _close(got, want)
        _equal(pp.bsr_map(), rp.bsr_map())
        _equal(pp.bsr_brow(), rp.bsr_brow())
        assert pp.bsr_map().dtype == pp.bsr_brow().dtype == torch.int32
        assert pp.built_substrates == ("bsr",)


def test_bsr_backend_registry():
    entries = {registry.resolve(k, "bsr") for k in registry.MATMUL_KERNELS}
    assert len(entries) == 4
    assert {e.fn for e in entries} == {bsr._bsr_entry}
    assert {e.substrate for e in entries} == {"bsr"}
    assert "bsr" in registry.SUBSTRATES
    assert {e.logical for e in registry.available("bsr")} == set(registry.MATMUL_KERNELS)


@pytest.mark.parametrize("block", BLOCKS)
def test_sparse_bsr_facade_matches_reference(block):
    rng = np.random.default_rng(11)
    for name in ("rand_100x80", "empty_band", "duplicates"):
        csr = MATS[name]
        x = rng.standard_normal((csr.shape[1], 5)).astype(np.float32)
        want = ref_api.sparse(csr, backend="bsr", bsr_block=block,
                              cache=False) @ jnp.asarray(x)
        A = repro_torch.sparse(_port(csr), device="cpu", backend="bsr",
                               bsr_block=block, cache=False)
        assert A.backend == "bsr"
        _close(A @ torch.from_numpy(x), want)
        for impl in registry.MATMUL_KERNELS:
            _close(A.matmul(torch.from_numpy(x), impl=impl), want)
        _close(A.matmul(torch.from_numpy(x[:, 0].copy())), np.asarray(want)[:, 0])
        # the same plan on the plain backend for one call
        _close(A.matmul(torch.from_numpy(x), backend="torch"), want)


def test_bsr_plan_cache():
    csr = MATS["rand_100x80"]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((80, 6)).astype(np.float32))
    cache = PlanCache()
    formats.reset_build_counts()
    A = repro_torch.sparse(_port(csr), device="cpu", backend="bsr", cache=cache)
    y = A @ x
    B = repro_torch.sparse(_port(csr), device="cpu", backend="bsr",
                           bsr_block=(8, 128), cache=cache)
    assert B.plan is A.plan and cache.stats()["hits"] == 1
    C = repro_torch.sparse(_port(csr), device="cpu", backend="bsr",
                           bsr_block=(16, 64), cache=cache)
    assert C.plan is not A.plan and C.plan.bsr_block == (16, 64)
    assert cache.stats()["builds"] == 2
    _close(C @ x, y)
    # a hit with new values streams them
    new = rng.standard_normal(csr.nnz).astype(np.float32)
    D = repro_torch.sparse(_port(csr, new), device="cpu", backend="bsr", cache=cache)
    assert D.plan is A.plan and D._values is not None
    want = ref_api.sparse(ref_formats.CSR(csr.indptr, csr.indices, jnp.asarray(new),
                                          csr.shape), backend="bsr",
                          cache=False) @ jnp.asarray(x.numpy())
    _close(D @ x, want)
    _close(A.with_values(torch.from_numpy(new)) @ x, want)
    # only the BSR substrate was ever built, once per plan
    assert formats.reset_build_counts() == {"ell": 0, "balanced": 0, "bsr": 2}
    assert A.plan.built_substrates == ("bsr",)


def test_bsr_cpu_does_not_count_launches_and_gives_grads():
    """No launch is counted on the CPU, forward or backward; the calls the
    refusal made before the block family's backward (x or the live stream
    requiring grad) give the dense product's grads
    (``tests/test_torch_bsr_grads.py`` holds the whole backward)."""
    csr = _port(MATS["rand_100x80"])
    A = repro_torch.sparse(csr, device="cpu", backend="bsr", cache=False)
    reset_launch_counts()
    A @ torch.randn(80, 3)
    dense = formats.bsr_to_dense(A.plan.substrate("bsr")).float()
    x = torch.randn(80, 3, requires_grad=True)
    v = torch.ones(A.nnz, requires_grad=True)
    (A @ x).sum().backward()
    torch.testing.assert_close(x.grad, dense.sum(0)[:, None].expand(80, 3))
    xv = torch.randn(80, 3)
    (A.with_values(v) @ xv).sum().backward()
    torch.testing.assert_close(v.grad, xv.sum(1)[csr.indices.long()])
    assert launch_counts()["bsr_spmm"] == 0
    with pytest.raises(ValueError):          # operands on two devices
        bsr.spmm_bsr(A.plan.substrate("bsr"), torch.randn(80, 3, device="meta"))
    with pytest.raises(ValueError):
        plan_mod.plan(csr, bsr_block=(0, 16))
