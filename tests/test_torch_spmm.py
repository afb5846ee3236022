"""Port vs reference: the plain ``"torch"`` backend against the reference's
``xla`` lowerings, and the port's oracles against the reference's, on the
same substrates and dense operands (float32; sums are reassociated, so the
tolerance is rtol 1e-5 with atol 1e-5 of the result's largest magnitude)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import formats as ref_formats
from repro.core import registry as ref_registry
from repro.core import spmm as ref_spmm
from repro.kernels import ref as ref_oracles
from repro_torch import interop
from repro_torch.core import formats, registry, spmm
from repro_torch.kernels import ref

from conftest import random_csr

NS = (1, 4, 20, 128)
KERNELS = ("rs_sr", "rs_pr", "nb_sr", "nb_pr")


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _mats():
    """The whole small R-MAT suite, random_csr shapes of the reference's
    tests, an empty band of rows, and nnz = 0."""
    from repro.core.rmat import rmat_suite_small
    rng = np.random.default_rng(11)
    out = dict(rmat_suite_small(seed=0))
    out["rand_100x80"] = random_csr(rng, 100, 80, 0.15)[0]
    out["rand_257x129"] = random_csr(rng, 257, 129, 0.02)[0]
    a = (rng.random((120, 70)) < 0.2) * rng.standard_normal((120, 70))
    a[30:90] = 0.0                      # an empty band of rows
    out["empty_band"] = ref_formats.csr_from_dense(a.astype(np.float32))
    out["nnz0"] = ref_formats.csr_from_dense(np.zeros((9, 6), np.float32))
    return out


MATS = _mats()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("n", NS)
def test_torch_backend_matches_xla(kernel, n):
    rng = np.random.default_rng(n)
    for name, csr in MATS.items():
        xs = rng.standard_normal((csr.shape[1], n)).astype(np.float32)
        x = xs[:, 0] if n == 1 else xs
        ref_entry = ref_registry.resolve(kernel, "xla")
        ent = registry.resolve(kernel, "torch")
        p = _port(csr)
        if ent.substrate == "ell":
            sub_r, sub_p = ref_formats.csr_to_ell(csr), formats.csr_to_ell(p)
        else:
            sub_r = ref_formats.csr_to_balanced(csr, tile=64)
            sub_p = formats.csr_to_balanced(p, tile=64)
        want = ref_entry.fn(sub_r, jnp.asarray(x))
        got = ent.fn(sub_p, torch.from_numpy(x))
        assert got.shape == tuple(want.shape), name
        _close(got, want)


def test_empty_matrix_all_kernels():
    p = _port(MATS["nnz0"])
    x = torch.randn(6, 3)
    for kernel in KERNELS:
        ent = registry.resolve(kernel, "torch")
        sub = (formats.csr_to_ell(p) if ent.substrate == "ell"
               else formats.csr_to_balanced(p, tile=8))
        y = ent.fn(sub, x)
        assert y.shape == (9, 3) and not y.any()


def test_rs_pr_slab_chunking_matches_unchunked():
    csr = MATS["rmat_s8_e16_skewed"]
    ell = formats.csr_to_ell(_port(csr))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (csr.shape[1], 5)).astype(np.float32))
    whole = spmm.spmm_rs_pr(ell, x)
    for budget in (1, 1000, ell.width * 256 * 5 - 1):
        _close(spmm.spmm_rs_pr(ell, x, slab_elems=budget), whole)


def test_nb_sr_slabs_match_nb_pr(monkeypatch):
    csr = MATS["rmat_s8_e16_skewed"]
    bal = formats.csr_to_balanced(_port(csr), tile=32)
    x = torch.randn(csr.shape[1], 7)
    monkeypatch.setattr(spmm, "RS_PR_SLAB_ELEMS", 32 * 7 * 3)   # 3 tiles a slab
    _close(spmm.spmm_nb_sr(bal, x), spmm.spmm_nb_pr(bal, x))


def test_as_n_spmv_matches_reference():
    csr = MATS["rand_100x80"]
    x = np.random.default_rng(5).standard_normal((80, 6)).astype(np.float32)
    want = ref_spmm.spmm_as_n_spmv(ref_formats.csr_to_balanced(csr, tile=32),
                                   jnp.asarray(x))
    got = spmm.spmm_as_n_spmv(formats.csr_to_balanced(_port(csr), tile=32),
                              torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_bf16_operands_accumulate_in_f32(xdtype):
    csr = MATS["rand_100x80"]
    bal = formats.csr_to_balanced(_port(csr), tile=64)
    x = torch.randn(80, 4).to(xdtype)
    y = spmm.spmm_nb_pr(bal, x)
    assert y.dtype == xdtype
    want = ref.ref_spmm_balanced(bal, x)
    np.testing.assert_allclose(y.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2 * float(want.float().abs().max()))


def test_linearity():
    csr = MATS["rmat_s8_e4_skewed"]
    p = _port(csr)
    rng = np.random.default_rng(9)
    x1, x2 = (torch.from_numpy(rng.standard_normal((csr.shape[1], 3)).astype(np.float32))
              for _ in range(2))
    for kernel in KERNELS:
        ent = registry.resolve(kernel, "torch")
        sub = (formats.csr_to_ell(p) if ent.substrate == "ell"
               else formats.csr_to_balanced(p, tile=64))
        _close(ent.fn(sub, 2 * x1 - x2), 2 * ent.fn(sub, x1) - ent.fn(sub, x2))


@pytest.mark.parametrize("n", [1, 20])
def test_oracles_match_reference(n):
    rng = np.random.default_rng(n)
    for name in ("rmat_s8_e16_skewed", "rand_100x80", "empty_band", "nnz0"):
        csr = MATS[name]
        x = rng.standard_normal((csr.shape[1], n)).astype(np.float32)
        xs = x[:, 0] if n == 1 else x
        p = _port(csr)
        xt, xj = torch.from_numpy(xs), jnp.asarray(xs)
        _close(ref.ref_spmm_csr(p, xt), ref_oracles.ref_spmm_csr(csr, xj))
        _close(ref.ref_spmm_ell(formats.csr_to_ell(p), xt),
               ref_oracles.ref_spmm_ell(ref_formats.csr_to_ell(csr), xj))
        _close(ref.ref_spmm_balanced(formats.csr_to_balanced(p, 16), xt),
               ref_oracles.ref_spmm_balanced(ref_formats.csr_to_balanced(csr, 16), xj))
    seg = np.array([0, 0, 2, 1, 2], np.int32)
    vals = np.arange(10, dtype=np.float32).reshape(5, 2)
    _close(ref.ref_segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg), 4),
           ref_oracles.ref_segment_reduce(jnp.asarray(vals), jnp.asarray(seg), 4))


def test_registry_rules():
    assert {e.logical for e in registry.available("torch")} == set(registry.LOGICAL_KERNELS)
    with pytest.raises(ValueError):
        registry.register("nope", "torch", "ell", spmm.spmm_rs_sr)
    with pytest.raises(KeyError):
        registry.resolve("nb_pr", "no-such-backend")
    assert registry.default_backend("cpu") == "torch"
    assert registry.default_backend("cuda") == "hopper"
    with registry.backend_scope("torch"):
        assert registry.default_backend("cuda") == "torch"
        with registry.backend_scope(None):
            assert registry.scoped_backend() == "torch"
    assert registry.scoped_backend() is None
