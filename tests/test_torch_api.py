"""The slice as a whole: ``repro_torch.sparse(csr, device="cpu") @ x``
against ``repro.sparse(csr) @ x`` on the reference's Pallas backend (interpret
mode) and its xla backend, live value streams through the plan cache, and
the plan rules of the port (float32; rtol 1e-5, atol 1e-5 of the result's
largest magnitude — sums are reassociated)."""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.core import formats as ref_formats
from repro.core.rmat import rmat_suite_small as ref_suite
from repro.core.selector import SelectorThresholds as RefThresholds
import repro_torch
from repro_torch import api, interop
from repro_torch.core import formats, plan as plan_mod, registry
from repro_torch.core.cache import PlanCache, pattern_fingerprint
from repro_torch.core.selector import SelectorThresholds, TileGeometry, geometry_key

NS = (1, 4, 20, 128)


def _port(csr, data=None):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data if data is None else data),
                                   csr.shape)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    atol = 1e-5 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


SUITE = {k: v for k, v in ref_suite(seed=0).items() if "_s8_" in k}


@pytest.mark.parametrize("n", NS)
def test_slice_matches_reference_backends(n):
    rng = np.random.default_rng(n)
    cache = PlanCache()
    for name, csr in SUITE.items():
        x = rng.standard_normal((csr.shape[1], n)).astype(np.float32)
        xs = x[:, 0] if n == 1 else x
        A = repro_torch.sparse(_port(csr), device="cpu", cache=cache)
        assert A.backend == "torch"
        got = A @ torch.from_numpy(xs)
        hop = repro_torch.sparse(_port(csr), device="cpu", backend="hopper",
                                 cache=cache) @ torch.from_numpy(xs)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want_pallas = ref_api.sparse(csr, backend="pallas", cache=False) @ jnp.asarray(xs)
        want_xla = ref_api.sparse(csr, backend="xla", cache=False) @ jnp.asarray(xs)
        assert got.shape == tuple(want_xla.shape)
        _close(got, want_pallas)
        _close(got, want_xla)
        _close(hop, want_pallas)


@pytest.mark.parametrize("name,n", [("rmat_s8_e16_uniform", 20),   # rs_sr, ELL
                                    ("rmat_s8_e16_skewed", 20),    # nb_sr
                                    ("rmat_s8_e4_skewed", 1)])     # nb_pr, SpMV
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_cache_hit_streams_new_values(name, n, backend):
    csr = SUITE[name]
    cache = PlanCache()
    rng = np.random.default_rng(3)
    new = rng.standard_normal(csr.nnz).astype(np.float32)
    x = rng.standard_normal((csr.shape[1], n)).astype(np.float32)
    xs = torch.from_numpy(x[:, 0] if n == 1 else x)
    A = repro_torch.sparse(_port(csr), device="cpu", backend=backend, cache=cache)
    B = repro_torch.sparse(_port(csr, new), device="cpu", backend=backend, cache=cache)
    assert cache.stats()["hits"] == 1 and cache.stats()["builds"] == 1
    assert B.plan is A.plan and B._values is not None
    ref_new = ref_formats.CSR(csr.indptr, csr.indices, jnp.asarray(new), csr.shape)
    want = ref_api.sparse(ref_new, backend="xla", cache=False) @ jnp.asarray(xs.numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_pallas = (ref_api.sparse(ref_new, backend="pallas", cache=False)
                       @ jnp.asarray(xs.numpy()))
    _close(B @ xs, want)
    _close(B @ xs, want_pallas)
    _close(A.with_values(torch.from_numpy(new)) @ xs, want)
    # the same values again: the baked stream is used, no live copy
    C = repro_torch.sparse(_port(csr), device="cpu", backend=backend, cache=cache)
    assert C._values is None


def test_hopper_plan_keeps_backend_past_max_win():
    """The reference demotes pallas to xla when a tile spans more than
    max_win rows (a TPU spill-window limit); a hopper plan never demotes."""
    a = np.zeros((600, 40), np.float32)
    a[0, 3], a[500, 7], a[599, 1] = 1.0, 2.0, 3.0
    csr = ref_formats.csr_from_dense(a)
    th_r = RefThresholds(max_win=64)
    with pytest.warns(UserWarning):
        assert ref_api.sparse(csr, backend="pallas", thresholds=th_r,
                              cache=False).backend == "xla"
    th = interop.thresholds_from_json(th_r.to_json())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        A = repro_torch.sparse(_port(csr), device="cpu", backend="hopper",
                               thresholds=th, cache=False)
        assert A.backend == "hopper"
        p = plan_mod.plan(_port(csr), backend="hopper", thresholds=th)
        assert p.backend == "hopper"
        x = torch.randn(40, 5)
        _close(A @ x, torch.from_numpy(a) @ x)


def test_sparse_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csr = _port(SUITE["rmat_s8_e4_uniform"])
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.sparse(csr)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.sparse(csr, backend="hopper")
    with registry.backend_scope("torch"), pytest.raises(RuntimeError):
        repro_torch.sparse(csr)


def test_unported_arguments_raise():
    """No argument of the reference's plan() is refused now: a mesh plans
    on the sharded backend (tests/test_torch_shard.py), the shard arguments
    without one are ignored as the reference ignores them, and a sharded
    backend without a mesh is a usage error."""
    from repro_torch.launch import make_local_mesh
    csr = _port(SUITE["rmat_s8_e4_uniform"])
    p = plan_mod.plan(csr, mesh=make_local_mesh(4, 1, devices=["cpu"] * 4))
    assert (p.backend, p.inner_backend, p.shard_spec.n_shards) == (
        "sharded", "torch", 4)
    assert plan_mod.plan(csr, shard_axis="x").backend == "torch"
    with pytest.raises(ValueError, match="mesh"):
        plan_mod.plan(csr, backend="sharded")
    # the guardrails' arguments are ported (tests/test_torch_guardrails.py)
    assert plan_mod.plan(csr, sentinel="raise").sentinel == "raise"
    assert plan_mod.plan(csr, validate="repair").csr is csr
    # quantized value streams are ported (tests/test_torch_quant.py)
    assert plan_mod.plan(csr, quant="int8").quant == "int8"
    with pytest.raises(TypeError):
        plan_mod.plan(csr, bogus=1)


def test_lazy_substrates_and_n_hint():
    csr = _port(SUITE["rmat_s8_e16_uniform"])
    formats.reset_build_counts()
    A = repro_torch.sparse(csr, device="cpu", cache=False)
    assert A.plan.built_substrates == ()
    A @ torch.randn(csr.shape[1], 20)          # rs_sr: ELL only
    assert A.plan.built_substrates == ("ell",)
    B = repro_torch.sparse(csr, device="cpu", cache=False, n_hint=1)
    assert B.plan.built_substrates == ("balanced",)
    assert formats.reset_build_counts() == {"ell": 1, "balanced": 1, "bsr": 0}


def test_impl_and_backend_overrides():
    csr = SUITE["rmat_s8_e16_skewed"]
    x = np.random.default_rng(0).standard_normal((csr.shape[1], 6)).astype(np.float32)
    A = repro_torch.sparse(_port(csr), device="cpu", cache=False)
    want = ref_api.sparse(csr, backend="xla", cache=False) @ jnp.asarray(x)
    for impl in registry.MATMUL_KERNELS:
        for backend in (None, "torch", "hopper"):
            _close(A.matmul(torch.from_numpy(x), impl=impl, backend=backend), want)
    with pytest.raises(ValueError):
        A @ torch.randn(3, 2)
    with pytest.raises(ValueError):
        A.with_values(torch.randn(3))
    with pytest.raises(ValueError):
        A @ torch.randn(csr.shape[1], 2, device="meta")


def test_use_backend_and_cache_api():
    csr = _port(SUITE["rmat_s8_e4_skewed"])
    api.clear_cache()
    before = api.cache_stats()
    with repro_torch.use_backend("hopper"):
        A = repro_torch.sparse(csr, device="cpu")
    B = repro_torch.sparse(csr, device="cpu")
    assert (A.backend, B.backend) == ("hopper", "torch")
    after = api.cache_stats()
    assert after["builds"] - before["builds"] == 2
    repro_torch.sparse(csr, device="cpu")
    assert api.cache_stats()["hits"] - after["hits"] == 1
    api.clear_cache()
    assert api.cache_stats()["size"] == 0


def test_dense_inputs_and_repr():
    a = np.random.default_rng(1).standard_normal((12, 9)).astype(np.float32)
    a[a < 0.5] = 0
    A = repro_torch.sparse(torch.from_numpy(a), device="cpu", cache=False)
    Bm = repro_torch.sparse(a, device="cpu", cache=False)
    x = torch.randn(9, 4)
    _close(A @ x, torch.from_numpy(a) @ x)
    _close(Bm @ x, torch.from_numpy(a) @ x)
    assert A.shape == (12, 9) and A.nnz == int((a != 0).sum())
    assert "backend='torch'" in repr(A)
    with pytest.raises(ValueError):
        repro_torch.sparse(np.zeros(3), device="cpu")


def test_geometry_table_sets_tile():
    csr = _port(SUITE["rmat_s8_e4_skewed"])
    key = geometry_key("torch", pattern_fingerprint(csr), 4)
    th = SelectorThresholds().with_geometry(key, TileGeometry(64, 8, 128))
    A = repro_torch.sparse(csr, device="cpu", thresholds=th, n_hint=4, cache=False)
    assert A.plan.tile == 64
    assert A.plan.substrate("balanced").tile == 64
    x = torch.randn(csr.shape[1], 4)
    ref = SUITE["rmat_s8_e4_skewed"]
    _close(A @ x, ref_api.sparse(ref, backend="xla", cache=False) @ jnp.asarray(x.numpy()))
