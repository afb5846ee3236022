"""The spill-and-combine path of the port (K4, K5) against the reference.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``: the
reference's Pallas spill kernels (``spmm_vsr`` / ``spmv_vsr``) run in
interpret mode, as ``tests/test_kernels_pallas.py`` and
``tests/test_spill_fusion.py`` run them.  On the CPU the port's wrappers run
their plain versions.  float32 at rtol 1e-5 with atol 1e-5 of the result's
largest magnitude (sums are reassociated); windows are element-equal.
``tests/test_torch_gpu.py`` holds the CUDA kernels against the plain
versions on the card."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import formats as ref_formats
from repro.core.plan import execute as ref_execute, plan as ref_plan
from repro.core.rmat import rmat as ref_rmat
from repro.kernels import spmv as ref_spmv
from repro.kernels import vsr as ref_vsr
import repro_torch
from repro_torch import interop
from repro_torch.core import formats, plan as plan_mod, registry
from repro_torch.kernels import launch_counts, reset_launch_counts, spmv, vsr

from conftest import random_csr


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _close(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    atol = 1e-5 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def _mats():
    """Rows crossing tiles (a skewed R-MAT's hub rows), empty-row bands
    (``test_spill_fusion.py``'s), a single row, and sentinel padding in the
    last tile of each (nnz is no multiple of the tiles used)."""
    rng = np.random.default_rng(4)
    out = {"skewed": ref_rmat(6, 8, seed=3),
           "rand_100x80": random_csr(rng, 100, 80, 0.15)[0]}
    a = np.zeros((48, 40), np.float32)
    a[1, :7] = rng.standard_normal(7)
    a[30, 5] = 2.5                                    # rows 2..29 empty
    a[45:, :] = (rng.random((3, 40)) < 0.3) * rng.standard_normal((3, 40))
    out["empty_rows"] = ref_formats.csr_from_dense(a)
    b = ((rng.random((1, 40)) < 0.5) * rng.standard_normal((1, 40))).astype(np.float32)
    out["single_row"] = ref_formats.csr_from_dense(b)
    return out


MATS = _mats()


def _windows(bal_r, bal_p):
    base, win = ref_vsr.plan_windows(bal_r)
    got_base, got_win = vsr.SpillWindows()(bal_p)
    assert got_win == win and got_base.dtype == torch.int32
    np.testing.assert_array_equal(got_base.numpy(), base)
    return got_base, win


@pytest.mark.parametrize("n", [4, 7, 128])
@pytest.mark.parametrize("tile", [32, 64])
def test_plain_k4_matches_pallas_spill(n, tile):
    rng = np.random.default_rng(n + tile)
    for name, csr in MATS.items():
        bal_r = ref_formats.csr_to_balanced(csr, tile=tile)
        bal_p = formats.csr_to_balanced(_port(csr), tile=tile)
        base, win = _windows(bal_r, bal_p)
        x = rng.standard_normal((csr.shape[1], n)).astype(np.float32)
        want = ref_vsr.spmm_vsr(bal_r, jnp.asarray(x), interpret=True)
        for kw in ({}, {"row_base": base, "win": win}):
            got = vsr.spmm_vsr(bal_p, torch.from_numpy(x), **kw)
            assert got.shape == tuple(want.shape) and got.dtype == torch.float32
            _close(got, want)
        _close(vsr.spmm_vsr_spill_plain(bal_p, torch.from_numpy(x)), want)
        # the partials: every row of a tile's window at row - row_base
        part = vsr.spmm_vsr_partials(bal_p, torch.from_numpy(x), base, win)
        assert part.shape == (bal_p.n_tiles, win, n)
        _close(vsr.spill_combine(part, base, csr.shape[0]), want)


@pytest.mark.parametrize("tile", [32, 64, 128])
def test_plain_k5_matches_pallas_spill(tile):
    rng = np.random.default_rng(tile)
    for name, csr in MATS.items():
        bal_r = ref_formats.csr_to_balanced(csr, tile=tile)
        bal_p = formats.csr_to_balanced(_port(csr), tile=tile)
        base, win = _windows(bal_r, bal_p)
        x = rng.standard_normal(csr.shape[1]).astype(np.float32)
        want = ref_spmv.spmv_vsr(bal_r, jnp.asarray(x), interpret=True)
        for kw in ({}, {"row_base": base, "win": win}):
            got = spmv.spmv_vsr(bal_p, torch.from_numpy(x), **kw)
            assert got.shape == tuple(want.shape)
            _close(got, want)
        _close(spmv.spmv_vsr_spill_plain(bal_p, torch.from_numpy(x)), want)
        assert spmv.spmv_vsr_partials(bal_p, torch.from_numpy(x), base,
                                      win).shape == (bal_p.n_tiles, win)
    with pytest.raises(ValueError):
        spmv.spmv_vsr(bal_p, torch.randn(csr.shape[1], 2))


def test_plain_spill_bf16_x():
    rng = np.random.default_rng(2)
    csr = MATS["skewed"]
    x = rng.standard_normal((csr.shape[1], 8)).astype(np.float32)
    bal_r, bal_p = ref_formats.csr_to_balanced(csr, 64), formats.csr_to_balanced(_port(csr), 64)
    got = vsr.spmm_vsr(bal_p, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = ref_vsr.spmm_vsr(bal_r, jnp.asarray(x, jnp.bfloat16), interpret=True)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 7])
def test_execute_spill_matches_reference_pallas(n):
    """The spill opt flipped in both packages' NB kernel opts
    (``tests/test_sharded_fused.py:58``): the reference's pallas plan in
    interpret mode, the port's hopper plan on the plain versions."""
    rng = np.random.default_rng(n)
    for name, csr in MATS.items():
        rp = ref_plan(csr, backend="pallas", tile=64)
        ref_opts = rp.kernel_opts(rp.entry("nb_pr"))
        ref_opts["spill"] = True
        pp = plan_mod.plan(_port(csr), backend="hopper", tile=64)
        opts = pp.kernel_opts(pp.entry("nb_pr"))
        assert set(opts) == {"windows"} and opts["windows"]._value is None
        opts["spill"] = True
        xs = rng.standard_normal((csr.shape[1], n)).astype(np.float32)
        x = xs[:, 0] if n == 1 else xs
        want = ref_execute(rp, jnp.asarray(x), impl="nb_pr", interpret=True)
        got = plan_mod.execute(pp, torch.from_numpy(x), impl="nb_pr")
        assert got.shape == tuple(want.shape)
        _close(got, want)
        # the windows were computed once, by the spill call, and kept
        base, win = opts["windows"]._value
        np.testing.assert_array_equal(base.numpy(),
                                      np.asarray(ref_opts["row_base"]))
        assert win == ref_opts["win"]


def test_fused_path_does_not_scan_windows():
    pp = plan_mod.plan(_port(MATS["skewed"]), backend="hopper", tile=64)
    x = torch.randn(pp.csr.shape[1], 5)
    plan_mod.execute(pp, x, impl="nb_pr")
    assert pp.kernel_opts(pp.entry("nb_pr"))["windows"]._value is None


def test_torch_entries_ignore_spill_opts():
    rng = np.random.default_rng(0)
    csr = MATS["rand_100x80"]
    x = rng.standard_normal((80, 6)).astype(np.float32)
    want = np.asarray(csr.to_dense()) @ x
    pp = plan_mod.plan(_port(csr), backend="torch", tile=64)
    for impl in registry.MATMUL_KERNELS:
        pp.kernel_opts(pp.entry(impl))["spill"] = True
        _close(plan_mod.execute(pp, torch.from_numpy(x), impl=impl), want)


@pytest.mark.parametrize("with_windows", [False, True])
def test_spmm_as_n_spmv_matches_pallas(with_windows):
    rng = np.random.default_rng(9)
    for name, csr in MATS.items():
        bal_r = ref_formats.csr_to_balanced(csr, tile=64)
        bal_p = formats.csr_to_balanced(_port(csr), tile=64)
        x = rng.standard_normal((csr.shape[1], 4)).astype(np.float32)
        if with_windows:
            base, win = ref_vsr.plan_windows(bal_r)
            want = ref_vsr.spmm_as_n_spmv_pallas(bal_r, jnp.asarray(x), interpret=True,
                                                 row_base=jnp.asarray(base), win=win)
            kw = {"row_base": torch.from_numpy(base), "win": win}
        else:
            want = ref_vsr.spmm_as_n_spmv_pallas(bal_r, jnp.asarray(x), interpret=True)
            kw = {}
        reset_launch_counts()
        got = vsr.spmm_as_n_spmv_hopper(bal_p, torch.from_numpy(x), **kw)
        assert got.shape == tuple(want.shape)
        assert sum(launch_counts().values()) == 0          # the CPU: plain versions
        _close(got, want)
        one = vsr.spmm_as_n_spmv_hopper(bal_p, torch.from_numpy(x[:, 0].copy()), **kw)
        assert one.shape == (csr.shape[0],)
        _close(one, np.asarray(want)[:, 0])


def test_spill_refuses_window_past_max_win():
    """The reference demotes such a plan to xla at plan time, so its spill
    kernel never runs on it; the port's spill call raises, naming the span,
    and runs nothing in its place.  The fused path takes the plan."""
    a = np.zeros((600, 40), np.float32)
    a[0, 3], a[500, 7], a[599, 1] = 1.0, 2.0, 3.0
    th = dataclasses.replace(repro_torch.SelectorThresholds(), max_win=64)
    A = repro_torch.sparse(formats.csr_from_dense(a), device="cpu",
                           backend="hopper", thresholds=th, cache=False)
    x = torch.randn(40, 8)
    want = A @ x
    A.plan.kernel_opts(A.plan.entry("nb_pr"))["spill"] = True
    for xx in (x, x[:, 0].contiguous()):
        with pytest.raises(ValueError, match="spans 600 rows.*max_win=64"):
            A.matmul(xx, impl="nb_pr")
    # the same window within the limit runs the spill path
    A2 = repro_torch.sparse(formats.csr_from_dense(a), device="cpu",
                            backend="hopper", cache=False)
    A2.plan.kernel_opts(A2.plan.entry("nb_pr"))["spill"] = True
    _close(A2.matmul(x, impl="nb_pr"), want.numpy())


def test_spill_refuses_grad():
    A = repro_torch.sparse(_port(MATS["rand_100x80"]), device="cpu",
                           backend="hopper", cache=False)
    A.plan.kernel_opts(A.plan.entry("nb_pr"))["spill"] = True
    with pytest.raises(NotImplementedError, match="VJP"):
        A.matmul(torch.randn(80, 3, requires_grad=True), impl="nb_pr")
    with pytest.raises(NotImplementedError, match="VJP"):
        A.with_values(torch.ones(A.nnz, requires_grad=True)).matmul(
            torch.randn(80), impl="nb_pr")
    with torch.no_grad():
        y = A.matmul(torch.randn(80, 3, requires_grad=True), impl="nb_pr")
    assert not y.requires_grad
