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
    """Before the backward, the spill path refused operands that require
    grad; it now gets the balanced family's backward (the spill forward,
    then K6 and the transposed plan), as the reference's spill kernels sit
    behind its ``_exec_balanced``: its grads are those of the "torch"
    backend."""
    A = repro_torch.sparse(_port(MATS["rand_100x80"]), device="cpu",
                           backend="hopper", cache=False)
    A.plan.kernel_opts(A.plan.entry("nb_pr"))["spill"] = True
    T = repro_torch.sparse(_port(MATS["rand_100x80"]), device="cpu",
                           backend="torch", cache=False)
    x = torch.randn(80, 3)
    grads = []
    for M in (A, T):
        xg = x.clone().requires_grad_()
        v = torch.ones(M.nnz, requires_grad=True)
        (M.with_values(v).matmul(xg, impl="nb_pr") ** 2).sum().backward()
        grads.append((v.grad, xg.grad))
    for got, want in zip(*grads):
        _close(got, want.numpy())
    with torch.no_grad():
        y = A.matmul(torch.randn(80, 3, requires_grad=True), impl="nb_pr")
    assert not y.requires_grad


# ---------------------------------------------------------------------------
# a window narrower than a tile's span (fault 3.4) and non-finite X
# ---------------------------------------------------------------------------

def _fault_34():
    """12×6, one nonzero on each of rows 0-7 (column i % 6; value 1, row
    7's 6), rows 8-11 empty: one tile of 8 slots spanning 8 rows."""
    a = np.zeros((12, 6), np.float32)
    for i in range(8):
        a[i, i % 6] = 6.0 if i == 7 else 1.0
    return ref_formats.csr_from_dense(a)


def _narrow_cases():
    """(name, csr, tile, win): the fault's matrix at win 2, and a random
    matrix of ~2 nonzeros a row whose tiles of 32 span ~16 rows, at win 8."""
    rng = np.random.default_rng(34)
    rand = random_csr(rng, 200, 60, 0.035)[0]
    return (("fault_34", _fault_34(), 8, 2), ("rand_t32", rand, 32, 8))


def _clamped_windows(csr, tile, base, win):
    """The partials in numpy: tile t's window row min(max(r - base[t], 0),
    win - 1) holds the sum of its slots' v·X[c], runs clamped onto one
    window row added."""
    bal = ref_formats.csr_to_balanced(csr, tile=tile)
    rows, cols, vals = (np.asarray(a) for a in (bal.rows, bal.cols, bal.vals))

    def windows(x2):
        part = np.zeros((rows.shape[0], win, x2.shape[1]), np.float64)
        for t in range(rows.shape[0]):
            for r, c, v in zip(rows[t], cols[t], vals[t]):
                if r < csr.shape[0]:
                    part[t, min(max(r - base[t], 0), win - 1)] += v * x2[c]
        return part
    return windows


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("case", _narrow_cases(), ids=lambda c: c[0])
def test_plain_spill_narrow_window_matches_pallas(case, n):
    """Runs of rows past the window clamp onto its last row and add there,
    in the partials and in the product, as the reference's kernels sum
    them (fault 3.4: the old K5 stored them over each other)."""
    name, csr, tile, win = case
    rng = np.random.default_rng(n)
    bal_r = ref_formats.csr_to_balanced(csr, tile=tile)
    bal_p = formats.csr_to_balanced(_port(csr), tile=tile)
    base, span_win = ref_vsr.plan_windows(bal_r)
    assert win < span_win
    xs = (np.arange(6, dtype=np.float32)[:, None].repeat(n, 1)
          if name == "fault_34"
          else rng.standard_normal((csr.shape[1], n)).astype(np.float32))
    kw_r = {"row_base": jnp.asarray(base), "win": win, "interpret": True}
    kw_p = {"row_base": torch.from_numpy(base), "win": win}
    want_part = _clamped_windows(csr, tile, base, win)(xs.astype(np.float64))
    if n == 1:
        x = xs[:, 0].copy()
        want = ref_spmv.spmv_vsr(bal_r, jnp.asarray(x), **kw_r)
        got = spmv.spmv_vsr(bal_p, torch.from_numpy(x), **kw_p)
        part = spmv.spmv_vsr_partials(bal_p, torch.from_numpy(x), *kw_p.values())
        _close(part, want_part[..., 0])
    else:
        x = xs
        want = ref_vsr.spmm_vsr(bal_r, jnp.asarray(x), **kw_r)
        got = vsr.spmm_vsr(bal_p, torch.from_numpy(x), **kw_p)
        part = vsr.spmm_vsr_partials(bal_p, torch.from_numpy(x), *kw_p.values())
        _close(part, want_part)
    assert got.shape == tuple(want.shape)
    _close(got, want)
    _close(vsr.spill_combine(part, kw_p["row_base"], csr.shape[0]), want)
    if name == "fault_34":
        # row 1 of the window holds rows 1-7: 1 + 2 + 3 + 4 + 5 + 0 + 6·1
        assert np.all(np.asarray(want)[1] == 21.0)


def test_plain_spill_nonfinite_x_stays_in_its_rows():
    """A NaN in X reaches only the rows that gather it, as the reference's
    ``"xla"`` backend gives.  The reference's Pallas K4 reduces a tile by a
    one-hot matrix product, so there the NaN reaches every row of the
    tile's window (a caveat of the reference, kept as it is)."""
    import repro.api as ref_api
    csr = _fault_34()
    x = np.ones((6, 4), np.float32)
    x[2, 0] = np.nan
    want = np.asarray(ref_api.sparse(csr, backend="xla") @ jnp.asarray(x))
    assert np.isnan(want[:, 0]).tolist() == [i == 2 for i in range(12)]
    bal_p = formats.csr_to_balanced(_port(csr), tile=8)
    for got in (vsr.spmm_vsr(bal_p, torch.from_numpy(x)),
                vsr.spmm_vsr_spill_plain(bal_p, torch.from_numpy(x)),
                spmv.spmv_vsr(bal_p, torch.from_numpy(x[:, 0].copy()))[:, None]):
        got = got.numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want[:, :got.shape[1]]))
        fin = ~np.isnan(want[:, :got.shape[1]])
        np.testing.assert_allclose(got[fin], want[:, :got.shape[1]][fin], rtol=1e-6)
    pallas = np.asarray(ref_vsr.spmm_vsr(ref_formats.csr_to_balanced(csr, tile=8),
                                         jnp.asarray(x), interpret=True))
    assert np.isnan(pallas[:, 0]).tolist() == [i < 8 for i in range(12)]
    assert not np.isnan(pallas[:, 1:]).any()


def test_spill_lanes_cover_n_up_to_a_warp():
    """K4's lane groups: 4 columns a lane, the smallest power of two that
    covers N, at most 32 (a 128-column block; N = 200 takes two)."""
    assert [vsr.spill_lanes(n) for n in (1, 3, 4, 5, 8, 9, 32, 33, 128, 200)] \
        == [1, 1, 1, 2, 2, 4, 8, 16, 32, 32]


def test_combine_plain_takes_any_row_base():
    """The plain combine (the reference's segment_sum) adds window rows at
    row_base + w whatever the order of row_base, dropping rows past M; a
    caller's row_base is checked on the card only (the kernel's binary
    search needs it non-decreasing)."""
    rng = np.random.default_rng(5)
    part = rng.standard_normal((5, 4, 3)).astype(np.float32)
    base = np.array([6, 0, 3, 3, 9], np.int32)
    want = np.zeros((10 + 4 + 1, 3), np.float64)
    for t in range(5):
        for w in range(4):
            want[base[t] + w] += part[t, w]
    got = vsr.spill_combine(torch.from_numpy(part), torch.from_numpy(base), 10)
    assert got.shape == (10, 3) and got.dtype == torch.float32
    _close(got, want[:10])
    vsr.check_row_base(torch.from_numpy(base))          # the CPU: no check
