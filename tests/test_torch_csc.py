"""K3 on the CPU: the row lengths of the port's ELL, and the row-split
kernels' two designs against the reference's ``"xla"`` ``spmm_rs_sr`` /
``spmm_rs_pr`` on the same numpy inputs.

On the CPU the ``"hopper"`` entries run K3's plain version (their operands
lie on the CPU), so these tests hold the registry's routing, the pr
design's prep hook and the wrapper's semantics; ``tests/test_torch_gpu.py``
holds the CUDA kernels against the plain version on the card.

Tolerance: float32 rtol 1e-5 with atol 1e-5 of the result's largest
magnitude (the reference's rs_pr sums in a tree), bfloat16 rtol 2e-2; NaN
and ±inf at exactly the reference's positions."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro_torch
from repro.core import formats as ref_formats
from repro.core import spmm as ref_spmm
from repro.core.rmat import rmat as ref_rmat
from repro_torch import interop
from repro_torch.core import formats
from repro_torch.kernels import csc, launch_counts, reset_launch_counts

from conftest import random_csr

REF_KERNELS = {"rs_sr": ref_spmm.spmm_rs_sr, "rs_pr": ref_spmm.spmm_rs_pr}
NS = (1, 3, 4, 5, 32, 128)


def _kinds(rng):
    """Rows of every kind: empty, one entry at column 0, one entry away
    from it, two hub rows as wide as the matrix (the full width), a row of
    eight entries without column 0, and random rows."""
    a = (rng.random((40, 64)) < 0.15) * rng.standard_normal((40, 64))
    a[0] = 0.0
    a[1] = 0.0
    a[1, 0] = 1.5
    a[2] = 0.0
    a[2, 5] = -2.0
    a[3] = rng.standard_normal(64)
    a[17] = rng.standard_normal(64)
    a[5] = 0.0
    a[5, 9:17] = rng.standard_normal(8)
    return ref_formats.csr_from_dense(a.astype(np.float32))


def _mats():
    rng = np.random.default_rng(18)
    return {"kinds": _kinds(rng),
            "skewed": ref_rmat(7, 8, seed=3),
            "uniform": ref_rmat(7, 8, 0.25, 0.25, 0.25, seed=4),
            "rand_100x80": random_csr(rng, 100, 80, 0.15)[0],
            "nnz0": ref_formats.csr_from_dense(np.zeros((9, 6), np.float32))}


MATS = _mats()


def _port(csr, dtype=None):
    p = interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                np.asarray(csr.data), csr.shape)
    return p if dtype is None else dataclasses.replace(p, data=p.data.to(dtype))


def _x(rng, k, n):
    return rng.standard_normal((k, n)).astype(np.float32)


def _close(got, want, rtol=1e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _same_nonfinite(got, want, rtol=1e-5):
    """NaN and ±inf at the same positions, the finite rest close."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], rtol)


def _forced(csr_p, x, logical, backend):
    A = repro_torch.sparse(csr_p, device="cpu", backend=backend, cache=False)
    return A.matmul(torch.from_numpy(x), impl=logical)


# ---------------------------------------------------------------------------
# ELL.lens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MATS))
def test_ell_lens_are_the_row_lengths(name):
    csr = MATS[name]
    ell = formats.csr_to_ell(_port(csr))
    assert ell.lens.dtype == torch.int32 and ell.lens.shape == (csr.shape[0],)
    np.testing.assert_array_equal(ell.lens.numpy(), np.diff(np.asarray(csr.indptr)))


@pytest.mark.parametrize("width", [1, 3, 8, 40])
def test_ell_lens_clipped_when_the_width_cuts_rows(width):
    csr = MATS["kinds"]
    ell = formats.csr_to_ell(_port(csr), width=width)
    np.testing.assert_array_equal(
        ell.lens.numpy(), np.minimum(np.diff(np.asarray(csr.indptr)), width))
    _close(csc.spmm_csc(ell, torch.ones(csr.shape[1], 3)),
           csc.spmm_csc_plain(ell, torch.ones(csr.shape[1], 3)))


def test_explicit_zero_is_a_stored_entry():
    p = interop.csr_from_arrays(np.array([0, 2, 2, 3]), np.array([1, 3, 0]),
                                np.array([0.0, 2.0, 0.0], np.float32), (3, 4))
    ell = formats.csr_to_ell(p)
    np.testing.assert_array_equal(ell.lens.numpy(), [2, 0, 1])


def test_lens_survive_live_values(monkeypatch):
    csr = MATS["kinds"]
    A = repro_torch.sparse(_port(csr), device="cpu", backend="hopper", cache=False)
    seen = []
    plain = csc.spmm_csc_plain

    def spy(ell, x):
        seen.append(ell)
        return plain(ell, x)

    monkeypatch.setattr(csc, "spmm_csc_plain", spy)
    rng = np.random.default_rng(3)
    stream = rng.standard_normal(csr.nnz).astype(np.float32)
    x = _x(rng, csr.shape[1], 8)
    got = A.with_values(torch.from_numpy(stream)).matmul(torch.from_numpy(x),
                                                         impl="rs_sr")
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].lens.numpy(),
                                  np.diff(np.asarray(csr.indptr)))
    assert seen[0].lens is A.plan.ell_lens()
    ref = ref_formats.csr_to_ell(ref_formats.CSR(csr.indptr, csr.indices,
                                                 jnp.asarray(stream), csr.shape))
    _close(got, ref_spmm.spmm_rs_sr(ref, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the two designs against the reference's xla lowerings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["hopper", "torch"])
@pytest.mark.parametrize("logical", ["rs_sr", "rs_pr"])
@pytest.mark.parametrize("n", NS)
def test_rs_designs_match_xla(logical, backend, n):
    rng = np.random.default_rng(n)
    for name, csr in MATS.items():
        x = _x(rng, csr.shape[1], n)
        want = REF_KERNELS[logical](ref_formats.csr_to_ell(csr), jnp.asarray(x))
        got = _forced(_port(csr), x, logical, backend)
        assert got.shape == tuple(want.shape), name
        _close(got, want)


@pytest.mark.parametrize("logical", ["rs_sr", "rs_pr"])
@pytest.mark.parametrize("which", ["x", "vals", "both"])
def test_rs_designs_bf16_match_xla(logical, which):
    rng = np.random.default_rng(7)
    csr = MATS["kinds"]
    x = _x(rng, csr.shape[1], 20)
    ell_r = ref_formats.csr_to_ell(csr)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    dtype = None
    if which in ("vals", "both"):
        ell_r = ref_formats.ELL(ell_r.cols, ell_r.vals.astype(jnp.bfloat16),
                                ell_r.shape)
        dtype = torch.bfloat16
    if which in ("x", "both"):
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    A = repro_torch.sparse(_port(csr, dtype), device="cpu", backend="hopper",
                           cache=False)
    got = A.matmul(xt, impl=logical)
    want = REF_KERNELS[logical](ell_r, xj)
    assert got.dtype == xt.dtype
    _close(got, np.asarray(want.astype(jnp.float32)), rtol=2e-2)


def _nonfinite_x(rng, k, n):
    x = _x(rng, k, n)
    x[0, 0] = np.nan
    if n > 1:
        x[0, 1] = np.inf
    if n > 2:
        x[0, 2] = -np.inf
    x[min(7, k - 1), n - 1] = np.inf
    x[min(9, k - 1), 0] = np.nan
    return x


@pytest.mark.parametrize("backend", ["hopper", "torch"])
@pytest.mark.parametrize("logical", ["rs_sr", "rs_pr"])
@pytest.mark.parametrize("n", [1, 4, 5, 32])
def test_nonfinite_x_matches_xla(logical, backend, n):
    rng = np.random.default_rng(30 + n)
    for name in ("kinds", "rand_100x80", "uniform"):
        csr = MATS[name]
        x = _nonfinite_x(rng, csr.shape[1], n)
        want = REF_KERNELS[logical](ref_formats.csr_to_ell(csr), jnp.asarray(x))
        _same_nonfinite(_forced(_port(csr), x, logical, backend), want)


@pytest.mark.parametrize("logical", ["rs_sr", "rs_pr"])
def test_padded_rows_see_a_nonfinite_x_row_0(logical):
    """A 3x4 matrix, X[0] = (nan, inf): the row as long as the width gives
    (nan, inf), the padded rows NaN, as the padding slots (col 0, val 0)
    make it."""
    a = np.array([[1, 2, 0, 0], [0, 0, 3, 0], [0, 0, 0, 0]], np.float32)
    csr = ref_formats.csr_from_dense(a)
    x = np.ones((4, 2), np.float32)
    x[0] = (np.nan, np.inf)
    want = REF_KERNELS[logical](ref_formats.csr_to_ell(csr), jnp.asarray(x))
    got = _forced(_port(csr), x, logical, "hopper")
    assert torch.isnan(got[0, 0]) and torch.isposinf(got[0, 1])
    assert torch.isnan(got[1:]).all()
    _same_nonfinite(got, want)
    ell = formats.csr_to_ell(_port(csr))
    _same_nonfinite(csc.spmm_csc_stored_plain(ell, torch.from_numpy(x)), want)


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("n", [1, 4, 32])
def test_stored_slot_walk_equals_the_plain_version(n, nonfinite):
    rng = np.random.default_rng(40 + n)
    for name, csr in MATS.items():
        for width in (None, 3):
            ell = formats.csr_to_ell(_port(csr), width=width)
            x = (_nonfinite_x(rng, csr.shape[1], n) if nonfinite
                 else _x(rng, csr.shape[1], n))
            x = torch.from_numpy(x)
            torch.testing.assert_close(csc.spmm_csc_stored_plain(ell, x),
                                       csc.spmm_csc_plain(ell, x), rtol=0,
                                       atol=0, equal_nan=True, msg=name)


def test_stored_slot_walk_one_dimensional_and_bf16():
    csr = MATS["kinds"]
    ell = formats.csr_to_ell(_port(csr, torch.bfloat16))
    x = torch.from_numpy(_x(np.random.default_rng(2), csr.shape[1], 1))[:, 0]
    for xx in (x, x.bfloat16()):
        got = csc.spmm_csc_stored_plain(ell, xx)
        assert got.shape == xx.shape[:0] + (csr.shape[0],) and got.dtype == xx.dtype
        torch.testing.assert_close(got, csc.spmm_csc_plain(ell, xx), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# routing, the prep hook, checks and counts
# ---------------------------------------------------------------------------

def test_routing_rules():
    assert [csc._design(n) for n in (1, 4, 5, 128)] == ["pr", "pr", "sr", "sr"]
    assert [csc.sr_lanes(n) for n in (1, 4, 5, 8, 9, 32, 33, 127, 128, 200)] \
        == [1, 1, 2, 2, 4, 8, 16, 32, 32, 32]
    # the column-slab order: X more than eight L2s, 128 bytes of a row a slab
    big = 2**20
    assert [csc.sr_lanes(n, big, 4) for n in (32, 64, 128, 200)] == [8, 16, 8, 8]
    assert [csc.sr_lanes(n, big, 2) for n in (32, 64, 128, 256)] == [8, 16, 32, 16]
    assert csc.sr_lanes(128, 2**19, 4) == 32 and csc.sr_lanes(200, 2**18, 4) == 32


@pytest.mark.parametrize("mean,group", [(0, 8), (3.5, 8), (8, 8), (8.5, 16),
                                        (16, 16), (17, 32), (300, 32)])
def test_pr_group_follows_the_mean_row(mean, group):
    m = 64
    total = int(mean * m)
    lens = torch.full((m,), total // m, dtype=torch.int32)
    lens[: total % m] += 1
    ell = formats.ELL(torch.zeros((m, 1), dtype=torch.int32),
                      torch.zeros((m, 1)), (m, 4), lens)
    assert csc.pr_group(ell) == group


def test_plan_prep_gives_the_pr_group_once():
    csr = MATS["uniform"]
    A = repro_torch.sparse(_port(csr), device="cpu", backend="hopper", cache=False)
    p = A.plan
    opts = p.kernel_opts(p.entry("rs_pr"))
    assert opts == {"group": csc.pr_group(p.substrate("ell"))}
    assert p.kernel_opts(p.entry("rs_pr")) is opts
    assert p.kernel_opts(p.entry("rs_sr")) == {}


def test_check_rejects_operands_the_kernels_do_not_take():
    csr = _port(MATS["kinds"])
    ell = formats.csr_to_ell(csr)
    x = torch.ones(csr.shape[1], 4)
    assert csc._check(ell, x) is x
    with pytest.raises(ValueError):
        csc._check(dataclasses.replace(ell, lens=ell.lens.long()), x)
    with pytest.raises(ValueError):
        csc._check(dataclasses.replace(ell, lens=ell.lens[:-1]), x)
    with pytest.raises(ValueError):
        csc._check(ell, torch.ones(csr.shape[1] + 1, 4))
    with pytest.raises(ValueError):
        csc._check(ell, x.double())


def test_cpu_calls_count_no_launch():
    reset_launch_counts()
    csr = _port(MATS["kinds"])
    ell = formats.csr_to_ell(csr)
    for design in (None, "sr", "pr"):
        csc.spmm_csc(ell, torch.ones(csr.shape[1], 4), design)
    assert launch_counts()["csc_spmm"] == 0
    assert csc.DESIGN_LAUNCHES == {"csc_spmm": {"sr": 0, "pr": 0}}
