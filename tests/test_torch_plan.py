"""The offline half of the port against the reference (mirrors the parts of
``tests/test_plan.py`` that ``tests/test_torch_api.py`` does not): the
selector's calibration (``calibrate`` on the same measured times gives the
reference's thresholds and geomean slowdown), its ``save_to`` round trip,
the 27-matrix R-MAT suite element for element, ``calibrate_backend`` on the
CPU with its tuners (``tune_geometry``, ``tune_quant``, ``overlap_mesh``
on a mesh of four CPU shards), ``backends_for``, the
deprecated front doors (``PreparedMatrix``, ``adaptive_spmm``,
``repro_torch.kernels.spmm``), and the quickstart example on the CPU."""
import math

import numpy as np
import pytest
import torch

from repro.core import MATMUL_KERNELS as REF_KERNELS
from repro.core import calibrate as ref_calibrate
from repro.core import rmat_suite as ref_rmat_suite
from repro.core.rmat import rmat_suite_small as ref_suite_small
from repro.core.selector import TileGeometry as ref_geometry
import repro_torch
from repro_torch import api, interop
from repro_torch.core import (MATMUL_KERNELS, PreparedMatrix, adaptive_spmm,
                              backends_for, calibrate, load_thresholds,
                              rmat_suite)
from repro_torch.core.selector import (SelectorThresholds, TileGeometry,
                                       slowdown_vs_oracle)

SMALL = ref_suite_small(seed=0)


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _times(seed: int, ns: tuple) -> dict:
    rng = np.random.default_rng(seed)
    return {(name, n, k): float(rng.uniform(0.5, 2.0))
            for name in SMALL for n in ns for k in MATMUL_KERNELS}


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibrate_matches_reference_on_equal_times(seed):
    ns = (1, 4, 32, 128)
    times = _times(seed, ns)
    assert MATMUL_KERNELS == REF_KERNELS
    th, report = calibrate({k: _port(v) for k, v in SMALL.items()}, ns,
                           times=times)
    ref_th, ref_report = ref_calibrate(SMALL, ns, times=times)
    assert (th.n_threshold, th.pr_avg_row, th.sr_cv) == \
        (ref_th.n_threshold, ref_th.pr_avg_row, ref_th.sr_cv)
    assert report["geomean_slowdown_vs_oracle"] == \
        ref_report["geomean_slowdown_vs_oracle"]
    assert report["times"] == ref_report["times"]
    stats = {k: api.sparse(_port(v), device="cpu").stats
             for k, v in SMALL.items()}
    assert slowdown_vs_oracle(stats, ns, times, th) == \
        report["geomean_slowdown_vs_oracle"]
    assert slowdown_vs_oracle(stats, ns, times, SelectorThresholds()) >= \
        report["geomean_slowdown_vs_oracle"]


def test_calibrate_save_to(tmp_path):
    csr = _port(SMALL["rmat_s6_e4_uniform"])
    times = {("m", n, k): 1.0 + (k != "nb_pr") for n in (1, 8)
             for k in MATMUL_KERNELS}
    path = str(tmp_path / "cal.json")
    th, report = calibrate({"m": csr}, (1, 8), times=times, save_to=path)
    assert load_thresholds(path) == th
    assert report["geomean_slowdown_vs_oracle"] >= 1.0


def test_calibrate_times_every_point_with_time_fn():
    seen = []

    def time_fn(kernel, p, n):
        seen.append((p.csr.shape, n, kernel))
        return 1.0 + MATMUL_KERNELS.index(kernel) + n
    mats = {k: _port(v) for k, v in list(SMALL.items())[:2]}
    th, report = calibrate(mats, (1, 8), time_fn=time_fn)
    assert len(seen) == len(report["times"]) == 2 * 2 * 4
    assert report["geomean_slowdown_vs_oracle"] >= 1.0
    with pytest.raises(ValueError, match="time_fn or times"):
        calibrate(mats, (1,))


# ---------------------------------------------------------------------------
# the suite, calibrate_backend, the registry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def suites():
    return rmat_suite(seed=0), ref_rmat_suite(seed=0)


def test_rmat_suite_matches_reference_element_for_element(suites):
    port, ref = suites
    assert list(port) == list(ref) and len(port) == 27
    for name, want in ref.items():
        got = port[name]
        assert got.shape == tuple(want.shape), name
        np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def test_calibrate_backend_runs_on_the_cpu(tmp_path):
    path = str(tmp_path / "th.json")
    th, report = repro_torch.calibrate_backend(path, device="cpu")
    assert load_thresholds(path) == th
    assert len(report["times"]) == 2 * 2 * 4        # matrices x ns x kernels
    assert all(math.isfinite(t) and t > 0 for t in report["times"].values())
    assert report["geomean_slowdown_vs_oracle"] >= 1.0
    small = {"a": _port(SMALL["rmat_s6_e16_skewed"])}
    th2, report2 = api.calibrate_backend(matrices=small, ns=(1, 4, 32),
                                         repeats=1, backend="hopper",
                                         device="cpu", n_grid=(4,))
    assert th2.n_threshold == 4 and len(report2["times"]) == 3 * 4


@pytest.mark.parametrize("kw", [{"overlap_mesh": "cpu4"}])
def test_calibrate_backend_unported_arguments(kw):
    del kw
    """``overlap_mesh`` is ported: the overlap crossover measured on the
    mesh lands in the report (on the CPU the ring never wins by much; any
    width of ``overlap_ns`` or ``OVERLAP_NEVER`` is a valid answer)."""
    from repro_torch.kernels.tune import OVERLAP_NEVER
    from repro_torch.launch import make_local_mesh
    mesh = make_local_mesh(4, 1, devices=["cpu"] * 4)
    th, report = api.calibrate_backend(
        device="cpu", repeats=1, ns=(1,), n_grid=(4,), avg_grid=(32.0,),
        cv_grid=(0.5,), overlap_mesh=mesh, overlap_ns=(256,))
    assert report["overlap_min_n"] in (256, OVERLAP_NEVER)
    assert th.overlap_min_n == report["overlap_min_n"]


def _report_shape(report: dict) -> dict:
    """The report's keys and value types; geometry keys without their
    backend segment."""
    out = {k: type(v) for k, v in report.items()}
    if "geometries" in report:
        out["geometries"] = {k.split("|", 1)[1]: (type(v), len(v))
                             for k, v in report["geometries"].items()}
    return out


def test_calibrate_backend_tunes_geometry(tmp_path):
    """``tune_geometry=True`` as in the reference: one entry per N-bucket of
    the ns above 1 and a wildcard per matrix (``geometry_candidates`` the
    sweep), the report's ``"geometries"`` the persisted table, with the
    reference's keys and types (plus ``"timing"``, each entry's mode)."""
    from repro import api as ref_api
    names = ("rmat_s6_e16_skewed", "rmat_s6_e4_uniform")
    ref_cands = (ref_geometry(tile=16), ref_geometry(tile=64))
    cands = tuple(TileGeometry(*g.as_tuple()) for g in ref_cands)
    path = str(tmp_path / "th.json")
    th, report = api.calibrate_backend(
        path, matrices={k: _port(SMALL[k]) for k in names}, ns=(1, 8),
        repeats=1, device="cpu", tune_geometry=True,
        geometry_candidates=cands)
    _, ref_report = ref_api.calibrate_backend(
        matrices={k: SMALL[k] for k in names}, ns=(1, 8), repeats=1,
        backend="xla", tune_geometry=True, geometry_candidates=ref_cands)
    assert set(report) == set(ref_report) | {"timing"}
    assert _report_shape(report) == dict(_report_shape(ref_report),
                                         timing=dict)
    assert report["geometries"] == dict(th.geometries) == \
        dict(load_thresholds(path).geometries)
    assert all(k.startswith("torch|") for k in report["geometries"])
    assert {tuple(v) for v in report["geometries"].values()} <= \
        {g.as_tuple() for g in cands}
    assert set(report["times"]) <= set(report["timing"])
    assert len(report["timing"]) == len(report["times"]) + 2 * 2
    assert set(report["timing"].values()) == {"host"}


def test_calibrate_backend_tunes_quant(monkeypatch):
    """``tune_quant=True`` as in the reference: ``autotune_quant`` at
    ``quant_ns`` on the matrix with the most nonzeros, the report's
    ``"quant_min_n"`` an int, the returned thresholds carrying it."""
    from repro import api as ref_api
    from repro_torch.kernels import tune
    names = ("rmat_s6_e4_uniform", "rmat_s8_e16_skewed", "rmat_s6_e16_skewed")
    seen = []
    real = tune.autotune_quant

    def spy(csr, **kw):
        seen.append(csr.nnz)
        return real(csr, **kw)
    monkeypatch.setattr(tune, "autotune_quant", spy)
    matrices = {k: _port(SMALL[k]) for k in names}
    th, report = api.calibrate_backend(matrices=matrices, ns=(1, 8),
                                       repeats=1, device="cpu",
                                       tune_quant=True, quant_ns=(8, 32))
    _, ref_report = ref_api.calibrate_backend(
        matrices={k: SMALL[k] for k in names[:1]}, ns=(1,), repeats=1,
        backend="xla", tune_quant=True, quant_ns=(8,))
    assert set(report) == set(ref_report) | {"timing"}
    assert _report_shape(report) == dict(_report_shape(ref_report),
                                         timing=dict)
    assert seen == [max(c.nnz for c in matrices.values())]
    assert report["quant_min_n"] == th.quant_min_n
    assert report["quant_min_n"] in (8, 32, tune.QUANT_NEVER)


def test_backends_for():
    assert set(backends_for("nb_pr")) == {"torch", "hopper", "bsr", "sharded"}
    assert set(backends_for("sddmm")) == {"torch", "hopper", "sharded"}


# ---------------------------------------------------------------------------
# deprecated front doors: they warn and answer like sparse()
# ---------------------------------------------------------------------------

def test_prepared_matrix_shim_is_lazy_and_warns():
    csr = _port(SMALL["rmat_s6_e16_skewed"])
    with pytest.warns(DeprecationWarning):
        prep = PreparedMatrix.from_csr(csr, tile=16, device="cpu")
    assert prep._plan.built_substrates == ()         # no eager double-build
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 3)).astype(np.float32))
    want = api.sparse(csr, tile=16, device="cpu", cache=False).matmul(
        x, impl="nb_sr")
    with pytest.warns(DeprecationWarning):
        y = adaptive_spmm(prep, x, impl="nb_sr")
    assert torch.equal(y, want)
    assert prep.balanced is prep._plan.substrate("balanced")
    assert prep.stats == prep._plan.stats and prep.csr is prep._plan.csr
    with pytest.warns(DeprecationWarning):
        y2 = adaptive_spmm(csr, x, device="cpu")
    assert torch.allclose(y2, want, atol=1e-5)


def test_kernels_spmm_shim():
    from repro_torch.kernels import spmm
    csr = _port(SMALL["rmat_s6_e16_uniform"])
    with pytest.warns(DeprecationWarning):
        prep = PreparedMatrix.from_csr(csr, tile=16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 3)).astype(np.float32))
    with pytest.warns(DeprecationWarning):
        y = spmm(prep, x, force_hopper=True)
    want = api.sparse(csr, tile=16, device="cpu", backend="hopper",
                      cache=False) @ x
    assert torch.equal(y, want)


def test_spmm_nb_pr_trainable_shim():
    """Mirrors ``tests/test_plan.py::test_spmm_nb_pr_trainable_shim``: the
    deprecated trainable front door warns and answers as ``A @ x`` does,
    and the reference's shim gives the same product."""
    from repro.core import plan as ref_plan
    from repro.core import spmm_nb_pr_trainable as ref_shim
    from repro_torch.core import spmm_nb_pr_trainable
    from repro_torch.core.plan import plan
    from conftest import random_csr
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    csr, a = random_csr(rng, 20, 20, 0.2)
    bal = plan(_port(csr), tile=16).substrate("balanced")
    xn = rng.standard_normal((20, 3)).astype(np.float32)
    x = torch.from_numpy(xn)
    with pytest.warns(DeprecationWarning):
        y = spmm_nb_pr_trainable((bal.rows, bal.cols, bal.shape), bal.vals, x)
    np.testing.assert_allclose(y.numpy(), a @ xn, atol=1e-4)
    rbal = ref_plan(csr, tile=16).substrate("balanced")
    with pytest.warns(DeprecationWarning):
        ry = ref_shim((rbal.rows, rbal.cols, rbal.shape), rbal.vals,
                      jnp.asarray(xn))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-5)


# ---------------------------------------------------------------------------
# the quickstart example
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_the_cpu(capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(device="cpu")
    assert out["agree_n1"] and out["agree_n4"] and out["agree_n64"]
    assert out["live"] < 1e-4 and out["artifact"] == 0.0
    assert "hopper_nb_pr" not in out and "graph" not in out
    assert "hopper column: skipped" in capsys.readouterr().out
