"""Port vs reference: formats, statistics, R-MAT, the selector, thresholds
JSON, the pattern fingerprint and the VSR host-side prep.  The same numpy
arrays go to both packages; every result here must be element-equal."""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from repro.core import cache as ref_cache
from repro.core import formats as ref_formats
from repro.core import selector as ref_selector
from repro.core import stats as ref_stats
from repro.kernels import vsr as ref_vsr
from repro_torch import interop
from repro_torch.core import cache, formats, selector, stats
from repro_torch.kernels import vsr

from conftest import random_csr

# the packages re-export the function ``rmat`` over the module's name
ref_rmat = importlib.import_module("repro.core.rmat")
rmat = importlib.import_module("repro_torch.core.rmat")

NS = (1, 4, 20, 128)


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _ref_suite():
    return ref_rmat.rmat_suite_small(seed=0)


def _extra_mats(rng):
    """random_csr shapes of the reference's tests, a matrix with an empty
    band of rows, and an all-zero matrix (nnz = 0)."""
    mats = {}
    for m, k, d in ((16, 16, 0.15), (100, 80, 0.02), (257, 129, 0.15), (64, 300, 0.5)):
        mats[f"rand_{m}x{k}_{d}"] = random_csr(rng, m, k, d)[0]
    a = (rng.random((200, 90)) < 0.1) * rng.standard_normal((200, 90))
    a[40:150] = 0.0
    mats["empty_band"] = ref_formats.csr_from_dense(a.astype(np.float32))
    mats["nnz0"] = ref_formats.csr_from_dense(np.zeros((30, 20), np.float32))
    return mats


@pytest.fixture(scope="module")
def mats():
    out = dict(_ref_suite())
    out.update(_extra_mats(np.random.default_rng(7)))
    return out


def _eq(t, ref):
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref))
    assert t.numpy().dtype == np.asarray(ref).dtype


def test_rmat_suite_identical():
    ref = _ref_suite()
    port = rmat.rmat_suite_small(seed=0)
    assert list(ref) == list(port)
    for name in ref:
        _eq(port[name].indptr, ref[name].indptr)
        _eq(port[name].indices, ref[name].indices)
        _eq(port[name].data, ref[name].data)
        assert port[name].shape == tuple(ref[name].shape)


@pytest.mark.parametrize("args", [dict(scale=9, edge_factor=8, seed=3),
                                  dict(scale=7, edge_factor=4, a=0.45, b=0.22,
                                       c=0.22, seed=1, m=100, k=70)])
def test_rmat_identical(args):
    ref, port = ref_rmat.rmat(**args), rmat.rmat(**args)
    for f in ("indptr", "indices", "data"):
        _eq(getattr(port, f), getattr(ref, f))


def test_csr_from_coo_sums_duplicates():
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, 12, 80), rng.integers(0, 9, 80)
    vals = rng.standard_normal(80).astype(np.float32)
    ref = ref_formats.csr_from_coo(rows, cols, vals, (12, 9))
    port = formats.csr_from_coo(rows, cols, vals, (12, 9))
    for f in ("indptr", "indices", "data"):
        _eq(getattr(port, f), getattr(ref, f))


def test_substrates_element_equal(mats):
    for name, csr in mats.items():
        p = _port(csr)
        np.testing.assert_array_equal(
            formats.row_ids_from_indptr(np.asarray(csr.indptr), csr.nnz),
            ref_formats.row_ids_from_indptr(np.asarray(csr.indptr), csr.nnz))
        ell_r, ell_p = ref_formats.csr_to_ell(csr), formats.csr_to_ell(p)
        _eq(ell_p.cols, ell_r.cols)
        _eq(ell_p.vals, ell_r.vals)
        for tile in (64, 512):
            bal_r = ref_formats.csr_to_balanced(csr, tile=tile)
            bal_p = formats.csr_to_balanced(p, tile=tile)
            for f in ("rows", "cols", "vals"):
                _eq(getattr(bal_p, f), getattr(bal_r, f))


def _ell_loop(csr, width):
    """The reference's row loop, kept as the oracle of the vectorised
    builder (rows longer than ``width`` are cut)."""
    indptr, indices, data = map(np.asarray, (csr.indptr, csr.indices, csr.data))
    m = csr.shape[0]
    cols = np.zeros((m, width), np.int32)
    vals = np.zeros((m, width), data.dtype)
    for i in range(m):
        s, e = indptr[i], min(indptr[i + 1], indptr[i] + width)
        cols[i, : e - s] = indices[s:e]
        vals[i, : e - s] = data[s:e]
    return cols, vals


@pytest.mark.parametrize("width", [1, 3, 40])
def test_csr_to_ell_width_cut_matches_loop(mats, width):
    csr = mats["rmat_s8_e16_skewed"]
    ell = formats.csr_to_ell(_port(csr), width=width)
    cols, vals = _ell_loop(csr, width)
    np.testing.assert_array_equal(ell.cols.numpy(), cols)
    np.testing.assert_array_equal(ell.vals.numpy(), vals)


def test_bf16_values_survive_substrates():
    csr = ref_formats.csr_from_dense(np.eye(5, dtype=np.float32) * 3)
    p = _port(csr)
    p = formats.CSR(p.indptr, p.indices, p.data.bfloat16(), p.shape)
    assert formats.csr_to_balanced(p, tile=4).vals.dtype == torch.bfloat16
    assert formats.csr_to_ell(p).vals.dtype == torch.bfloat16


def test_build_counts():
    csr = _port(random_csr(np.random.default_rng(2), 20, 20, 0.3)[0])
    formats.reset_build_counts()
    formats.csr_to_ell(csr)
    formats.csr_to_balanced(csr)
    formats.csr_to_balanced(csr)
    assert formats.reset_build_counts() == {"ell": 1, "balanced": 2, "bsr": 0}
    assert formats.BUILD_COUNTS == {"ell": 0, "balanced": 0, "bsr": 0}


def test_stats_and_span_equal(mats):
    for name, csr in mats.items():
        p = _port(csr)
        assert dataclasses.asdict(stats.matrix_stats(p)) == \
            dataclasses.asdict(ref_stats.matrix_stats(csr)), name
        for tile in (16, 512):
            assert stats.balanced_tile_span(p, tile) == \
                ref_stats.balanced_tile_span(csr, tile), name


def test_selector_agrees(mats):
    ths = (ref_selector.SelectorThresholds(),
           ref_selector.SelectorThresholds(n_threshold=2, pr_avg_row=8.0, sr_cv=1.0))
    for th_r in ths:
        th_p = selector.SelectorThresholds.from_json(th_r.to_json())
        for name, csr in mats.items():
            st_r, st_p = ref_stats.matrix_stats(csr), stats.matrix_stats(_port(csr))
            for n in NS + (2, 5, 32):
                assert selector.select_kernel(st_p, n, th_p) == \
                    ref_selector.select_kernel(st_r, n, th_r), (name, n)


def test_fingerprint_byte_identical(mats):
    for name, csr in mats.items():
        assert cache.pattern_fingerprint(_port(csr)) == \
            ref_cache.pattern_fingerprint(csr), name


def test_fingerprint_with_numpy_int_shape():
    """A shape of numpy integers must hash as Python ints (their numpy-2
    repr would change the digest)."""
    csr = random_csr(np.random.default_rng(3), 9, 7, 0.4)[0]
    p = _port(csr)
    p_np = formats.CSR(p.indptr, p.indices, p.data, (np.int64(9), np.int64(7)))
    assert cache.pattern_fingerprint(p_np) == ref_cache.pattern_fingerprint(csr)


_FP = "0123456789abcdef0123"

#: one thresholds object per schema version, v1..v5, in the reference's class
_VERSIONED = {
    1: dict(n_threshold=2, pr_avg_row=8.0, sr_cv=1.0, partition_cv=0.5),
    2: dict(max_win=2048, geometries=(
        (f"hopper|{_FP[:12]}|n128", (1024, 64, 256)),
        (f"pallas|{_FP[:12]}|n4", (256, 32, 128)))),
    3: dict(quant_min_n=32),
    4: dict(quant_min_n=8, chain_fuse_min_n=16),
    5: dict(chain_fuse_min_n=4, attn_fuse_min_seq=1024, overlap_min_n=256),
}


@pytest.mark.parametrize("version", sorted(_VERSIONED))
def test_thresholds_json_round_trips_both_ways(version):
    th_r = ref_selector.SelectorThresholds(**_VERSIONED[version])
    text_r = th_r.to_json()
    assert json.loads(text_r)["version"] == version
    th_p = interop.thresholds_from_json(text_r)
    assert dataclasses.astuple(th_p) == dataclasses.astuple(th_r)
    text_p = th_p.to_json()
    assert text_p == text_r
    assert ref_selector.SelectorThresholds.from_json(text_p) == th_r


def test_thresholds_file_and_env(tmp_path, monkeypatch):
    th = selector.SelectorThresholds(n_threshold=8)
    path = tmp_path / "th.json"
    selector.save_thresholds(th, str(path))
    assert ref_selector.load_thresholds(str(path)).n_threshold == 8
    monkeypatch.setenv(selector.THRESHOLDS_ENV, str(path))
    assert selector.default_thresholds() == th
    path.write_text("{not json")
    with pytest.warns(UserWarning):
        assert selector.default_thresholds() == selector.SelectorThresholds()


def test_geometry_rules_per_backend():
    fp = "f" * 40
    th = selector.SelectorThresholds().with_geometry(
        selector.geometry_key("hopper", fp, 32), selector.TileGeometry(256, 8, 128))
    th = th.with_geometry(selector.geometry_key("pallas", fp, 32),
                          selector.TileGeometry(8192, 64, 256))
    assert th.geometry_for(fp, 20, "hopper") == selector.TileGeometry(256, 8, 128)
    assert th.geometry_for(fp, 200, "hopper") is None
    with pytest.raises(ValueError):      # over the K1 shared-memory staging
        selector.TileGeometry(8192, 64, 128).validate("hopper")
    with pytest.raises(ValueError):      # TPU rules hold for hopper entries
        selector.TileGeometry(512, 64, 96).validate("hopper")
    with pytest.raises(ValueError):
        selector.TileGeometry(512, 12, 128).validate("pallas")
    with pytest.raises(ValueError):      # a hopper entry past the K1 limit
        selector.SelectorThresholds(geometries=(
            (selector.geometry_key("hopper", fp, 4), (8192, 64, 128)),)).validate()
    with pytest.raises(ValueError):
        selector.SelectorThresholds(sr_cv=float("nan")).validate()


def test_plan_windows_and_visits_equal(mats):
    for name, csr in mats.items():
        for tile in (16, 128):
            bal_r = ref_formats.csr_to_balanced(csr, tile=tile)
            bal_p = formats.csr_to_balanced(_port(csr), tile=tile)
            base_r, win_r = ref_vsr.plan_windows(bal_r)
            base_p, win_p = vsr.plan_windows(bal_p)
            np.testing.assert_array_equal(base_p, base_r)
            assert win_p == win_r
            for wb in (8, 64):
                for a, b in zip(vsr.plan_visits(bal_p, wb),
                                ref_vsr.plan_visits(bal_r, wb)):
                    np.testing.assert_array_equal(a, b)
                    assert a.dtype == b.dtype


def test_interop_csr_from_arrays():
    csr = random_csr(np.random.default_rng(4), 11, 13, 0.3)[0]
    indptr, indices, data = map(np.asarray, (csr.indptr, csr.indices, csr.data))
    p = interop.csr_from_arrays(indptr.astype(np.int64), indices, data,
                                (np.int64(11), np.int64(13)))
    _eq(p.indptr, csr.indptr)
    _eq(p.indices, csr.indices)
    _eq(p.data, csr.data)
    assert p.shape == (11, 13) and all(type(s) is int for s in p.shape)
    with pytest.raises(ValueError):
        interop.csr_from_arrays(indptr[:-1], indices, data, (11, 13))
