"""The port's tuner (``repro_torch.kernels.tune``) against the reference's
(``repro.kernels.tune``) on the same numpy inputs.

* The four byte models return the reference's dicts exactly (integers
  equal, ratios equal as floats), on R-MAT and banded patterns, f32 and
  bf16 values, ``quant`` None / int8 / fp8, the chain's three transforms and
  a ``build_mask`` mask.
* Under one seeded table of fake times, patched into both packages'
  ``measure_*`` inside the test only, every ``autotune_*`` gives the
  reference's thresholds: the same ``*_min_n`` and ``*_NEVER``, the same
  geometry entries up to the backend segment of their keys (the pattern
  fingerprint is the reference's, byte for byte).
* A timed ``autotune_geometry`` on ``"torch"`` on the CPU, whose tuned plan
  carries the table's tile and matches the reference's ``"xla"`` output
  at that tile (relative 1e-5).
* Thresholds files with ``"hopper"`` geometry entries cross between the
  packages both ways, and the sharded tuners refuse."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.attention import build_mask as ref_build_mask
from repro.attention import sliding_window as ref_sliding_window
from repro.core import csr_from_dense as ref_csr_from_dense
from repro.core import execute as ref_execute
from repro.core import plan as ref_plan
from repro.core.formats import CSR as RefCSR
from repro.core.formats import csr_to_balanced as ref_csr_to_balanced
from repro.core.rmat import rmat as ref_rmat
from repro.core.selector import SelectorThresholds as RefThresholds
from repro.core.selector import TileGeometry as RefGeometry
from repro.core.selector import load_thresholds as ref_load_thresholds
from repro.core.selector import save_thresholds as ref_save_thresholds
from repro.kernels import tune as ref_tune
import repro_torch
from repro_torch import interop
from repro_torch.attention import build_mask, sliding_window
from repro_torch.core.formats import CSR, csr_to_balanced
from repro_torch.core.selector import (SelectorThresholds, TileGeometry,
                                       load_thresholds, save_thresholds)
from repro_torch.kernels import tune


def _port(csr, dtype=None):
    out = interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                  np.asarray(csr.data, np.float32), csr.shape)
    if dtype is not None:
        out = CSR(out.indptr, out.indices, out.data.to(dtype), out.shape)
    return out


def _banded(m: int = 300, k: int = 280, half: int = 3):
    rng = np.random.default_rng(5)
    a = np.zeros((m, k), np.float32)
    for i in range(m):
        lo, hi = max(0, i - half), min(k, i + half + 1)
        a[i, lo:hi] = rng.standard_normal(max(hi - lo, 0))
    a[40:60] = 0.0                       # an empty-row gap
    return ref_csr_from_dense(a)


PATTERNS = {"rmat_skewed": lambda: ref_rmat(9, 8, seed=3),
            "rmat_uniform": lambda: ref_rmat(8, 8, 0.25, 0.25, 0.25, seed=4),
            "banded": _banded}
GEOMS = {"default": None, "256x32": (256, 32, 128), "64x8x256": (64, 8, 256)}


def _geoms(name):
    g = GEOMS[name]
    return (None, None) if g is None else (RefGeometry(*g), TileGeometry(*g))


# ---------------------------------------------------------------------------
# the byte models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("values", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_modeled_traffic_matches_reference(pattern, values, quant, geom):
    ref = PATTERNS[pattern]()
    port = _port(ref, torch.bfloat16 if values == "bfloat16" else None)
    if values == "bfloat16":
        ref = RefCSR(ref.indptr, ref.indices, ref.data.astype(jnp.bfloat16),
                     ref.shape)
    rg, pg = _geoms(geom)
    for n in (1, 8, 128, 200):
        want = ref_tune.modeled_traffic(ref, n, geometry=rg, quant=quant)
        got = tune.modeled_traffic(port, n, geometry=pg, quant=quant)
        assert got == want, (n, got, want)


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("win", [None, 48])
def test_modeled_traffic_balanced_matches_reference(pattern, win):
    ref = PATTERNS[pattern]()
    port = _port(ref)
    for tile in (32, 512):
        rbal = ref_csr_to_balanced(ref, tile=tile)
        pbal = csr_to_balanced(port, tile=tile)
        geom = (RefGeometry(tile=tile, wb=16), TileGeometry(tile=tile, wb=16))
        for kw in ({}, {"value_bytes": 2}, {"quant": "int8"},
                   {"dtype_bytes": 2, "index_bytes": 2}):
            want = ref_tune.modeled_traffic_balanced(
                rbal, 64, int(ref.nnz), geometry=geom[0], win=win, **kw)
            got = tune.modeled_traffic_balanced(
                pbal, 64, int(port.nnz), geometry=geom[1], win=win, **kw)
            assert got == want, (tile, kw)


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("transform", ["softmax", "identity", "scale"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_modeled_traffic_chain_matches_reference(pattern, transform, geom):
    ref = PATTERNS[pattern]()
    port = _port(ref)
    rg, pg = _geoms(geom)
    for n, d in ((1, 4), (32, 64), (200, 16)):
        want = ref_tune.modeled_traffic_chain(ref, n, d, transform=transform,
                                              geometry=rg)
        got = tune.modeled_traffic_chain(port, n, d, transform=transform,
                                         geometry=pg)
        assert got == want, (n, d)


@pytest.mark.parametrize("seq,window,causal", [(256, 1, True), (512, 2, False),
                                               (300, 3, True)])
def test_modeled_traffic_attention_matches_reference(seq, window, causal):
    ref_mask = ref_build_mask(ref_sliding_window(seq, window, block=64,
                                                 causal=causal))
    mask = build_mask(sliding_window(seq, window, block=64, causal=causal))
    for head_dim, dtype_bytes in ((64, 4), (256, 2)):
        want = ref_tune.modeled_traffic_attention(ref_mask, head_dim,
                                                  dtype_bytes=dtype_bytes)
        got = tune.modeled_traffic_attention(mask, head_dim,
                                             dtype_bytes=dtype_bytes)
        assert got == want


# ---------------------------------------------------------------------------
# the tuners under one table of fake times
# ---------------------------------------------------------------------------

def _patch(monkeypatch, name, fake):
    monkeypatch.setattr(ref_tune, name, fake)
    monkeypatch.setattr(tune, name, fake)


def _strip(geometries) -> dict:
    """A geometry table keyed without its backend segment."""
    return {k.split("|", 1)[1]: tuple(v) for k, v in dict(geometries).items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cands", ["reference", "hopper"])
def test_autotune_geometry_matches_reference_on_fake_times(monkeypatch, seed,
                                                           cands):
    rng = np.random.default_rng(seed)
    ns = (1, 4, 32, 128, 300)
    tuples = [g.as_tuple() for g in (tune.DEFAULT_CANDIDATES
                                     + tune.HOPPER_CANDIDATES)]
    table = {(n, g): float(rng.uniform(0.5, 2.0)) for n in ns for g in tuples}
    _patch(monkeypatch, "measure_geometry",
           lambda csr, n, geom, **kw: table[(n, geom.as_tuple())])
    ref = PATTERNS["rmat_skewed"]()
    port = _port(ref)
    if cands == "reference":
        # candidates=None: the reference's sweep on both sides ("torch")
        want = ref_tune.autotune_geometry(ref, ns=ns, backend="xla")
        got = tune.autotune_geometry(port, ns=ns, backend="torch")
    else:
        # "hopper" with candidates=None takes HOPPER_CANDIDATES
        want = ref_tune.autotune_geometry(
            ref, ns=ns, backend="pallas",
            candidates=tuple(RefGeometry(*g.as_tuple())
                             for g in tune.HOPPER_CANDIDATES))
        got = tune.autotune_geometry(port, ns=ns, backend="hopper")
        assert all(k.startswith("hopper|") for k, _ in got.geometries)
    assert _strip(got.geometries) == _strip(want.geometries)
    assert len(got.geometries) == 6       # buckets n1 n4 n32 n128 nbig + any
    no_wild = tune.autotune_geometry(port, ns=ns, backend="hopper",
                                     include_wildcard=False)
    assert not any(k.endswith("|any") for k, _ in no_wild.geometries)


@pytest.mark.parametrize("table_kind", ["seeded0", "seeded1", "never", "first"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_autotune_quant_matches_reference_on_fake_times(monkeypatch,
                                                        table_kind, mode):
    ns = (1, 4, 8, 32, 128)
    if table_kind.startswith("seeded"):
        rng = np.random.default_rng(int(table_kind[-1]))
        table = {(n, q): float(rng.uniform(0.5, 2.0)) for n in ns
                 for q in (None, mode)}
    else:
        coded = 2.0 if table_kind == "never" else 0.5
        table = {(n, q): (coded if q else 1.0) for n in ns for q in (None, mode)}
    _patch(monkeypatch, "measure_quant",
           lambda csr, n, quant=None, **kw: table[(n, quant)])
    ref = PATTERNS["rmat_uniform"]()
    want = ref_tune.autotune_quant(ref, ns=ns, quant=mode, backend="xla")
    got = tune.autotune_quant(_port(ref), ns=ns, quant=mode, backend="hopper")
    assert got.quant_min_n == want.quant_min_n
    assert (got.quant_min_n == tune.QUANT_NEVER) == (table_kind == "never")
    assert tune.QUANT_NEVER == ref_tune.QUANT_NEVER


@pytest.mark.parametrize("table_kind", ["seeded0", "seeded1", "never", "first"])
def test_autotune_chain_matches_reference_on_fake_times(monkeypatch,
                                                        table_kind):
    ns = (1, 8, 32, 128)
    if table_kind.startswith("seeded"):
        rng = np.random.default_rng(10 + int(table_kind[-1]))
        table = {(n, f): float(rng.uniform(0.5, 2.0)) for n in ns
                 for f in (True, False)}
    else:
        fused = 2.0 if table_kind == "never" else 0.5
        table = {(n, f): (fused if f else 1.0) for n in ns for f in (True, False)}
    _patch(monkeypatch, "measure_chain",
           lambda csr, n, d, fused, **kw: table[(n, fused)])
    ref = PATTERNS["rmat_skewed"]()
    want = ref_tune.autotune_chain(ref, ns=ns, d=64)
    got = tune.autotune_chain(_port(ref), ns=ns, d=64)
    assert got.chain_fuse_min_n == want.chain_fuse_min_n
    assert (got.chain_fuse_min_n == tune.CHAIN_NEVER) == (table_kind == "never")
    assert tune.CHAIN_NEVER == ref_tune.CHAIN_NEVER


@pytest.mark.parametrize("table_kind", ["seeded0", "seeded1", "never", "first"])
def test_autotune_attention_matches_reference_on_fake_times(monkeypatch,
                                                            table_kind):
    seqs = (512, 128, 256, 1024)           # unsorted: both sort by seq
    if table_kind.startswith("seeded"):
        rng = np.random.default_rng(20 + int(table_kind[-1]))
        table = {(s, f): float(rng.uniform(0.5, 2.0)) for s in seqs
                 for f in (True, False)}
    else:
        fused = 2.0 if table_kind == "never" else 0.5
        table = {(s, f): (fused if f else 1.0) for s in seqs
                 for f in (True, False)}
    _patch(monkeypatch, "measure_attention",
           lambda mask, d, fused, **kw: table[(mask.seq, fused)])
    want = ref_tune.autotune_attention(
        [ref_sliding_window(s, 2, block=64, causal=True) for s in seqs], d=16)
    got = tune.autotune_attention(
        [sliding_window(s, 2, block=64, causal=True) for s in seqs], d=16,
        device="cpu")
    assert got.attn_fuse_min_seq == want.attn_fuse_min_seq
    assert (got.attn_fuse_min_seq == tune.ATTN_NEVER) == (table_kind == "never")
    assert tune.ATTN_NEVER == ref_tune.ATTN_NEVER


# ---------------------------------------------------------------------------
# the tuners timed on the CPU
# ---------------------------------------------------------------------------

def test_autotune_geometry_timed_on_the_cpu():
    """A real sweep on ``"torch"``: every candidate timed by the host clock,
    the tuned plan carries the table's tile, and its output is the
    reference's ``"xla"`` output at that tile."""
    ref = PATTERNS["rmat_skewed"]()
    port = _port(ref)
    timer = tune.Timer()
    cands = (TileGeometry(tile=32), TileGeometry(tile=64),
             TileGeometry(tile=128))
    th = repro_torch.autotune_geometry(port, ns=(4, 32), backend="torch",
                                       candidates=cands, repeats=2,
                                       timer=timer)
    assert len(timer.log) == 6
    assert {e["mode"] for e in timer.log} == {"host"}
    assert all(e["seconds"] > 0 and e["reason"] is None for e in timer.log)
    rng = np.random.default_rng(7)
    for n in (4, 32):
        A = repro_torch.sparse(port, device="cpu", thresholds=th, n_hint=n,
                               cache=False)
        tile = dict(th.geometries)[f"torch|{_key_fp(port)}|n{n}"][0]
        assert A.plan.tile == tile
        x = rng.standard_normal((port.shape[1], n)).astype(np.float32)
        got = A.matmul(torch.from_numpy(x), impl="nb_pr").numpy()
        p_ref = ref_plan(ref, backend="xla", tile=tile)
        want = np.asarray(ref_execute(p_ref, jnp.asarray(x), impl="nb_pr"))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _key_fp(csr) -> str:
    from repro_torch.core.cache import pattern_fingerprint
    return pattern_fingerprint(csr)[:12]


def test_tuners_time_both_arms_on_the_cpu():
    """The quant, chain and attention tuners run their arms on the CPU (the
    wrappers' plain versions): a sentinel or an N of ``ns``, each arm
    logged once an N."""
    port = _port(PATTERNS["rmat_uniform"]())
    timer = tune.Timer()
    th = repro_torch.autotune_quant(port, ns=(1, 8), repeats=1, timer=timer)
    assert th.quant_min_n in (1, 8, tune.QUANT_NEVER)
    th = repro_torch.autotune_chain(port, ns=(1, 8), d=8, repeats=1,
                                    timer=timer)
    assert th.chain_fuse_min_n in (1, 8, tune.CHAIN_NEVER)
    specs = [sliding_window(128, 1, block=16, causal=True)]
    for bias in (False, True):
        th = repro_torch.autotune_attention(specs, d=8, repeats=1, bias=bias,
                                            device="cpu", timer=timer)
        assert th.attn_fuse_min_seq in (128, tune.ATTN_NEVER)
    keys = [e["key"] for e in timer.log]
    assert len(keys) == len(set(keys))
    assert all(k.split("|")[0] in ("quant", "chain", "attention") for k in keys)
    assert {e["mode"] for e in timer.log} == {"host"}


def test_measure_chain_and_attention_arms_agree_on_the_cpu():
    """Both arms of each gate compute the same product (the timed calls are
    the real ones): the chain's fused and unfused calls, and attention's,
    give one output within 1e-5."""
    from repro_torch.core.plan import execute_attention, execute_chain, plan
    port = _port(PATTERNS["rmat_skewed"]())
    x = torch.randn(port.shape[1], 8, generator=torch.Generator().manual_seed(0))
    a = torch.randn(port.shape[0], 4, generator=torch.Generator().manual_seed(1))
    outs = []
    for gate in (1, tune.CHAIN_NEVER):
        th = dataclasses.replace(SelectorThresholds(), chain_fuse_min_n=gate)
        p = plan(port, backend="hopper", thresholds=th, chain_op="softmax")
        outs.append(execute_chain(p, a, a[:port.shape[1]], x,
                                  transform="softmax"))
    assert torch.allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    mask = build_mask(sliding_window(128, 1, block=16, causal=True))
    q = torch.randn(128, 8, generator=torch.Generator().manual_seed(2))
    bias = tune._alibi(mask.csr)
    outs = []
    for gate in (1, tune.ATTN_NEVER):
        th = dataclasses.replace(SelectorThresholds(), attn_fuse_min_seq=gate)
        p = plan(mask.csr, backend="hopper", thresholds=th, chain_op="attn")
        outs.append(execute_attention(p, q, q, q, bias=bias))
    assert torch.allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    rows = np.repeat(np.arange(128), np.diff(mask.csr.indptr.numpy()))
    want = -(rows - mask.csr.indices.numpy()) * 2.0 ** -6
    np.testing.assert_array_equal(bias.numpy(), want.astype(np.float32))


# ---------------------------------------------------------------------------
# thresholds files across the packages; the sharded tuners refuse
# ---------------------------------------------------------------------------

def test_hopper_geometries_cross_between_the_packages(tmp_path):
    port = _port(PATTERNS["rmat_skewed"]())
    fp = _key_fp(port)
    th = dataclasses.replace(SelectorThresholds(), quant_min_n=32,
                             chain_fuse_min_n=8)
    th = th.with_geometry(f"hopper|{fp}|n4", TileGeometry(tile=4096))
    th = th.with_geometry(f"hopper|{fp}|any", TileGeometry(tile=128))
    path = str(tmp_path / "port.json")
    save_thresholds(th, path)
    ref_th = ref_load_thresholds(path)
    assert dict(ref_th.geometries) == dict(th.geometries)
    assert (ref_th.quant_min_n, ref_th.chain_fuse_min_n) == (32, 8)
    # and back: a reference file with hopper and pallas entries
    ref_th = ref_th.with_geometry(f"pallas|{fp}|n32",
                                  RefGeometry(tile=8192, wb=32))
    ref_th = dataclasses.replace(ref_th, attn_fuse_min_seq=ref_tune.ATTN_NEVER)
    path2 = str(tmp_path / "ref.json")
    ref_save_thresholds(ref_th, path2)
    back = load_thresholds(path2)
    assert dict(back.geometries) == dict(ref_th.geometries)
    assert back.attn_fuse_min_seq == tune.ATTN_NEVER
    A = repro_torch.sparse(port, device="cpu", backend="hopper",
                           thresholds=back, n_hint=4, cache=False)
    assert A.plan.tile == 4096
    # a hopper entry past the staging limit is refused on the way in
    bad = RefThresholds().with_geometry(f"hopper|{fp}|n4",
                                        RefGeometry(tile=8192))
    ref_save_thresholds(bad, path2)
    with pytest.raises(ValueError, match="hopper"):
        load_thresholds(path2)


@pytest.mark.parametrize("call", ["measure_overlap", "autotune_overlap",
                                  "modeled_traffic_sharded"])
def test_sharded_tuners_refuse(call):
    """The sharded tuners are ported: the ring and the psum timed on a mesh
    of four CPU shards, the crossover one of ``ns`` or ``OVERLAP_NEVER``
    (widths of one ring chunk skipped), and the per-shard byte model equal
    to the reference's on the same partition."""
    from repro.core.shard import build_sharded_substrate as ref_build
    from repro.core.shard import make_shard_spec as ref_spec
    from repro.core.stats import matrix_stats as ref_stats
    from repro_torch.core import shard
    from repro_torch.core.stats import matrix_stats
    from repro_torch.launch import make_local_mesh
    mesh = make_local_mesh(4, 1, devices=["cpu"] * 4)
    ref_csr = PATTERNS["rmat_skewed"]()
    csr = _port(ref_csr)
    if call == "measure_overlap":
        for chunked in (True, False):
            t = tune.measure_overlap(csr, mesh, 256, chunked=chunked, repeats=1)
            assert math.isfinite(t) and t > 0
    elif call == "autotune_overlap":
        th = repro_torch.autotune_overlap(csr, mesh, ns=(128, 256), repeats=1)
        assert th.overlap_min_n in (256, tune.OVERLAP_NEVER)
    else:
        class FakeMesh:
            axis_names, shape = ("data",), {"data": 4}
        ref_sub = ref_build(ref_csr, ref_spec(ref_stats(ref_csr), FakeMesh(),
                                              kind="nnz"),
                            FakeMesh(), inner_kind="balanced", tile=64,
                            inner_backend="xla")
        sub = shard.build_sharded_substrate(
            csr, shard.make_shard_spec(matrix_stats(csr), mesh, kind="nnz"),
            mesh, inner_kind="balanced", tile=64, inner_backend="torch")
        assert tune.modeled_traffic_sharded(sub, 128) == \
            ref_tune.modeled_traffic_sharded(ref_sub, 128)


def test_timer_logs_each_entry_on_the_cpu():
    timer = tune.Timer()
    calls = []
    t = timer(lambda: calls.append(1), "cpu", 3, "k")
    assert len(calls) == 4 and t >= 0 and math.isfinite(t)   # warm-up + 3
    assert timer.log == [{"key": "k", "seconds": t, "mode": "host",
                          "reason": None}]
    assert timer.modes() == {"k": "host"}
