"""The port's sharded backend (``repro_torch.core.shard``) against the
reference's, on meshes of CPU shards (mirrors ``tests/test_shard_backend.py``
and ``tests/test_sharded_fused.py``): the partitioner's choice and
invariants, the per-shard substrates and visit stacks element for element
(the reference's spec-only ``_FakeMesh``), the four matmul kernels' outputs
and gradients at 4 shards against the reference's own sharded run, the
facade (``sparse(mesh=)``, ``use_mesh``, ``.shard``), the plan key, the
guardrails' ``sharded/torch-inner`` rung, artifacts, quantized shards and
the spill inner.

The reference's sharded outputs come from one subprocess a module, which runs
``repro`` with four virtual host devices (``XLA_FLAGS=--xla_force_host_
platform_device_count=4``; the tests' own process keeps one).  It starts
when the module's first test does and is read by the tests that need it,
which come last."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import csr_from_dense as ref_csr_from_dense
from repro.core import rmat as ref_rmat
from repro.core.shard import VISIT_PAD as REF_VISIT_PAD
from repro.core.shard import build_sharded_substrate as ref_build
from repro.core.shard import make_shard_spec as ref_make_spec
from repro.core.shard import stack_visit_schedules as ref_stack_visits
from repro.core.stats import matrix_stats as ref_stats
from repro.kernels.vsr import plan_visits as ref_plan_visits
import repro_torch
from repro_torch import api, interop
from repro_torch.core import formats, registry, shard
from repro_torch.core import plan as plan_mod
from repro_torch.core.cache import mesh_signature, pattern_fingerprint, plan_key
from repro_torch.core.guardrails import HEALTH
from repro_torch.core.selector import (SelectorThresholds, load_thresholds,
                                       save_thresholds, select_partition)
from repro_torch.core.stats import matrix_stats
from repro_torch.kernels.vsr import plan_visits
from repro_torch.launch import make_local_mesh
from repro_torch.runtime.faults import FaultInjector, FaultSpec, inject_faults

from _hypothesis_compat import given, settings, st
from conftest import random_csr

SRC = str(Path(__file__).resolve().parent.parent / "src")
KINDS = ("row", "nnz")
INNERS = ("torch", "hopper")     # "hopper" runs the kernels' plain versions here


class _FakeMesh:
    """Spec-building only (axis_names + shape): the reference's stand-in."""

    def __init__(self, n):
        self.axis_names = ("data",)
        self.shape = {"data": n}


def _mesh(n: int = 4):
    return make_local_mesh(n, 1, devices=["cpu"] * n)


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr),
                                   np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _skewed():
    return ref_rmat(6, 8, 0.57, 0.19, 0.19, seed=3)


def _close(got, want, rtol=1e-5):
    got, want = (t.detach().numpy() if isinstance(t, torch.Tensor) else t
                 for t in (got, want))
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the reference's sharded run, in a subprocess with four host devices
# ---------------------------------------------------------------------------

#: jax.make_mesh with Auto axes: under this jax the default Explicit axes
#: refuse the reference's gradients outside a mesh context
REF_PRELUDE = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import MATMUL_KERNELS, SelectorThresholds, rmat
inp = dict(np.load(sys.argv[1]))
assert jax.device_count() == 4, jax.devices()
mesh = jax.make_mesh((4, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
csr = rmat(6, 8, 0.57, 0.19, 0.19, seed=3)
out = {}
'''

REF_MATMUL = REF_PRELUDE + r'''
from repro.core import execute, plan
x, v, g = (jnp.asarray(inp[k]) for k in ("x", "v", "g"))
for kind in ("row", "nnz"):
    p = plan(csr, backend="sharded", mesh=mesh, shard_kind=kind,
             inner_backend="xla", tile=16)
    for impl in MATMUL_KERNELS:
        y, pull = jax.vjp(lambda vv, xx: execute(p, xx, vals=vv, impl=impl),
                          v, x)
        out[f"{kind}/{impl}/y"] = y
        out[f"{kind}/{impl}/dv"], out[f"{kind}/{impl}/dx"] = pull(g)
    out[f"{kind}/nb_pr/y1"] = execute(p, x[:, 0], impl="nb_pr")
np.savez(sys.argv[2], **{k: np.asarray(o) for k, o in out.items()})
'''


def start_reference(script: str, inputs: dict, tmp: Path) -> tuple:
    """Run ``script`` on ``inputs`` (an npz) in a subprocess of ``repro``
    with four host devices; ``finish_reference`` reads its npz."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "in.npz"), str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp / "out.npz"


def finish_reference(started: tuple, timeout: float = 600) -> dict:
    proc, path = started
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


def _matmul_inputs() -> dict:
    rng = np.random.default_rng(0)
    nnz = _skewed().nnz
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(64, 8), "v": f(nnz), "g": f(64, 8)}


@pytest.fixture(scope="module", autouse=True)
def _ref_started(tmp_path_factory):
    started = start_reference(REF_MATMUL, _matmul_inputs(),
                              tmp_path_factory.mktemp("shard_ref"))
    yield started
    if started[0].poll() is None:
        started[0].kill()
        started[0].communicate()


@pytest.fixture(scope="module")
def ref_out(_ref_started):
    return finish_reference(_ref_started)


# ---------------------------------------------------------------------------
# partitioner choice and invariants
# ---------------------------------------------------------------------------

def test_partitioner_choice_follows_cv():
    uniform = formats.csr_from_dense(np.ones((32, 16), np.float32))
    skew = np.zeros((32, 16), np.float32)
    skew[0, :] = 1.0
    skew[1:, 0] = 1.0
    skewed = formats.csr_from_dense(skew)
    th = SelectorThresholds()
    assert select_partition(matrix_stats(uniform), th) == "row"
    assert select_partition(matrix_stats(skewed), th) == "nnz"
    p_u = plan_mod.plan(uniform, mesh=_mesh())
    p_s = plan_mod.plan(skewed, mesh=_mesh())
    assert (p_u.shard_spec.kind, p_u.shard_spec.reduction) == ("row", "concat")
    assert (p_s.shard_spec.kind, p_s.shard_spec.reduction) == ("nnz", "psum")
    assert select_partition(matrix_stats(skewed),
                            SelectorThresholds(partition_cv=1e9)) == "row"


def test_partition_cv_serializes_with_thresholds(tmp_path):
    path = str(tmp_path / "th.json")
    save_thresholds(SelectorThresholds(partition_cv=2.5, overlap_min_n=256),
                    path)
    th = load_thresholds(path)
    assert (th.partition_cv, th.overlap_min_n) == (2.5, 256)
    legacy = '{"version": 1, "n_threshold": 4, "pr_avg_row": 32.0, "sr_cv": 0.5}'
    assert SelectorThresholds.from_json(legacy).partition_cv == 1.0


@settings(max_examples=12, deadline=None)
@given(scale=st.integers(4, 6), ef=st.integers(2, 10),
       seed=st.integers(0, 10_000), n=st.sampled_from([2, 3, 5, 8]),
       tile=st.sampled_from([8, 32, 128]))
def test_nnz_partitioner_invariants(scale, ef, seed, n, tile):
    """nnz shards: quotas differ by at most one nonzero and exactly
    partition the stream."""
    csr = _port(ref_rmat(scale, ef, 0.57, 0.19, 0.19, seed=seed))
    spec = shard.make_shard_spec(matrix_stats(csr), _FakeMesh(n), kind="nnz")
    for inner in ("balanced", "ell"):
        sub = shard.build_sharded_substrate(csr, spec, _FakeMesh(n),
                                            inner_kind=inner, tile=tile,
                                            inner_backend="torch")
        src = sub.stacked("src")
        counts = (src >= 0).reshape(n, -1).sum(axis=1)
        assert counts.max() - counts.min() <= 1, (inner, counts)
        np.testing.assert_array_equal(np.sort(src[src >= 0]),
                                      np.arange(csr.nnz))


@settings(max_examples=8, deadline=None)
@given(m=st.integers(3, 70), k=st.integers(2, 40),
       density=st.floats(0.02, 0.5), n=st.sampled_from([2, 4, 8]))
def test_row_partitioner_invariants(m, k, density, n):
    """Row shards tile [0, M); every nonzero lands in exactly one slot."""
    rng = np.random.default_rng(m * 1000 + k)
    csr = _port(random_csr(rng, m, k, density)[0])
    spec = shard.make_shard_spec(matrix_stats(csr), _FakeMesh(n), kind="row")
    assert spec.bounds[0] == 0 and spec.bounds[-1] == m
    assert all(b1 - b0 <= spec.m_pad
               for b0, b1 in zip(spec.bounds, spec.bounds[1:]))
    for inner in ("balanced", "ell"):
        sub = shard.build_sharded_substrate(csr, spec, _FakeMesh(n),
                                            inner_kind=inner, tile=16,
                                            inner_backend="torch")
        src = sub.stacked("src")
        np.testing.assert_array_equal(np.sort(src[src >= 0]),
                                      np.arange(csr.nnz))


# ---------------------------------------------------------------------------
# the substrates and visit stacks, element for element
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("inner", ["balanced", "ell"])
@pytest.mark.parametrize("kind", KINDS)
def test_substrates_match_reference(kind, inner, quant):
    ref_csr = _skewed()
    csr = _port(ref_csr)
    spec = shard.make_shard_spec(matrix_stats(csr), _FakeMesh(4), kind=kind)
    want_spec = ref_make_spec(ref_stats(ref_csr), _FakeMesh(4), kind=kind)
    assert (spec.kind, spec.axis, spec.n_shards, spec.reduction, spec.bounds,
            spec.m_pad) == (want_spec.kind, want_spec.axis, want_spec.n_shards,
                            want_spec.reduction, want_spec.bounds,
                            want_spec.m_pad)
    sub = shard.build_sharded_substrate(csr, spec, _mesh(), inner_kind=inner,
                                        tile=16, inner_backend="torch",
                                        quant=quant)
    ref = ref_build(ref_csr, want_spec, _FakeMesh(4), inner_kind=inner,
                    tile=16, inner_backend="xla", quant=quant)
    assert (sub.inner_shape, sub.shape, sub.quant) == (
        ref.inner_shape, ref.shape, ref.quant)
    for name in ("rows", "cols", "vals", "lens", "src", "scales"):
        got, want = sub.stacked(name), getattr(ref, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert all(t.device == torch.device("cpu") for t in sub.cols)
    assert sub.nnz == csr.nnz


def test_stack_visit_schedules_match_reference():
    """Per-shard visit schedules of a ragged row split (the TPU's prep)
    stacked with no-op padding, as the reference stacks them."""
    ref_csr = ref_rmat(7, 8, 0.57, 0.19, 0.19, seed=3)
    csr = _port(ref_csr)
    spec = shard.make_shard_spec(matrix_stats(csr), _FakeMesh(8), kind="row")
    sub = shard.build_sharded_substrate(csr, spec, _FakeMesh(8),
                                        inner_kind="balanced", tile=32,
                                        inner_backend="torch")
    ref = ref_build(ref_csr, ref_make_spec(ref_stats(ref_csr), _FakeMesh(8),
                                           kind="row"),
                    _FakeMesh(8), inner_kind="balanced", tile=32,
                    inner_backend="pallas")
    per = [plan_visits(sub.local(s), 8) for s in range(8)]
    ref_per = [ref_plan_visits(formats_ref_balanced(ref, s), 8)
               for s in range(8)]
    for ours, theirs in zip(per, ref_per):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
    got, want = shard.stack_visit_schedules(per), ref_stack_visits(ref_per)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert shard.VISIT_PAD == REF_VISIT_PAD
    assert len({len(t) for t, _, _ in per}) > 1      # the ragged case
    vmax = max(len(t) for t, _, _ in per)
    assert got[0].shape == (8, vmax)


def formats_ref_balanced(ref_sub, s):
    from repro.core.formats import BalancedCOO as RefBalanced
    return RefBalanced(np.asarray(ref_sub.rows)[s], np.asarray(ref_sub.cols)[s],
                       np.asarray(ref_sub.vals)[s], ref_sub.inner_shape)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_collectives_and_ring():
    parts = [torch.full((3,), float(s + 1)) for s in range(4)]
    assert all(torch.equal(t, torch.full((3,), 10.0)) for t in shard.psum(parts))
    assert all(torch.equal(t, torch.full((3,), 4.0)) for t in shard.pmax(parts))
    moved = shard.ppermute(parts, [(0, 1), (1, 2), (2, 3), (3, 0)])
    assert [float(t[0]) for t in moved] == [4.0, 1.0, 2.0, 3.0]
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
             for _ in range(4)]
    for got in shard._ring_psum(parts):
        _close(got, shard.psum(parts)[0])


# ---------------------------------------------------------------------------
# the facade, the plan key, the guardrails, artifacts
# ---------------------------------------------------------------------------

def test_facade_use_mesh_and_shard():
    csr = _port(_skewed())
    mesh = _mesh()
    cache = repro_torch.PlanCache()
    A = api.sparse(csr, mesh=mesh, cache=cache)
    assert A.backend == "sharded" and A.device == torch.device("cpu")
    assert A.plan.inner_backend == "torch" and A.plan.mesh == mesh
    with api.use_mesh(mesh):
        assert api.scoped_mesh() == (mesh, None)
        assert api.sparse(csr, cache=cache).plan is A.plan
    with api.use_mesh(mesh, axis="model"):
        assert api.sparse(csr, cache=cache).plan.shard_spec.n_shards == 1
    assert api.scoped_mesh() == (None, None)
    x = torch.randn(64, 3)
    want = api.sparse(csr, device="cpu", cache=cache) @ x
    _close(A @ x, want)
    R = api.sparse(csr, device="cpu", cache=cache).shard(mesh, kind="row")
    assert R.plan.shard_spec.kind == "row"
    _close(R @ x, want)
    with api.use_mesh(mesh):
        assert api.sparse(csr, device="cpu", cache=cache).shard().plan is A.plan
    with pytest.raises(ValueError, match="mesh"):
        api.sparse(csr, device="cpu", cache=cache).shard()
    th = SelectorThresholds(n_threshold=2)
    assert A.with_thresholds(th).plan.shard_spec == A.plan.shard_spec
    v = csr.data * 2
    _close(A.with_values(v) @ x, 2 * want)
    art = A.with_values(v).finalize(3)
    assert art.meta.shard_spec == A.plan.shard_spec and art.meta.mesh == mesh
    _close(repro_torch.execute(art, x), 2 * want)


def test_plan_key_with_and_without_a_mesh():
    csr = _port(_skewed())
    th = SelectorThresholds()
    key = plan_key(csr, backend="torch", device=csr.device, thresholds=th)
    assert key == ("plan", pattern_fingerprint(csr), (64, 64), "torch", "cpu",
                   plan_mod.dataclasses.astuple(th), 512, (8, 128), ())
    on_cpu = plan_key(csr, backend="sharded", device=csr.device,
                      thresholds=th, mesh=_mesh())
    on_card = plan_key(csr, backend="sharded", device=csr.device,
                       thresholds=th,
                       mesh=make_local_mesh(4, 1, devices=["cuda:0"] * 4))
    assert on_cpu[:-1] == on_card[:-1] == key[:3] + ("sharded",) + key[4:]
    assert on_cpu[-1] == ("mesh", mesh_signature(_mesh()))
    assert mesh_signature(_mesh()) == (("data", "model"), (4, 1),
                                       ("cpu",) * 4)
    assert on_cpu != on_card and mesh_signature(None) is None
    cache = repro_torch.PlanCache()
    a = api.sparse(csr, mesh=_mesh(), cache=cache)
    b = api.sparse(csr, mesh=_mesh(2), cache=cache)
    c = api.sparse(csr, device="cpu", cache=cache)
    assert len({id(a.plan), id(b.plan), id(c.plan)}) == 3
    assert api.sparse(csr, mesh=_mesh(), cache=cache).plan is a.plan


def test_guardrails_reroute_to_the_torch_inner():
    csr = _port(_skewed())
    p = plan_mod.plan(csr, mesh=_mesh(), inner_backend="hopper")
    want = plan_mod.execute(plan_mod.plan(csr, mesh=_mesh(),
                                          inner_backend="torch"),
                            torch.randn(64, 3).fill_(1.0))
    HEALTH.reset()
    with inject_faults(FaultInjector({"kernel_execute:sharded":
                                      FaultSpec(fail=1)})):
        got = plan_mod.execute(p, torch.ones(64, 3))
    counters = HEALTH.snapshot()["counters"]
    assert counters.get("kernel_reroute:sharded->sharded/torch-inner:"
                        f"{p.select(3)}") == 1
    _close(got, want)
    assert plan_mod._demoted_inner(p).inner_backend == "torch"
    assert plan_mod._demoted_inner(p) is plan_mod._demoted_inner(p)
    # a plan whose inner is "torch" already has no rung below
    pt = plan_mod.plan(csr, mesh=_mesh(), inner_backend="torch")
    with inject_faults(FaultInjector({"kernel_execute:sharded":
                                      FaultSpec(fail=1)})):
        with pytest.raises(Exception):
            plan_mod.execute(pt, torch.ones(64, 3))
    HEALTH.reset()


def test_sharded_attention_bias_names_alternatives():
    csr = _port(ref_csr_from_dense(
        (np.random.default_rng(18).random((16, 12)) < 0.3).astype(np.float32)))
    p = plan_mod.plan(csr, mesh=_mesh())
    q, k, v = torch.randn(16, 4), torch.randn(12, 4), torch.randn(12, 3)
    for err in (NotImplementedError, ValueError):
        with pytest.raises(err) as ei:
            plan_mod.execute_attention(p, q, k, v, bias=torch.zeros(csr.nnz))
    msg = str(ei.value)
    assert "supported alternatives" in msg and "drop bias=" in msg
    assert "backend='hopper'" in msg
    _close(plan_mod.execute_attention(p, q, k, v),
           plan_mod.execute_attention(plan_mod.plan(csr, backend="torch"),
                                      q, k, v))


@pytest.mark.parametrize("kind", KINDS)
def test_artifact_equals_its_builder(kind):
    csr = _port(_skewed())
    p = plan_mod.plan(csr, mesh=_mesh(), shard_kind=kind,
                      inner_backend="hopper", tile=16)
    art = p.finalize()
    assert set(art.substrates) == {"shard_ell", "shard_balanced"}
    assert art.meta.backend == "sharded" and art.meta.transposed is None
    leaves, spec = plan_mod.pytree.tree_flatten(art)
    back = plan_mod.pytree.tree_unflatten(leaves, spec)
    x = torch.randn(64, 5, requires_grad=True)
    for impl in registry.MATMUL_KERNELS:
        y = plan_mod.execute(back, x, impl=impl)
        _close(y, plan_mod.execute(p, x, impl=impl))
        gx, = torch.autograd.grad(y.sum(), x)
        _close(gx, torch.autograd.grad(plan_mod.execute(p, x, impl=impl).sum(),
                                       x)[0])
    assert plan_mod.PlanArtifact.__matmul__(art, x.detach()).shape == (64, 5)


def test_quantized_and_spill_shards():
    """An int8 sharded plan reads per-(shard, tile) codes (the NB pin) and
    stays within the codes' error of the f32 product; a live stream on it is
    quantized a shard.  ``spill=True`` runs each shard's spill path (its
    windows computed a shard) and gives the fused path's product."""
    csr = _port(_skewed())
    x = torch.randn(64, 6)
    want = plan_mod.execute(plan_mod.plan(csr, backend="torch"), x)
    q = plan_mod.plan(csr, mesh=_mesh(), shard_kind="nnz", quant="int8",
                      tile=16, inner_backend="hopper")
    assert q.select(1) in ("nb_pr", "nb_sr")
    sub = q.substrate("shard_balanced")
    assert sub.quant == "int8" and sub.vals[0].dtype == torch.int8
    assert tuple(sub.scales[0].shape) == (sub.rows[0].shape[0],)
    rel = float((plan_mod.execute(q, x) - want).abs().max() / want.abs().max())
    assert rel < 2e-2
    live = plan_mod.execute(q, x, vals=csr.data * 3)
    assert float((live - 3 * want).abs().max() / (3 * want).abs().max()) < 2e-2
    s = plan_mod.plan(csr, mesh=_mesh(), shard_kind="nnz", tile=16,
                      inner_backend="hopper")
    fused = plan_mod.execute(s, x, impl="nb_pr")
    s.kernel_opts(s.entry("nb_pr"))["spill"] = True
    _close(plan_mod.execute(s, x, impl="nb_pr"), fused)
    shard.freeze_opts(s.substrate("shard_balanced"),
                      s.kernel_opts(s.entry("nb_pr")))


def test_n_hint_builds_only_the_picked_shard_substrate():
    csr = _port(_skewed())
    p = plan_mod.plan(csr, mesh=_mesh(), shard_kind="nnz", n_hint=8)
    assert p.built_substrates == ("shard_balanced",)
    assert set(p.kernel_opts(p.entry(p.select(8)))) >= {"shards",
                                                          "overlap_min_n"}
    # the shards' own prep dicts: never one object for all shards
    q = plan_mod.plan(csr, mesh=_mesh(), shard_kind="row",
                      inner_backend="hopper", n_hint=8)
    shards = q.kernel_opts(q.entry("chain"))["shards"]
    assert len({id(o["blocks"]) for o in shards}) == 4


# ---------------------------------------------------------------------------
# against the reference's sharded run (four host devices)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("impl", registry.MATMUL_KERNELS)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_matmul_matches_reference(ref_out, kind, impl, inner):
    inp = _matmul_inputs()
    csr = _port(_skewed())
    p = plan_mod.plan(csr, mesh=_mesh(), shard_kind=kind, inner_backend=inner,
                      tile=16)
    v = torch.from_numpy(inp["v"]).requires_grad_()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = plan_mod.execute(p, x, vals=v, impl=impl)
    (y * torch.from_numpy(inp["g"])).sum().backward()
    _close(y, ref_out[f"{kind}/{impl}/y"])
    _close(v.grad, ref_out[f"{kind}/{impl}/dv"])
    _close(x.grad, ref_out[f"{kind}/{impl}/dx"])
    _close(plan_mod.execute(p, x.detach()[:, 0], impl="nb_pr"),
           ref_out[f"{kind}/nb_pr/y1"])
