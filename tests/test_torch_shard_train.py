"""The port's sharded chain family, ring, pattern entry and training pieces
against the reference's (mirrors ``tests/test_sharded_fused.py``,
``tests/test_shard_backend.py``, ``tests/test_sharding.py`` and
``tests/test_train.py``'s int8 all-reduce): the sharded SDDMM, softmax
chain (the cross-shard merge) and attention without a bias, their
gradients, the overlapped ring, ``execute_pattern_sharded`` and
``make_dp_compressed_allreduce`` at 4 shards against the reference's own
sharded run (a subprocess with four host devices, as
``tests/test_torch_shard.py``), and the sharding rules, the sparse layers'
routing and ``sparse_weight_shardings`` on meshes of CPU shards."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.formats import csr_to_balanced as ref_csr_to_balanced
from repro.launch import sharding_rules as ref_rules
import repro_torch
from repro_torch.core import formats, shard
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import PATTERN_PREP
from repro_torch.launch import (SPARSE_WEIGHT_RULES, TRAIN_RULES,
                                NamedSharding, PartitionSpec,
                                check_divisibility, make_local_mesh,
                                make_sharding_fn, partition_spec,
                                resolve_rules)
from repro_torch.models import sharding_ctx
from repro_torch.models.layers import SparsePattern, sparse_mlp_apply
from repro_torch.train import (compressed_psum_grads,
                               make_dp_compressed_allreduce,
                               sparse_weight_shardings)

from test_torch_shard import (KINDS, REF_PRELUDE, _close, _mesh, _port,
                              _skewed, finish_reference, start_reference)

REF_TRAIN = REF_PRELUDE + r'''
from repro.core import csr_to_balanced, execute, execute_pattern, plan
from repro.core.plan import execute_attention, execute_chain, execute_sddmm
from repro.train.manual_collectives import make_dp_compressed_allreduce
a, b, xc, gc, ge = (jnp.asarray(inp[k]) for k in ("a", "b", "xc", "gc", "ge"))
for kind in ("row", "nnz"):
    p = plan(csr, backend="sharded", mesh=mesh, shard_kind=kind,
             inner_backend="xla", tile=16)
    e, pull = jax.vjp(lambda aa, bb: execute_sddmm(p, aa, bb), a, b)
    out[f"{kind}/sddmm/y"] = e
    out[f"{kind}/sddmm/da"], out[f"{kind}/sddmm/db"] = pull(ge)
    y, pull = jax.vjp(lambda aa, bb, xx: execute_chain(
        p, aa, bb, xx, transform="softmax", alpha=0.5), a, b, xc)
    out[f"{kind}/softmax/y"] = y
    (out[f"{kind}/softmax/da"], out[f"{kind}/softmax/db"],
     out[f"{kind}/softmax/dx"]) = pull(gc)
    out[f"{kind}/identity/y"] = execute_chain(p, a, b, xc, transform="identity")
    out[f"{kind}/attn/y"] = execute_attention(p, a, b, xc)
pr = plan(csr, backend="sharded", mesh=mesh, shard_kind="nnz",
          inner_backend="xla", tile=16,
          thresholds=SelectorThresholds(overlap_min_n=1))
out["ring/y"] = execute(pr, jnp.asarray(inp["xr"]), impl="nb_pr")
bal = csr_to_balanced(csr, 16)
y, pull = jax.vjp(lambda vv, xx: execute_pattern(
    bal.rows, bal.cols, vv, bal.shape, xx, mesh=mesh, impl="nb_pr"),
    bal.vals.reshape(-1), jnp.asarray(inp["xp"]))
out["pattern/y"] = y
out["pattern/dv"], out["pattern/dx"] = pull(jnp.asarray(inp["gp"]))
mean, res = make_dp_compressed_allreduce(mesh, "data")(
    {"w": jnp.asarray(inp["grads"])}, {"w": jnp.asarray(inp["res"])})
out["dp/mean"], out["dp/res"] = mean["w"], res["w"]
np.savez(sys.argv[2], **{k: np.asarray(o) for k, o in out.items()})
'''


def _inputs() -> dict:
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"a": f(64, 4), "b": f(64, 4), "xc": f(64, 5), "gc": f(64, 5),
            "ge": f(_skewed().nnz), "xr": f(64, 300), "xp": f(64, 6),
            "gp": f(64, 6), "grads": f(4, 8, 16),
            "res": 0.01 * f(4, 8, 16)}


@pytest.fixture(scope="module", autouse=True)
def _ref_started(tmp_path_factory):
    started = start_reference(REF_TRAIN, _inputs(),
                              tmp_path_factory.mktemp("shard_train_ref"))
    yield started
    if started[0].poll() is None:
        started[0].kill()
        started[0].communicate()


@pytest.fixture(scope="module")
def ref_out(_ref_started):
    return finish_reference(_ref_started)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


# ---------------------------------------------------------------------------
# the sharding rules and the sharding context
# ---------------------------------------------------------------------------

def test_rules_match_reference():
    class FakeMesh:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 4, "model": 2}

    assert TRAIN_RULES == ref_rules.TRAIN_RULES
    assert SPARSE_WEIGHT_RULES == ref_rules.SPARSE_WEIGHT_RULES
    assert ref_rules.LONG_CTX_OVERRIDES == resolve_rules(
        {}, ref_rules.LONG_CTX_OVERRIDES)
    rules = resolve_rules(overrides=SPARSE_WEIGHT_RULES)
    assert rules == ref_rules.resolve_rules(
        overrides=ref_rules.SPARSE_WEIGHT_RULES)
    for logical in (("batch", "embed"), ("tokens", None), ("tiles", "nnz"),
                    (None, "heads", "head_dim"), ("layers", "ff", "embed")):
        got = partition_spec(logical, rules, FakeMesh())
        want = ref_rules.partition_spec(logical, rules, FakeMesh())
        assert isinstance(got, PartitionSpec) and tuple(got) == tuple(want)
        for shape in ((8, 6), (4, 12), (3, 4, 8)):
            assert check_divisibility(shape[:len(got)], got, FakeMesh()) == \
                ref_rules.check_divisibility(shape[:len(got)], want, FakeMesh())
    mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    sh = make_sharding_fn(mesh)(("batch", "heads"))
    assert sh == NamedSharding(mesh, PartitionSpec("data", "model"))


def test_constrain_divisibility_fallback():
    """24 heads on model=16 fall back to unsharded and do not raise (the
    reference test's contract)."""
    mesh = make_local_mesh(1, 16, devices=["cpu"] * 16)
    with sharding_ctx.activation_sharding(mesh, resolve_rules()):
        x = torch.ones(2, 24, 8)
        out = sharding_ctx.constrain(x, (None, "heads", None)) * 2
        assert out.shape == (2, 24, 8)
        assert sharding_ctx.sparse_shard() == (None, None)   # no marker


def test_sparse_weight_shardings():
    n = 4
    mesh = make_local_mesh(n, 1, devices=["cpu"] * n)
    params = {"blocks": {"v_gate": torch.ones(4, n * 2, 16),
                         "v_up": torch.ones(n * 2, 16),
                         "v_odd": torch.ones(n + 1, 16),
                         "w_up": torch.ones(8, 8)}}
    sh = sparse_weight_shardings(params, mesh)
    assert sh["blocks"]["w_up"] is None
    assert sh["blocks"]["v_gate"] == NamedSharding(
        mesh, PartitionSpec(None, "data", None))
    assert sh["blocks"]["v_up"].spec == PartitionSpec("data", None)
    assert sh["blocks"]["v_odd"].spec == PartitionSpec()


def test_sparse_layers_route_through_sharded_backend():
    """``sparse_mlp_apply`` under the sparse-weight marker (tiles split over
    the shards, partials psum) equals the unsharded layer, forward and
    grads, and builds each pattern's split once."""
    rng = np.random.default_rng(4)
    d, f, tile = 16, 24, 8
    pats = {"gate": SparsePattern.random(1, f, d, 0.3, tile, device="cpu"),
            "up": SparsePattern.random(2, f, d, 0.3, tile, device="cpu"),
            "down": SparsePattern.random(3, d, f, 0.3, tile, device="cpu")}
    vals = {f"v_{n}": rng.standard_normal(tuple(pats[n].rows.shape)).astype(
        np.float32) * 0.1 for n in pats}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)

    def run():
        p = {k: _t(v, grad=True) for k, v in vals.items()}
        xx = _t(x, grad=True)
        y = sparse_mlp_apply(pats, p, xx)
        grads = torch.autograd.grad(y.square().sum(), [*p.values(), xx])
        return y, grads

    want, want_g = run()
    mesh = _mesh()
    with sharding_ctx.activation_sharding(
            mesh, resolve_rules(overrides=SPARSE_WEIGHT_RULES)):
        assert sharding_ctx.sparse_shard() == (mesh, "data")
        got, got_g = run()
        before = PATTERN_PREP["builds"]
        run()
        assert PATTERN_PREP["builds"] == before       # the memo holds
    _close(got, want)
    for a, b in zip(got_g, want_g):
        _close(a, b)
    prep = plan_mod.pattern_prep(pats["up"].rows, pats["up"].cols,
                                 pats["up"].shape)
    assert len(prep.shards) == 1


def test_pattern_split_follows_the_pattern_objects():
    """The per-shard split is memoised on the pattern's identity and
    version: an in-place write to ``rows`` makes a new split."""
    csr = _port(_skewed())
    bal = formats.csr_to_balanced(csr, 16)
    rows, x = bal.rows.clone(), torch.randn(64, 3)
    y0 = plan_mod.execute_pattern(rows, bal.cols, bal.vals, bal.shape, x,
                                  mesh=_mesh())
    p0 = plan_mod.pattern_prep(rows, bal.cols, bal.shape)
    assert len(p0.shards) == 1
    rows.copy_(bal.rows)
    y1 = plan_mod.execute_pattern(rows, bal.cols, bal.vals, bal.shape, x,
                                  mesh=_mesh())
    assert plan_mod.pattern_prep(rows, bal.cols, bal.shape) is not p0
    _close(y1, y0)


def test_dp_compressed_allreduce_matches_mean():
    """The int8 + EF all-reduce equals the numpy mirror of the wire protocol
    (per-shard int8 encode, int32 sum, one decode with the mean scale) and
    stays within quantization distance of the f32 mean (the reference
    test's bound); the residuals carry the per-shard remainder."""
    n = 4
    rng = np.random.default_rng(0)
    g_np = rng.standard_normal((n, 8)).astype(np.float32)
    mean, res = make_dp_compressed_allreduce(_mesh(n), "data")(
        {"w": _t(g_np)}, {"w": torch.zeros(n, 8)})
    scales = np.maximum(np.abs(g_np).max(axis=1), 1e-30) / 127.0
    q = np.clip(np.round(g_np / scales[:, None]), -127, 127)
    want = (q.sum(axis=0) * scales.mean()) / n
    np.testing.assert_allclose(mean["w"].numpy(), want, rtol=1e-5)
    bound = (127 * np.abs(scales - scales.mean()).sum()
             + scales.sum() / 2) / n
    np.testing.assert_allclose(want, g_np.mean(axis=0), atol=float(bound))
    np.testing.assert_allclose(res["w"].numpy(), g_np - q * scales[:, None],
                               atol=1e-6)
    got, _ = compressed_psum_grads({"w": _t(g_np)}, {"w": torch.zeros(n, 8)},
                                   shard.shard_devices(_mesh(n), "data"))
    assert torch.equal(got["w"], mean["w"])


# ---------------------------------------------------------------------------
# against the reference's sharded run (four host devices)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", ("torch", "hopper"))
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_chain_family_matches_reference(ref_out, kind, inner):
    inp = _inputs()
    csr = _port(_skewed())
    p = plan_mod.plan(csr, mesh=_mesh(), shard_kind=kind, inner_backend=inner,
                      tile=16)
    a, b, xc = (_t(inp[k], grad=True) for k in ("a", "b", "xc"))
    e = plan_mod.execute_sddmm(p, a, b)
    da, db = torch.autograd.grad((e * _t(inp["ge"])).sum(), (a, b))
    for got, key in ((e, "y"), (da, "da"), (db, "db")):
        _close(got, ref_out[f"{kind}/sddmm/{key}"])
    y = plan_mod.execute_chain(p, a, b, xc, transform="softmax", alpha=0.5)
    grads = torch.autograd.grad((y * _t(inp["gc"])).sum(), (a, b, xc))
    _close(y, ref_out[f"{kind}/softmax/y"])
    for got, key in zip(grads, ("da", "db", "dx")):
        _close(got, ref_out[f"{kind}/softmax/{key}"])
    _close(plan_mod.execute_chain(p, a, b, xc, transform="identity"),
           ref_out[f"{kind}/identity/y"])
    _close(plan_mod.execute_attention(p, a, b, xc), ref_out[f"{kind}/attn/y"])


@pytest.mark.parametrize("inner", ("torch", "hopper"))
def test_ring_matches_reference_and_the_blocking_psum(ref_out, inner):
    """The overlapped ring (``overlap_min_n=1``: three chunks of 128 columns
    at N = 300) against the reference's ring, and against the port's
    blocking psum in value and gradient (another sum order: 1e-5)."""
    csr = _port(_skewed())
    x = _t(_inputs()["xr"], grad=True)
    ring = plan_mod.plan(csr, mesh=_mesh(), shard_kind="nnz", tile=16,
                         inner_backend=inner,
                         thresholds=repro_torch.SelectorThresholds(
                             overlap_min_n=1))
    psum = plan_mod.plan(csr, mesh=_mesh(), shard_kind="nnz", tile=16,
                         inner_backend=inner)
    y = plan_mod.execute(ring, x, impl="nb_pr")
    _close(y, ref_out["ring/y"])
    y_psum = plan_mod.execute(psum, x, impl="nb_pr")
    _close(y, y_psum)
    g = torch.randn_like(y)
    _close(torch.autograd.grad((y * g).sum(), x)[0],
           torch.autograd.grad((y_psum * g).sum(), x)[0])
    # the ring is taken only past the cutoff and for psum plans
    calls = []
    orig = shard._overlapped_ring
    shard._overlapped_ring = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        plan_mod.execute(ring, x.detach()[:, :128], impl="nb_pr")
        plan_mod.execute(psum, x.detach(), impl="nb_pr")
        plan_mod.execute(dataclasses.replace(ring), x.detach(), impl="nb_pr")
    finally:
        shard._overlapped_ring = orig
    assert calls == [1]


def test_execute_pattern_sharded_matches_reference(ref_out):
    inp = _inputs()
    ref_bal = ref_csr_to_balanced(_skewed(), 16)
    rows, cols = (torch.from_numpy(np.array(a)) for a in (ref_bal.rows,
                                                          ref_bal.cols))
    v = _t(np.asarray(ref_bal.vals).reshape(-1), grad=True)
    x = _t(inp["xp"], grad=True)
    y = plan_mod.execute_pattern(rows, cols, v, ref_bal.shape, x,
                                 mesh=_mesh(), impl="nb_pr")
    dv, dx = torch.autograd.grad((y * _t(inp["gp"])).sum(), (v, x))
    _close(y, ref_out["pattern/y"])
    _close(dv, ref_out["pattern/dv"])
    _close(dx, ref_out["pattern/dx"])
    # backend="sharded" without a mesh argument's value is a usage error
    with pytest.raises(ValueError, match="mesh"):
        plan_mod.execute_pattern(rows, cols, v, ref_bal.shape, x,
                                 backend="sharded")


def test_dp_compressed_allreduce_matches_reference(ref_out):
    inp = _inputs()
    fn = make_dp_compressed_allreduce(_mesh(), "data")
    mean, res = fn({"w": _t(inp["grads"])}, {"w": _t(inp["res"])})
    _close(mean["w"], ref_out["dp/mean"])
    _close(res["w"], ref_out["dp/res"])
