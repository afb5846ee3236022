"""The port's MoE (``repro_torch.models.moe``) against the reference's, on
the CPU: the router's top-k ids (equal), gates and aux loss; ``moe_spmm``,
``moe_onehot`` and ``moe_sort`` (one group and two) with and without dropped
tokens, forward and grads; the slot order of the patterns ``moe_spmm``
hands the SpMM (K1 on the card needs non-decreasing rows); the pinned half
(``dispatch_plans`` / ``moe_spmm_pinned`` and its cache key); the routing
sink; ``dominant_topology``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: relative inf-norm error 1e-5 for forward outputs, 1e-4 for
grads, float32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.cache import PlanCache as RefPlanCache
from repro.models import moe as ref_moe
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.core.cache import PlanCache
from repro_torch.core.selector import (THRESHOLDS_ENV, SelectorThresholds,
                                       save_thresholds)
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig

CPU = torch.device("cpu")
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _case(e=8, k=2, d=32, f=16, t=12, cf=4.0, seed=0):
    """(reference cfg, port cfg, numpy params, numpy x)."""
    rng = np.random.default_rng(seed)
    p = {name: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for name, s in (("w_router", (d, e)), ("w_up", (e, d, f)),
                         ("w_gate", (e, d, f)), ("w_down", (e, f, d)))}
    x = rng.standard_normal((t, d)).astype(np.float32)
    return (RefMoEConfig(e, k, f, capacity_factor=cf),
            MoEConfig(e, k, f, capacity_factor=cf), p, x)


def _jax(p, x):
    return {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)


def _torch(p, x, grad=False):
    tp = {k: torch.from_numpy(v).requires_grad_(grad) for k, v in p.items()}
    return tp, torch.from_numpy(x).requires_grad_(grad)


#: a case where tokens drop: 96 choices over 4 experts, 16 slots each
DROP = dict(e=4, t=48, cf=0.5)

#: (name, port function, reference function) of the dispatch paths
PATHS = {
    "spmm": (moe.moe_spmm, ref_moe.moe_spmm),
    "onehot": (moe.moe_onehot, ref_moe.moe_onehot),
    "sort_g1": (lambda p, x, c: moe.moe_sort(p, x, c, groups=1),
                lambda p, x, c: ref_moe.moe_sort(p, x, c, groups=1)),
    "sort_g2": (lambda p, x, c: moe.moe_sort(p, x, c, groups=2),
                lambda p, x, c: ref_moe.moe_sort(p, x, c, groups=2)),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("e,k", [(8, 2), (16, 4), (64, 8)])
def test_router_ids_equal_reference(e, k, seed):
    ref_cfg, cfg, p, x = _case(e=e, k=k, t=40, seed=seed)
    jp, jx = _jax(p, x)
    tp, tx = _torch(p, x)
    ref_gate, ref_idx, ref_aux = ref_moe.router(jp, jx, ref_cfg)
    gate, idx, aux = moe.router(tp, tx, cfg)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert _rel(gate, ref_gate) <= FWD_TOL
    assert _rel(aux, ref_aux) <= FWD_TOL


def test_topk_rows_ties_take_the_first_index():
    x = np.array([[0.3, 0.5, 0.5, 0.1, 0.5], [1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.0, -1.0, 2.0, 2.0, -1.0]], np.float32)
    ref_v, ref_i = ref_moe._topk_rows(jnp.asarray(x), 3)
    v, i = moe._topk_rows(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy()[1], [0, 1, 2])


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", [dict(t=16), DROP], ids=["no_drop", "drops"])
def test_dispatch_paths_match_reference(path, case):
    """Forward and grads (x and every weight, the router's through the
    gates and the aux loss) against the reference's same path, with and
    without dropped tokens."""
    fn, ref_fn = PATHS[path]
    ref_cfg, cfg, p, x = _case(**case)
    assert _drops(p, x, cfg) == (case is DROP)
    jp, jx = _jax(p, x)

    def ref_loss(pp, xx):
        y, aux = ref_fn(pp, xx, ref_cfg)
        return jnp.sum(y * jnp.cos(jnp.arange(y.size).reshape(y.shape))) + aux
    ref_y, ref_aux = ref_fn(jp, jx, ref_cfg)
    ref_gp, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(jp, jx)
    tp, tx = _torch(p, x, grad=True)
    y, aux = fn(tp, tx, cfg)
    assert _rel(y, ref_y) <= FWD_TOL
    assert _rel(aux, ref_aux) <= FWD_TOL
    w = torch.cos(torch.arange(y.numel(), dtype=torch.float32)).reshape(y.shape)
    (y * w).sum().add(aux).backward()
    assert _rel(tx.grad, ref_gx) <= GRAD_TOL
    for name in p:
        assert _rel(tp[name].grad, ref_gp[name]) <= GRAD_TOL, name


def _drops(p, x, cfg) -> bool:
    """Whether some expert gets more than ``capacity`` of the tokens."""
    _, idx, _ = moe.router(*_torch(p, x), cfg)
    counts = np.bincount(idx.numpy().reshape(-1), minlength=cfg.num_experts)
    return bool(counts.max() > moe.capacity(x.shape[0], cfg))


def test_spmm_patterns_are_in_slot_order(monkeypatch):
    """The slabs ``moe_spmm`` hands the SpMM: the dispatch's rows are the
    slots, non-decreasing, every dropped entry (row ``e·cap``, the padding
    row) after the kept ones; the combine's rows are the tokens,
    non-decreasing, padding ``t`` last.  K1 on the card writes a run that
    no other tile adds to with a plain store, so this order is what its
    output is right for; the reference's token-order dispatch is not."""
    _, cfg, p, x = _case(**DROP)
    assert _drops(p, x, cfg)
    seen = []
    real = moe.execute_pattern

    def spy(rows, cols, vals, shape, xx, **kw):
        seen.append((rows.clone(), cols.clone(), vals.clone(), shape))
        return real(rows, cols, vals, shape, xx, **kw)
    monkeypatch.setattr(moe, "execute_pattern", spy)
    moe.moe_spmm(*_torch(p, x), cfg)
    (d_rows, d_cols, d_vals, d_shape), (c_rows, _, _, c_shape) = seen
    t, k = x.shape[0], cfg.top_k
    m = d_shape[0]
    assert d_shape == (cfg.num_experts * moe.capacity(t, cfg), t)
    flat = d_rows.reshape(-1)
    assert bool((flat[1:] >= flat[:-1]).all())
    n_pad = int((flat == m).sum())
    assert n_pad > d_rows.numel() - t * k          # the drops, then the tail
    assert bool((flat[flat.numel() - n_pad:] == m).all())
    # every (token, choice) once, a value of 1 each; the tail's are 0
    assert sorted(d_cols.reshape(-1)[:t * k].tolist()) == \
        sorted(np.repeat(np.arange(t), k).tolist())
    assert float(d_vals.sum()) == t * k
    assert c_shape == (t, m + 1)
    flat = c_rows.reshape(-1)
    assert bool((flat[1:] >= flat[:-1]).all())
    assert int(flat[t * k - 1]) == t - 1 and bool((flat[t * k:] == t).all())
    # the reference's dispatch slabs (token order) are not ordered here
    ref_slots = moe._slots(moe.router(*_torch(p, x), cfg)[1].reshape(-1),
                           cfg.num_experts, moe.capacity(t, cfg))
    assert bool((ref_slots[1:] < ref_slots[:-1]).any())


@pytest.mark.parametrize("t", [1, 3, 4, 200])
def test_spmm_tile_follows_token_count(t):
    """``tile = min(512, T·k)``: down to k slots at one token."""
    ref_cfg, cfg, p, x = _case(t=t, e=16, k=4)
    seen = []
    real = moe.execute_pattern

    def spy(rows, *a, **kw):
        seen.append(rows.shape[1])
        return real(rows, *a, **kw)
    moe.execute_pattern, saved = spy, moe.execute_pattern
    try:
        y, _ = moe.moe_spmm(*_torch(p, x), cfg)
    finally:
        moe.execute_pattern = saved
    assert seen == [min(512, t * 4)] * 2
    assert _rel(y, ref_moe.moe_spmm(*_jax(p, x), ref_cfg)[0]) <= FWD_TOL


@pytest.mark.parametrize("dispatch,t,want", [
    ("auto", 4, "onehot"), ("auto", 64, "spmm"), ("spmm", 4, "spmm"),
    ("onehot", 64, "onehot"), ("sort", 4, "spmm")])
def test_moe_apply_selects_the_path(dispatch, t, want):
    ref_cfg, cfg, p, x = _case(t=t)
    ref_cfg = RefMoEConfig(8, 2, 16, capacity_factor=4.0, dispatch=dispatch)
    cfg = MoEConfig(8, 2, 16, capacity_factor=4.0, dispatch=dispatch)
    before = dict(moe.DISPATCH_PATHS)
    xs = x.reshape(2, t // 2, -1)
    y, _ = moe.moe_apply(_torch(p, x)[0], torch.from_numpy(xs), cfg)
    ref_y, _ = ref_moe.moe_apply(_jax(p, x)[0], jnp.asarray(xs), ref_cfg)
    moved = {k: v - before[k] for k, v in moe.DISPATCH_PATHS.items()
             if v != before[k]}
    assert moved == {want: 1}
    assert _rel(y, ref_y) <= FWD_TOL


def _topo(p, x, cfg):
    _, idx, _ = moe.router(*_torch(p, x), cfg)
    return tuple(tuple(int(v) for v in row) for row in idx.numpy())


def test_pinned_dispatch_matches_moe_spmm():
    """Mirror of the reference's ``tests/test_cache.py::
    test_pinned_dispatch_matches_moe_spmm``: the router's own topology
    pinned reproduces ``moe_spmm``; a repeat fetch is a cache hit."""
    _, cfg, p, x = _case(t=6, d=32, f=16, cf=4.0, seed=3)
    tp, tx = _torch(p, x)
    y_ref, _ = moe.moe_spmm(tp, tx, cfg)
    topo = _topo(p, x, cfg)
    cache = PlanCache(capacity=8)
    pinned = moe.dispatch_plans(topo, cfg, cache=cache, n_hint=32, device=CPU)
    y_pin, aux = moe.moe_spmm_pinned(tp, tx, cfg, pinned)
    np.testing.assert_allclose(y_pin.numpy(), y_ref.numpy(), atol=1e-5)
    assert float(aux) == 0.0
    again = moe.dispatch_plans(topo, cfg, cache=cache, n_hint=32, device=CPU)
    assert again is pinned
    assert cache.stats()["builds"] == 1 and cache.stats()["hits"] == 1
    # through moe_apply's scope, and against the reference's pinned path
    with moe.pinned_dispatch(pinned):
        y_scope, _ = moe.moe_apply(tp, tx, cfg)
    assert torch.equal(y_scope, y_pin)
    ref_cfg = RefMoEConfig(8, 2, 16, capacity_factor=4.0)
    ref_pinned = ref_moe.dispatch_plans(topo, ref_cfg, cache=RefPlanCache(8),
                                        n_hint=32)
    want, _ = ref_moe.moe_spmm_pinned(*_jax(p, x), ref_cfg, ref_pinned)
    assert _rel(y_pin, want) <= FWD_TOL
    np.testing.assert_array_equal(pinned.perm.numpy(),
                                  np.asarray(ref_pinned.perm))


def test_pinned_dispatch_with_drops_and_a_foreign_topology():
    """A pinned topology other than the router's (and one that overflows an
    expert's capacity) against the reference's pinned path."""
    _, cfg, p, x = _case(t=12, cf=0.5, seed=4)
    ref_cfg = RefMoEConfig(8, 2, 16, capacity_factor=0.5)
    topo = tuple((0, 1) if i % 3 else (2, 0) for i in range(12))
    pinned = moe.dispatch_plans(topo, cfg, cache=PlanCache(4), device=CPU)
    ref_pinned = ref_moe.dispatch_plans(topo, ref_cfg, cache=RefPlanCache(4))
    assert pinned.cap == ref_pinned.cap and pinned.dispatch.nnz < 24
    y, _ = moe.moe_spmm_pinned(*_torch(p, x), cfg, pinned)
    want, _ = ref_moe.moe_spmm_pinned(*_jax(p, x), ref_cfg, ref_pinned)
    assert _rel(y, want) <= FWD_TOL
    with pytest.raises(ValueError, match="T=12"):
        moe.moe_spmm_pinned(*_torch(p, x[:5]), cfg, pinned)


def test_pinned_dispatch_invalidates_on_recalibration(tmp_path, monkeypatch):
    """Mirror of the reference's ``tests/test_cache.py::
    test_pinned_dispatch_invalidates_on_recalibration``: the thresholds are
    part of the key, so a recalibration rebuilds."""
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=8,
                    capacity_factor=4.0)
    topo = ((0, 1), (2, 3))
    cache = PlanCache(capacity=8)
    first = moe.dispatch_plans(topo, cfg, cache=cache, n_hint=8, device=CPU)
    path = str(tmp_path / "recal.json")
    save_thresholds(SelectorThresholds(n_threshold=64), path)
    monkeypatch.setenv(THRESHOLDS_ENV, path)
    second = moe.dispatch_plans(topo, cfg, cache=cache, n_hint=8, device=CPU)
    assert second is not first
    assert cache.stats()["builds"] == 2
    key, kw = moe.dispatch_plan_spec(topo, cfg, n_hint=8, device=CPU)
    assert kw["thresholds"].n_threshold == 64 and "cpu" in key
    assert kw["backend"] == "torch"


def test_routing_sink_and_drift_scope():
    _, cfg, p, x = _case(t=6, seed=5)
    tp, tx = _torch(p, x)
    sink = moe.RoutingSink()
    with moe.record_routing(sink, 7):
        _, idx, _ = moe.router(tp, tx, cfg)
        moe.router(tp, tx, cfg)
    got = sink.drain_routing(7)
    assert len(got) == 2 and got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], idx.numpy())
    assert sink.drain_routing(7) == []
    topo = _topo(p, x, cfg)
    foreign = tuple((r[0], (r[1] + 1) % 8 if (r[1] + 1) % 8 != r[0]
                     else (r[1] + 2) % 8) for r in topo)
    pinned = moe.dispatch_plans(foreign, cfg, cache=PlanCache(2), device=CPU)
    with moe.drift_scope(sink):
        moe.moe_spmm_pinned(tp, tx, cfg, pinned)
    (match,) = sink.drain_drift()
    assert match.shape == (6,) and np.allclose(match, 0.5)
    moe.moe_spmm_pinned(tp, tx, cfg, pinned)          # scope closed
    assert sink.drain_drift() == []


@pytest.mark.parametrize("arrays,k", [
    ([np.array([[0, 1], [1, 2], [1, 0]]), np.array([[3, 1]])], 2),
    ([np.array([[5, 4, 3, 2]])], 3), ([np.zeros((4, 2), np.int32)], 2),
    ([], 2)])
def test_dominant_topology_matches_reference(arrays, k):
    assert moe.dominant_topology(arrays, 8, k) == \
        ref_moe.dominant_topology(arrays, 8, k)


def test_capacity_and_select_match_reference():
    for t in (1, 3, 8, 64, 2048, 4097):
        for e, k, cf in ((64, 8, 1.25), (8, 2, 8.0), (384, 8, 1.0)):
            cfg, ref_cfg = MoEConfig(e, k, 1, cf), RefMoEConfig(e, k, 1, cf)
            assert moe.capacity(t, cfg) == ref_moe.capacity(t, ref_cfg)
            assert moe.select_dispatch(t, cfg) == \
                ref_moe.select_dispatch(t, ref_cfg)
    # OLMoE-1B-7B's prefill of 4 x 512 tokens: sort, capacity 320
    olmoe = MoEConfig(64, 8, 1024)
    assert moe.select_dispatch(2048, olmoe) == "sort"
    assert moe.capacity(2048, olmoe) == 320
    assert moe.select_dispatch(4, olmoe) == "onehot"
