"""The port's SDDMM and SDDMM→transform→SpMM chain against the reference, on
the CPU: the ``"torch"`` backend's chain half and the plain versions of K6,
K7 and K8 against ``repro``'s xla lowerings and its Pallas kernels (interpret
mode), the facade (``repro_torch.sparse_chain`` / ``sddmm``) against
``repro.api``, and the plan rules of the slice (cache segments, the fuse
gate, validation, refusing operands that require grad).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance, float32: rtol 1e-5 and atol 2e-5 of the result's largest
magnitude (exp and sums reassociated); a bfloat16 x: rtol 2e-2."""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.core import csr_from_dense
from repro.core import formats as ref_formats
from repro.core import spmm as ref_spmm
from repro.core.selector import SelectorThresholds as RefThresholds
from repro.kernels import fused_chain as ref_chain
from repro.kernels import vsr as ref_vsr
import repro_torch
from repro_torch import interop
from repro_torch.core import formats, plan as plan_mod, registry, spmm
from repro_torch.core.cache import PlanCache, cached_plan
from repro_torch.kernels import fused_chain, launch_counts, reset_launch_counts, vsr

TRANSFORMS = (("identity", None), ("scale", 0.5),
              ("softmax", None), ("softmax", 0.7))
TILE = 512


def _problem(rng, m=37, k=29, d=16, n=24, density=0.15, empty_rows=(5, 30)):
    """``tests/test_chain.py::_problem``: a pattern with empty rows (the
    softmax edge case) and dense operands, as numpy arrays."""
    dense = ((rng.random((m, k)) < density)
             * rng.standard_normal((m, k))).astype(np.float32)
    for r in empty_rows:
        dense[r, :] = 0.0
    a = (rng.standard_normal((m, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((k, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((k, n)).astype(np.float32)
    return dense, a, b, x


def _spanning(rng, d=8):
    """A row (3) whose 600 nonzeros span two 512-slot tiles, a strided row
    (7), and a 1-D x."""
    m, k = 40, 600
    dense = np.zeros((m, k), np.float32)
    dense[3, :] = rng.standard_normal(k).astype(np.float32)
    dense[7, ::5] = 1.0
    a = (rng.standard_normal((m, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((k, d)) * 0.3).astype(np.float32)
    return dense, a, b, rng.standard_normal(k).astype(np.float32)


def _empty(rng):
    """nnz = 0: one tile of padding only."""
    return (np.zeros((6, 5), np.float32),
            rng.standard_normal((6, 4)).astype(np.float32),
            rng.standard_normal((5, 4)).astype(np.float32),
            rng.standard_normal((5, 3)).astype(np.float32))


PROBLEMS = {"small": lambda: _problem(np.random.default_rng(0)),
            "spanning": lambda: _spanning(np.random.default_rng(1)),
            "empty": lambda: _empty(np.random.default_rng(2))}
#: the problems of K6's feature-width sweep, by d: the same patterns (their
#: draws come first), A and B of width d
SIZED = {"small": lambda d: _problem(np.random.default_rng(0), d=d),
         "spanning": lambda d: _spanning(np.random.default_rng(1), d=d)}
#: K6's cases: every problem at its own width (small: d = 16), then K6's
#: widths — "seq" (d <= 4 f32) and "par" — on the small and the spanning one
SDDMM_CASES = ([pytest.param(p, None, id=p) for p in sorted(PROBLEMS)]
               + [pytest.param("small", d, id=f"small-d{d}") for d in (1, 4, 64, 256)]
               + [pytest.param("spanning", d, id=f"spanning-d{d}")
                  for d in (1, 4, 16, 64, 256)])


def _port_csr(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _slabs(dense):
    """The same balanced slabs in both packages: (ref rows, cols), (port
    rows, cols), the reference CSR and the port's."""
    csr = csr_from_dense(dense)
    rb = ref_formats.csr_to_balanced(csr, TILE)
    pc = _port_csr(csr)
    pb = formats.csr_to_balanced(pc, TILE)
    np.testing.assert_array_equal(pb.rows.numpy(), np.asarray(rb.rows))
    return rb, pb, csr, pc


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _close(got, want, rtol=1e-5, atol_rel=2e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol = atol_rel * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _close_stats(got, want, m):
    """Row maxima and sums, each (m,): empty rows exactly (NEG, 0), the rest
    within tolerance."""
    (gm, gs), (wm, ws) = got, (np.asarray(want[0])[:m], np.asarray(want[1])[:m])
    empty = ws == 0
    assert (gm.numpy()[empty] == spmm.SOFTMAX_NEG).all()
    assert (gs.numpy()[empty] == 0).all()
    _close(gm[torch.from_numpy(~empty)], wm[~empty])
    _close(gs, ws)


# ---------------------------------------------------------------------------
# the chain half of core/spmm.py and the plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem,d", SDDMM_CASES)
def test_sddmm_matches_reference(problem, d):
    dense, a, b, _ = PROBLEMS[problem]() if d is None else SIZED[problem](d)
    rb, pb, csr, _ = _slabs(dense)
    shape = csr.shape
    want_xla = ref_spmm.sddmm_xla(rb.rows, rb.cols, jnp.asarray(a), jnp.asarray(b),
                                  shape=shape)
    want_pallas = ref_chain.sddmm_pallas(rb.rows, rb.cols, jnp.asarray(a),
                                         jnp.asarray(b), shape=shape, interpret=True)
    ta, tb = _t(a, b)
    for got in (spmm.sddmm_torch(pb.rows, pb.cols, ta, tb, shape=shape),
                fused_chain.sddmm_plain(pb.rows, pb.cols, ta, tb, shape=shape),
                fused_chain.sddmm_fused(pb.rows, pb.cols, ta, tb, shape=shape)):
        assert got.dtype == torch.float32
        _close(got, want_xla)
        _close(got, want_pallas)
        assert (got.reshape(-1)[csr.nnz:] == 0).all()       # padding scores 0


@pytest.mark.parametrize("dtype,widest_seq", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_sddmm_design_routes_by_d(dtype, widest_seq):
    """K6's routing rule: "seq" while a feature row fits one 16-byte piece,
    "par" above it; CPU operands take the plain version and count no launch,
    and an unknown design raises before any launch."""
    for d in range(0, 300):
        want = "seq" if d <= widest_seq else "par"
        assert fused_chain._sddmm_design(d, dtype) == want, d
    dense, a, b, _ = PROBLEMS["small"]()
    _, pb, csr, _ = _slabs(dense)
    ta, tb = (t.to(dtype) for t in _t(a, b))
    reset_launch_counts()
    e = fused_chain.sddmm_fused(pb.rows, pb.cols, ta, tb, shape=csr.shape)
    _close(e, fused_chain.sddmm_plain(pb.rows, pb.cols, ta, tb, shape=csr.shape))
    assert fused_chain.DESIGN_LAUNCHES["sddmm"] == {"seq": 0, "par": 0}
    assert launch_counts()["sddmm"] == 0
    with pytest.raises(ValueError):
        fused_chain._launch_sddmm("tc", pb.rows, pb.cols, ta, tb, shape=csr.shape)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("alpha", [None, 0.7])
def test_chain_stats_match_reference(problem, alpha):
    dense, a, b, _ = PROBLEMS[problem]()
    rb, pb, csr, _ = _slabs(dense)
    m = csr.shape[0]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want_xla = ref_spmm.chain_stats_xla(
        rb.rows, rb.cols, ja, jb, shape=csr.shape, alpha=alpha)
    wb = 8
    vt, vb, vs = map(jnp.asarray, ref_vsr.plan_visits(rb, wb))
    pm, ps = ref_chain.chain_stats_pallas(
        rb.rows, rb.cols, ja, jb, shape=csr.shape, alpha=alpha, wb=wb,
        visit_tile=vt, visit_block=vb, visit_start=vs, interpret=True)
    want_pallas = (np.asarray(pm).reshape(-1), np.asarray(ps).reshape(-1))
    ta, tb = _t(a, b)
    rm, rs = spmm.chain_stats_torch(pb.rows, pb.cols, ta, tb, shape=csr.shape,
                                    alpha=alpha)
    assert rm.shape == (m + 1,) and rs.shape == (m + 1,)
    _close_stats((rm[:m], rs[:m]), want_xla, m)
    for fn in (fused_chain.chain_stats_plain, fused_chain.chain_stats_fused):
        got = fn(pb.rows, pb.cols, ta, tb, shape=csr.shape, alpha=alpha)
        assert got[0].shape == (m,) and got[1].shape == (m,)
        _close_stats(got, want_xla, m)
        _close_stats(got, want_pallas, m)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("transform,alpha", TRANSFORMS)
def test_chain_matches_reference(problem, transform, alpha):
    dense, a, b, x = PROBLEMS[problem]()
    rb, pb, csr, _ = _slabs(dense)
    ja, jb, jx = jnp.asarray(a), jnp.asarray(b), jnp.asarray(x)
    kw = dict(shape=csr.shape, transform=transform, alpha=alpha)
    want_xla = ref_spmm.chain_xla(rb.rows, rb.cols, ja, jb, jx, **kw)
    want_pallas = ref_chain.chain_pallas(rb.rows, rb.cols, ja, jb, jx,
                                         interpret=True, **kw)
    ta, tb, tx = _t(a, b, x)
    empty = np.diff(np.asarray(csr.indptr)) == 0
    for fn in (spmm.chain_torch, fused_chain.chain_plain,
               fused_chain.chain_fused, fused_chain.chain_unfused):
        got = fn(pb.rows, pb.cols, ta, tb, tx, **kw)
        assert got.dtype == torch.float32 and got.shape == tuple(want_xla.shape)
        _close(got, want_xla)
        _close(got, want_pallas)
        assert (got.numpy()[empty] == 0).all()              # empty rows exactly 0


def test_chain_bf16_x_and_external_stats():
    dense, a, b, x = PROBLEMS["small"]()
    rb, pb, csr, _ = _slabs(dense)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kw = dict(shape=csr.shape, transform="softmax", alpha=0.7)
    want = ref_chain.chain_pallas(rb.rows, rb.cols, ja, jb, xb, interpret=True, **kw)
    ta, tb = _t(a, b)
    txb = torch.from_numpy(x).bfloat16()
    got = fused_chain.chain_fused(pb.rows, pb.cols, ta, tb, txb, **kw)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), rtol=2e-2, atol_rel=2e-2)
    # external statistics (the later sharded merge) replace K7's
    stats = fused_chain.chain_stats_plain(pb.rows, pb.cols, ta, tb,
                                          shape=csr.shape, alpha=0.7)
    tx = torch.from_numpy(x)
    _close(fused_chain.chain_fused(pb.rows, pb.cols, ta, tb, tx, stats=stats, **kw),
           ref_spmm.chain_xla(rb.rows, rb.cols, ja, jb, jnp.asarray(x), **kw))


def _fault_33(inf_nan: bool):
    """Fault 3.3's input: every score of row 10 is −inf (A[10] = (−inf, 0,
    ...), B[:, 0] = 1, alpha > 0), and row 10 lies inside one 512-slot tile,
    neither its first run nor its last.  With ``inf_nan``, row 20 scores
    +inf and row 25 NaN as well."""
    rng = np.random.default_rng(7)
    m, k, d = 40, 30, 8
    dense = ((rng.random((m, k)) < 0.3)
             * rng.standard_normal((m, k))).astype(np.float32)
    dense[10] = 0.0
    dense[10, [3, 7, 20]] = 1.0
    a = (rng.standard_normal((m, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((k, d)) * 0.3).astype(np.float32)
    b[:, 0] = 1.0
    a[10] = 0.0
    a[10, 0] = -np.inf
    if inf_nan:
        a[20] = 0.0
        a[20, 0] = np.inf
        a[25, 3] = np.nan
    return dense, a, b, rng.standard_normal((k, 5)).astype(np.float32)


@pytest.mark.parametrize("inf_nan", [False, True], ids=["minus_inf", "inf_nan"])
def test_minus_inf_row_inside_a_tile_gives_zero(inf_nan):
    """Fault 3.3: a run inside a tile starts from the floored pair (max(z,
    −1e30), exp(z − that)), so a row of −inf scores has statistics (−1e30,
    0), weights 0 and Y exactly 0, as the reference gives; +inf and NaN
    scores give the reference's NaN rows.  (The reference's Pallas K8 is
    held on the −inf row alone: its one-hot MXU reduction multiplies a NaN
    weight by 0 for every other row of the block, so it returns NaN in
    rows whose scores are finite.)"""
    dense, a, b, x = _fault_33(inf_nan)
    rb, pb, csr, _ = _slabs(dense)
    m = csr.shape[0]
    assert pb.rows.shape[0] == 1 and pb.rows[0, 0] < 10 < pb.rows[0, -1]
    ja, jb, jx = jnp.asarray(a), jnp.asarray(b), jnp.asarray(x)
    ta, tb, tx = _t(a, b, x)
    skw = dict(shape=csr.shape, alpha=0.7)
    kw = dict(skw, transform="softmax")
    xm, xs = ref_spmm.chain_stats_xla(rb.rows, rb.cols, ja, jb, **skw)
    wb = 8
    vt, vb, vs = map(jnp.asarray, ref_vsr.plan_visits(rb, wb))
    pm, ps = ref_chain.chain_stats_pallas(
        rb.rows, rb.cols, ja, jb, wb=wb, visit_tile=vt, visit_block=vb,
        visit_start=vs, interpret=True, **skw)
    rm, rs = fused_chain.chain_stats_plain(pb.rows, pb.cols, ta, tb, **skw)
    assert rm[10] == spmm.SOFTMAX_NEG and rs[10] == 0.0
    for wm, ws in ((xm, xs), (pm, ps)):
        np.testing.assert_allclose(rm.numpy(), np.asarray(wm).reshape(-1)[:m],
                                   rtol=1e-5)
        np.testing.assert_allclose(rs.numpy(), np.asarray(ws).reshape(-1)[:m],
                                   rtol=1e-5, atol=1e-6)
    wants = [np.asarray(ref_spmm.chain_xla(rb.rows, rb.cols, ja, jb, jx, **kw))]
    if not inf_nan:
        wants.append(np.asarray(ref_chain.chain_pallas(
            rb.rows, rb.cols, ja, jb, jx, interpret=True, **kw)))
    for fn in (fused_chain.chain_plain, fused_chain.chain_tiles_plain):
        got = fn(pb.rows, pb.cols, ta, tb, tx, **kw).numpy()
        assert (got[10] == 0).all(), fn.__name__
        for want in wants:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if inf_nan:
        assert np.isnan(wants[0][[20, 25]]).all()


def test_cpu_chain_wrappers_count_no_launches():
    dense, a, b, x = PROBLEMS["small"]()
    _, pb, csr, _ = _slabs(dense)
    ta, tb, tx = _t(a, b, x)
    reset_launch_counts()
    fused_chain.sddmm_fused(pb.rows, pb.cols, ta, tb, shape=csr.shape)
    fused_chain.chain_stats_fused(pb.rows, pb.cols, ta, tb, shape=csr.shape)
    fused_chain.chain_fused(pb.rows, pb.cols, ta, tb, tx, shape=csr.shape,
                            transform="softmax")
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        fused_chain.chain_fused(pb.rows, pb.cols, ta, tb, tx, shape=csr.shape,
                                transform="sigmoid")
    with pytest.raises(ValueError):          # operands on two devices
        fused_chain.sddmm_fused(pb.rows, pb.cols, ta, tb.to("meta"), shape=csr.shape)


# ---------------------------------------------------------------------------
# the slice through the facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("problem", ["small", "spanning"])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_facade_matches_reference(problem, backend):
    dense, a, b, x = PROBLEMS[problem]()
    csr = csr_from_dense(dense)
    pc = _port_csr(csr)
    ja, jb, jx = jnp.asarray(a), jnp.asarray(b), jnp.asarray(x)
    ta, tb, tx = _t(a, b, x)
    cache = PlanCache()
    for transform, alpha in TRANSFORMS:
        got = repro_torch.sparse_chain(pc, ta, tb, tx, transform=transform,
                                       alpha=alpha, device="cpu",
                                       backend=backend, cache=cache)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want_pallas = ref_api.sparse_chain(csr, ja, jb, jx, transform=transform,
                                               alpha=alpha, backend="pallas")
        want_xla = ref_api.sparse_chain(csr, ja, jb, jx, transform=transform,
                                        alpha=alpha, backend="xla")
        _close(got, want_pallas)
        _close(got, want_xla)
    assert cache.stats()["builds"] == 3      # one plan per chain_op
    e = repro_torch.sddmm(pc, ta, tb, device="cpu", backend=backend)
    want = ref_api.sddmm(csr, ja, jb, backend="xla")
    assert e.shape == (csr.nnz,)             # the CSR-ordered stream
    _close(e, want)
    _close(e, (a @ b.T)[dense != 0])
    A = repro_torch.sparse(pc, device="cpu", backend=backend, cache=cache)
    _close(A.chain(ta, tb, tx, alpha=0.7), ref_api.sparse_chain(
        csr, ja, jb, jx, alpha=0.7, backend="xla"))
    # the scores round-trip into an attention-weighted operand
    _close(A.with_values(A.sddmm(ta, tb)) @ tx,
           ref_api.sparse_chain(csr, ja, jb, jx, transform="identity", backend="xla"))


# ---------------------------------------------------------------------------
# plan rules
# ---------------------------------------------------------------------------

def test_plan_cache_segments_on_chain_op():
    dense, _, _, _ = PROBLEMS["small"]()
    pc = _port_csr(csr_from_dense(dense))
    cache = PlanCache(capacity=8)
    p1 = cached_plan(pc, cache=cache, backend="torch")
    p2 = cached_plan(pc, cache=cache, backend="torch", chain_op="softmax")
    p3 = cached_plan(pc, cache=cache, backend="torch", chain_op="softmax")
    assert p1 is not p2 and p2 is p3
    assert p2.chain_op == "softmax" and p1.chain_op is None
    assert cache.stats()["builds"] == 2 and cache.stats()["hits"] == 1
    A = repro_torch.sparse(pc, device="cpu", cache=cache)
    B = repro_torch.sparse(pc, device="cpu", cache=cache, chain_op="softmax")
    assert A.plan is p1 and B.plan is p2


def _recording(monkeypatch, module, name, calls):
    original = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return original(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)


def test_shut_fuse_gate_runs_the_ports_unfused_kernels(monkeypatch):
    """A v4 thresholds file written by ``repro`` with the gate shut makes a
    ``"hopper"`` plan run K6 → K7 → K1 (their plain versions on the CPU),
    never the ``"torch"`` entry; the result equals the fused chain's."""
    from repro.kernels.tune import CHAIN_NEVER
    dense, a, b, x = PROBLEMS["small"]()
    pc = _port_csr(csr_from_dense(dense))
    ta, tb, tx = _t(a, b, x)
    text = dataclasses.replace(RefThresholds(), chain_fuse_min_n=CHAIN_NEVER).to_json()
    assert json.loads(text)["version"] == 4
    shut = interop.thresholds_from_json(text)
    assert shut.chain_fuse_min_n == CHAIN_NEVER
    calls = []
    for name in ("sddmm_fused", "chain_stats_fused", "chain_fused"):
        _recording(monkeypatch, fused_chain, name, calls)
    _recording(monkeypatch, vsr, "spmm_vsr_fused", calls)
    torch_entry = registry.resolve("chain", "torch")

    def refuse(*args, **kw):
        raise AssertionError("the torch entry ran on a hopper plan")
    monkeypatch.setitem(registry._REGISTRY, ("chain", "torch"),
                        dataclasses.replace(torch_entry, fn=refuse))
    fused = repro_torch.sparse_chain(pc, ta, tb, tx, alpha=0.7, device="cpu",
                                     backend="hopper", cache=False)
    assert calls == ["chain_fused"]
    calls.clear()
    unfused = repro_torch.sparse_chain(pc, ta, tb, tx, alpha=0.7, device="cpu",
                                       backend="hopper", thresholds=shut,
                                       cache=False)
    assert calls == ["sddmm_fused", "chain_stats_fused", "spmm_vsr_fused"]
    _close(unfused, fused.numpy())
    calls.clear()
    repro_torch.sparse_chain(pc, ta, tb, tx, transform="scale", alpha=0.5,
                             device="cpu", backend="hopper", thresholds=shut,
                             cache=False)
    assert calls == ["sddmm_fused", "spmm_vsr_fused"]


def test_chain_validation():
    dense, a, b, x = PROBLEMS["small"]()
    pc = _port_csr(csr_from_dense(dense))
    ta, tb, tx = _t(a, b, x)
    p = plan_mod.plan(pc, backend="torch")
    with pytest.raises(ValueError):
        plan_mod.execute_chain(p, ta, tb, tx, transform="sigmoid")
    with pytest.raises(ValueError):
        plan_mod.execute_sddmm(p, ta[:, :4], tb)          # feature widths disagree
    with pytest.raises(ValueError):
        plan_mod.execute_sddmm(p, ta[1:], tb)             # rows of A != M
    with pytest.raises(ValueError):
        plan_mod.execute_chain(p, ta, tb, tx[1:])         # X rows != K
    with pytest.raises(ValueError):
        plan_mod.execute(p, tx, impl="sddmm")             # not a matmul kernel
    A = repro_torch.sparse(pc, device="cpu")
    with pytest.raises(ValueError):                       # operand on another device
        A.chain(ta, tb.to("meta"), tx)


def test_plan_refuses_unknown_chain_op_and_unported_arguments():
    dense, _, _, _ = PROBLEMS["small"]()
    pc = _port_csr(csr_from_dense(dense))
    for op in spmm.CHAIN_TRANSFORMS:
        assert plan_mod.plan(pc, chain_op=op).chain_op == op
    assert fused_chain.CHAIN_TRANSFORMS == ref_chain.CHAIN_TRANSFORMS
    # "attn" tags the plans of block-sparse attention; "sigmoid" is no op
    assert plan_mod.plan(pc, chain_op="attn").chain_op == "attn"
    assert repro_torch.sparse(pc, device="cpu", chain_op="attn",
                              cache=False).plan.chain_op == "attn"
    with pytest.raises(ValueError):
        plan_mod.plan(pc, chain_op="sigmoid")
    with pytest.raises(ValueError):
        repro_torch.sparse(pc, device="cpu", chain_op="sigmoid", cache=False)
    # the sharding arguments are ported (tests/test_torch_shard.py): a chain
    # plan on a mesh is sharded; without a mesh they are ignored
    from repro_torch.launch import make_local_mesh
    mesh = make_local_mesh(2, 1, devices=["cpu"] * 2)
    ps = plan_mod.plan(pc, chain_op="softmax", mesh=mesh, shard_kind="row",
                       inner_backend="torch")
    assert (ps.backend, ps.chain_op, ps.shard_spec.kind) == (
        "sharded", "softmax", "row")
    for kw in ({"shard_kind": "row"}, {"inner_backend": "torch"}):
        assert plan_mod.plan(pc, **kw).backend == "torch"
    # the guardrails' arguments are ported (tests/test_torch_guardrails.py)
    assert plan_mod.plan(pc, chain_op="softmax",
                         sentinel="sanitize").sentinel == "sanitize"
    # quantized value streams are ported (tests/test_torch_quant.py)
    assert plan_mod.plan(pc, chain_op="softmax", quant="int8").quant == "int8"


# ---------------------------------------------------------------------------
# no silent loss of gradients
# ---------------------------------------------------------------------------

def test_operands_requiring_grad_get_grads():
    """The calls the refusal made before the chain's backward (``A.sddmm``,
    ``A.chain``, ``sparse_chain`` with one operand requiring grad) carry a
    ``grad_fn`` on both backends, and their grads are ``jax.grad`` of the
    reference's; under ``no_grad`` no output requires grad
    (``tests/test_torch_chain_grads.py`` holds the whole backward)."""
    import jax
    dense, a, b, x = PROBLEMS["small"]()
    pc = _port_csr(csr_from_dense(dense))
    ta, tb, tx = _t(a, b, x)
    R = ref_api.sparse(dense, backend="xla", chain_op="softmax")
    ge = np.random.default_rng(1).standard_normal(pc.nnz).astype(np.float32)
    want = {"sddmm_a": jax.grad(lambda aa: (R.sddmm(aa, jnp.asarray(b)) * ge).sum())(
                jnp.asarray(a)),
            "chain_b": jax.grad(lambda bb: R.chain(jnp.asarray(a), bb,
                                                   jnp.asarray(x)).sum())(jnp.asarray(b)),
            "chain_x": jax.grad(lambda xx: R.chain(jnp.asarray(a), jnp.asarray(b),
                                                   xx).sum())(jnp.asarray(x))}
    for backend in ("torch", "hopper"):
        A = repro_torch.sparse(pc, device="cpu", backend=backend, cache=False)
        leaf = {"sddmm_a": ta.clone().requires_grad_(),
                "chain_b": tb.clone().requires_grad_(),
                "chain_x": tx.clone().requires_grad_()}
        calls = {"sddmm_a": lambda: (A.sddmm(leaf["sddmm_a"], tb)
                                     * torch.from_numpy(ge)).sum(),
                 "chain_b": lambda: A.chain(ta, leaf["chain_b"], tx).sum(),
                 "chain_x": lambda: repro_torch.sparse_chain(
                     pc, ta, tb, leaf["chain_x"], device="cpu",
                     backend=backend).sum()}
        for name, call in calls.items():
            out = call()
            assert out.grad_fn is not None
            out.backward()
            _close(leaf[name].grad, want[name])
            with torch.no_grad():
                assert not call().requires_grad


def test_matmul_operands_requiring_grad_get_grads():
    """``A @ x`` and ``live @ x`` (the calls the refusal test made before
    the backward) give grads on both backends, those of the dense product."""
    dense, _, _, x = PROBLEMS["small"]()
    pc = _port_csr(csr_from_dense(dense))
    nz = np.nonzero(dense)
    for backend in ("torch", "hopper"):
        A = repro_torch.sparse(pc, device="cpu", backend=backend, cache=False)
        tx = torch.from_numpy(np.array(x)).requires_grad_()
        (A @ tx).sum().backward()
        want_x = dense.sum(axis=0)[:, None] * np.ones((1, x.shape[1]))
        np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=1e-5, atol=1e-5)
        v = torch.ones(A.nnz, requires_grad=True)
        (A.with_values(v) @ torch.from_numpy(np.array(x))).sum().backward()
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(x).sum(axis=1)[nz[1]],
                                   rtol=1e-5, atol=1e-5)
