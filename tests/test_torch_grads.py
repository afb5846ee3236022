"""The backward of the port's main path: ``execute`` on the balanced and ELL
families and ``pattern_matmul`` (``repro_torch.core.vjp``) against
``jax.grad`` of the reference's ``execute`` / ``execute_pattern`` on the same
numpy inputs, for all four kernels, through the ``"torch"`` backend and the
``"hopper"`` entries' CPU path; ``csr_transpose`` and the balanced
transpose; the transposed plan and the per-pattern prep built once.

Tolerance: float32 relative 1e-5 of the largest magnitude (the sums are
reassociated); padding slots get a value gradient of exactly 0."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import MATMUL_KERNELS
from repro.core import csr_from_dense as ref_csr_from_dense
from repro.core import execute as ref_execute
from repro.core import execute_pattern as ref_execute_pattern
from repro.core import plan as ref_plan
import repro_torch
from repro_torch import interop
from repro_torch.core import formats
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import (PATTERN_PREP, execute, execute_pattern,
                                   plan)
from repro_torch.core.vjp import _stream_to_ell, coo_bwd_plain

from conftest import random_csr

BACKENDS = ("torch", "hopper")


def _port(csr, data=None):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data if data is None else data),
                                   csr.shape)


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got.astype(np.float32), want, rtol=rtol, atol=atol)


def _ref_grads(p, v, x, **kw):
    f = lambda vv, xx: (ref_execute(p, xx, vals=vv, **kw) ** 2).sum()  # noqa: E731
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(x))


def _port_grads(p, v, x, **kw):
    tv = torch.from_numpy(np.array(v)).requires_grad_()
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    y = execute(p, tx, vals=tv, **kw)
    (y ** 2).sum().backward()
    return tv.grad, tx.grad


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("impl", MATMUL_KERNELS)
def test_execute_grads_match_reference(rng, impl, n, backend):
    csr, _ = random_csr(rng, 33, 27, 0.2)
    x = rng.standard_normal((27, n)).astype(np.float32)
    x = x[:, 0] if n == 1 else x
    v = rng.standard_normal(csr.nnz).astype(np.float32)
    rv, rx = _ref_grads(ref_plan(csr, tile=16), v, x, impl=impl)
    p = plan(_port(csr), tile=16, backend=backend)
    gv, gx = _port_grads(p, v, x, impl=impl)
    assert gv.shape == (csr.nnz,) and gx.shape == x.shape
    _close(gv, rv)
    _close(gx, rx)


@pytest.mark.parametrize("impl", ["nb_pr", "rs_sr"])
def test_grads_match_the_reference_pallas_backend(rng, impl):
    """The reference's backward behind its Pallas forward (interpret mode)
    against the port's behind the Hopper entries' CPU path."""
    csr, _ = random_csr(rng, 24, 18, 0.25)
    x = rng.standard_normal((18, 4)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rv, rx = _ref_grads(ref_plan(csr, backend="pallas", tile=16), csr.data,
                            x, impl=impl, interpret=True)
    gv, gx = _port_grads(plan(_port(csr), tile=16, backend="hopper"),
                         csr.data, x, impl=impl)
    _close(gv, rv)
    _close(gx, rx)


@pytest.mark.parametrize("n", [1, 5])
def test_with_values_stream_grads_through_the_facade(rng, n):
    """``A.with_values(v) @ x``: the stream keeps its graph, and the
    selector's own pick runs forward and backward."""
    csr, _ = random_csr(rng, 40, 30, 0.15)
    x = rng.standard_normal((30, n)).astype(np.float32)
    x = x[:, 0] if n == 1 else x
    v = rng.standard_normal(csr.nnz).astype(np.float32)
    rv, rx = _ref_grads(ref_plan(csr), v, x)
    tv = torch.from_numpy(v).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    A = repro_torch.sparse(_port(csr), device="cpu", cache=False)
    live = A.with_values(tv)
    assert torch.equal(live.values, tv) and live.values.requires_grad
    assert live.dtype == torch.float32
    assert A.values is A.plan.csr.data
    ((live @ tx) ** 2).sum().backward()
    _close(tv.grad, rv)
    _close(tx.grad, rx)


@pytest.mark.parametrize("impl", ["rs_sr", "rs_pr"])
def test_ell_padding_slots_get_zero_value_grad(impl):
    """The reference's ELL invariant: the gradient lands on the real
    nonzeros only, never on the padded tail of short rows.  The port's ELL
    slab zeroes the slots past ``lens``, and its value gradient is taken on
    the CSR stream, which has no such slots."""
    a = np.zeros((4, 6), np.float32)
    a[0, :5] = [1, 2, 3, 4, 5]      # long row -> width 5
    a[2, 1] = 7.0                    # short row -> 4 padded slots
    x = np.ones((6, 2), np.float32)
    rcsr = ref_csr_from_dense(a)
    rv = jax.grad(lambda v: (ref_execute(ref_plan(rcsr, tile=4), jnp.asarray(x),
                                         vals=v, impl=impl) ** 2).sum())(rcsr.data)
    p = plan(_port(rcsr), tile=4)
    tv = torch.from_numpy(np.array(rcsr.data)).requires_grad_()
    (execute(p, torch.from_numpy(x), vals=tv, impl=impl) ** 2).sum().backward()
    _close(tv.grad, rv)
    ell = p.substrate("ell")
    slab = _stream_to_ell(torch.full((p.csr.nnz,), 9.0), ell, p.ell_src())
    pad = torch.arange(ell.width)[None, :] >= ell.lens[:, None]
    assert pad.sum() > 0 and (slab[pad] == 0).all() and (slab[~pad] == 9).all()


def test_grad_of_vals_only_when_x_constant(rng):
    """Only what is asked for is computed: with x constant no transposed
    plan is built; with the stream constant, no SDDMM pattern."""
    csr, a = random_csr(rng, 16, 16, 0.3)
    x = rng.standard_normal((16, 2)).astype(np.float32)
    for impl in MATMUL_KERNELS:
        rv = jax.grad(lambda v: ref_execute(ref_plan(csr, tile=8), jnp.asarray(x),
                                            vals=v, impl=impl).sum())(csr.data)
        p = plan(_port(csr), tile=8)
        tv = torch.from_numpy(np.array(csr.data)).requires_grad_()
        execute(p, torch.from_numpy(x), vals=tv, impl=impl).sum().backward()
        assert tv.grad.shape == (csr.nnz,) and torch.isfinite(tv.grad).all()
        _close(tv.grad, rv)
        assert p._transposed is None, impl
        q = plan(_port(csr), tile=8)
        tx = torch.from_numpy(x).requires_grad_()
        execute(q, tx, impl=impl).sum().backward()
        assert q._pattern is None and q._transposed is not None
        _close(tx.grad, np.asarray(a).T @ np.ones((16, 2), np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("impl", ["nb_pr", "nb_sr"])
def test_pattern_matmul_grads_match_reference(rng, impl, backend):
    """``pattern_matmul`` over a balanced pattern with padding rows: the
    grads of ``execute_pattern``; padding slots get exactly 0."""
    csr, _ = random_csr(rng, 22, 30, 0.2)
    while csr.nnz % 8 == 0:          # a tail of padding slots
        csr, _ = random_csr(rng, 22, 30, 0.2)
    bal = ref_plan(csr, tile=8).substrate("balanced")
    rows, cols = np.array(bal.rows), np.array(bal.cols)
    assert (rows == 22).any()
    vals = rng.standard_normal(rows.shape).astype(np.float32)
    x = rng.standard_normal((30, 4)).astype(np.float32)

    def f(vv, xx):
        return (ref_execute_pattern(bal.rows, bal.cols, vv, bal.shape, xx,
                                    impl=impl) ** 2).sum()

    rv, rx = jax.grad(f, argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(x))
    tv = torch.from_numpy(vals).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y = repro_torch.pattern_matmul(torch.from_numpy(rows), torch.from_numpy(cols),
                                   tv, bal.shape, tx, impl=impl, backend=backend)
    (y ** 2).sum().backward()
    assert tv.grad.shape == vals.shape
    assert (tv.grad.reshape(-1)[torch.from_numpy(rows.reshape(-1) == 22)] == 0).all()
    _close(tv.grad, rv)
    _close(tx.grad, rx)


def test_pattern_matmul_padding_inside_the_slabs(rng):
    """Padding slots anywhere in the slabs (not only the tail) are skipped
    by the transpose and get exactly 0."""
    m, k = 12, 9
    rows = np.sort(rng.integers(0, m, 40)).astype(np.int32)
    cols = rng.integers(0, k, 40).astype(np.int32)
    rows[[3, 17, 30]] = m
    cols[[3, 17, 30]] = 0
    vals = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((k, 3)).astype(np.float32)
    tv = torch.from_numpy(vals).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    r, c = torch.from_numpy(rows.reshape(5, 8)), torch.from_numpy(cols.reshape(5, 8))
    (execute_pattern(r, c, tv.reshape(5, 8), (m, k), tx) ** 2).sum().backward()
    keep = rows < m
    dense = torch.zeros(m, k).index_put((torch.from_numpy(rows[keep]).long(),
                                         torch.from_numpy(cols[keep]).long()),
                                        torch.from_numpy(vals[keep]), accumulate=True)
    y = dense @ torch.from_numpy(x)
    g = 2 * y
    want_v = (g[rows[keep]] * torch.from_numpy(x)[cols[keep]]).sum(1)
    assert (tv.grad[~torch.from_numpy(keep)] == 0).all()
    _close(tv.grad[torch.from_numpy(keep)], want_v.numpy())
    _close(tx.grad, (dense.T @ g).numpy())


def test_coo_bwd_plain_matches_the_reference(rng):
    from repro.core.vjp import _coo_bwd
    csr, _ = random_csr(rng, 20, 14, 0.3)
    bal = ref_plan(csr, tile=8).substrate("balanced")
    r, c = np.asarray(bal.rows).reshape(-1), np.asarray(bal.cols).reshape(-1)
    v = np.asarray(bal.vals).reshape(-1)
    x = rng.standard_normal((14, 3)).astype(np.float32)
    g = rng.standard_normal((20, 3)).astype(np.float32)
    rdv, rdx = _coo_bwd(jnp.asarray(r), jnp.asarray(c), jnp.asarray(r < 20),
                        jnp.asarray(v), jnp.asarray(x), jnp.asarray(g), (20, 14))
    tr = torch.from_numpy(r)
    dv, dx = coo_bwd_plain(tr, torch.from_numpy(c), tr < 20, torch.from_numpy(v),
                           torch.from_numpy(x), torch.from_numpy(g), (20, 14))
    _close(dv, rdv)
    _close(dx, rdx)


@pytest.mark.parametrize("shape", [(7, 11), (11, 7), (1, 5), (6, 1)])
def test_csr_transpose_rectangular_with_empty_rows_and_columns(rng, shape):
    m, k = shape
    a = (rng.random(shape) < 0.4) * rng.standard_normal(shape)
    a[m // 2] = 0
    a[:, k // 2] = 0
    csr = formats.csr_from_dense(a.astype(np.float32))
    t, perm = formats.csr_transpose(csr)
    assert t.shape == (k, m) and perm.dtype == torch.int32
    np.testing.assert_array_equal(t.to_dense().numpy(), a.T.astype(np.float32))
    np.testing.assert_array_equal(t.data.numpy(), csr.data[perm.long()].numpy())
    ref_t = ref_csr_from_dense(a.T.astype(np.float32))
    np.testing.assert_array_equal(t.indptr.numpy(), np.asarray(ref_t.indptr))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(ref_t.indices))
    # the stream positions in perm: Aᵀ's j-th nonzero is A's perm[j]-th
    rows = formats.row_ids_from_indptr(csr.indptr.numpy(), csr.nnz)
    t_rows = formats.row_ids_from_indptr(t.indptr.numpy(), t.nnz)
    np.testing.assert_array_equal(rows[perm.numpy()], t.indices.numpy())
    np.testing.assert_array_equal(csr.indices.numpy()[perm.numpy()], t_rows)


def test_balanced_transpose_matches_the_transposed_csr(rng):
    csr, _ = random_csr(rng, 30, 17, 0.2)
    pc = _port(csr)
    rows, cols = formats.balanced_pattern(pc, 16)
    rows_t, cols_t, perm = formats.balanced_transpose(rows, cols, pc.shape)
    want = formats.csr_to_balanced(formats.csr_transpose(pc)[0], 16)
    assert torch.equal(rows_t, want.rows) and torch.equal(cols_t, want.cols)
    assert torch.equal(perm, formats.csr_transpose(pc)[1])


def test_transposed_plan_built_once_and_not_cached(rng):
    csr, _ = random_csr(rng, 25, 19, 0.2)
    cache = repro_torch.PlanCache()
    A = repro_torch.sparse(_port(csr), device="cpu", cache=cache)
    x = torch.randn(19, 3, requires_grad=True)
    for _ in range(3):
        (A.with_values(torch.ones(A.nnz, requires_grad=True)) @ x).sum().backward()
    pt = A.plan.transposed()
    assert pt is A.plan.transposed() and pt.csr.shape == (19, 25)
    assert pt.backend == A.backend and pt.thresholds is A.plan.thresholds
    assert pt.stats.nnz == A.nnz and pt.tile == A.plan.tile
    assert cache.stats()["builds"] == 1 and cache.stats()["size"] == 1


def test_pattern_prep_built_once_per_pattern(rng):
    csr, _ = random_csr(rng, 20, 16, 0.25)
    bal = formats.csr_to_balanced(_port(csr), 8)
    x = torch.randn(16, 2, requires_grad=True)
    before = PATTERN_PREP["builds"]
    for _ in range(4):
        v = bal.vals.clone().requires_grad_()
        execute_pattern(bal.rows, bal.cols, v, bal.shape, x).sum().backward()
    assert PATTERN_PREP["builds"] == before + 1
    rows = bal.rows.clone()          # another pattern object: its own prep
    for _ in range(2):
        execute_pattern(rows, bal.cols, v, bal.shape, x).sum().backward()
    assert PATTERN_PREP["builds"] == before + 2
    key = id(rows)
    assert plan_mod._PATTERN_PREPS[key][0]() is rows
    del rows                         # the memo lets go with the pattern
    assert key not in plan_mod._PATTERN_PREPS


def test_refusals_and_unported_arguments(rng):
    csr, _ = random_csr(rng, 10, 10, 0.3)
    pc = _port(csr)
    baked = formats.CSR(pc.indptr, pc.indices, pc.data.clone().requires_grad_(),
                        pc.shape)
    p = plan(baked)
    with pytest.raises(NotImplementedError, match="with_values"):
        execute(p, torch.randn(10))
    with torch.no_grad():
        assert not execute(p, torch.randn(10)).requires_grad
    bal = formats.csr_to_balanced(pc, 8)
    # the mesh arguments are ported (tests/test_torch_shard_train.py): the
    # pattern's tiles split over the shards give the unsharded product
    from repro_torch.launch import make_local_mesh
    x = torch.randn(10)
    y = execute_pattern(bal.rows, bal.cols, bal.vals, bal.shape, x)
    ys = execute_pattern(bal.rows, bal.cols, bal.vals, bal.shape, x,
                         mesh=make_local_mesh(2, 1, devices=["cpu"] * 2),
                         shard_axis="data")
    assert torch.allclose(ys, y, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="mesh"):
        execute_pattern(bal.rows, bal.cols, bal.vals, bal.shape, x,
                        backend="sharded")
    # quantized value streams are ported (tests/test_torch_quant.py)
    assert execute_pattern(bal.rows, bal.cols, bal.vals, bal.shape,
                           torch.randn(10), quant="int8").shape == (10,)
    with pytest.raises(ValueError, match="balanced"):
        execute_pattern(bal.rows, bal.cols, bal.vals, bal.shape, torch.randn(10),
                        impl="rs_sr")
    # BSR plans have their backward too: no refusal is left
    A = repro_torch.sparse(pc, device="cpu", backend="bsr", cache=False)
    assert (A @ torch.randn(10, requires_grad=True)).grad_fn is not None
    assert not hasattr(plan_mod, "_refuse_grad")


@pytest.mark.parametrize("impl", MATMUL_KERNELS)
def test_baked_values_forward_runs_the_built_substrate(rng, monkeypatch, impl):
    """``A @ x`` with a grad-requiring ``x`` runs the substrate as built (no
    value stream is laid out again) and gives ``Aᵀ·g`` for ``x``."""
    csr, a = random_csr(rng, 14, 10, 0.3)
    p = plan(_port(csr), tile=8)
    x = torch.randn(10, 3)
    with torch.no_grad():
        want = execute(p, x, impl=impl)

    def refuse(*args):
        raise AssertionError("the baked values were laid out again")

    from repro_torch.core import vjp
    monkeypatch.setattr(vjp, "_stream_to_balanced", refuse)
    monkeypatch.setattr(vjp, "_stream_to_ell", refuse)
    tx = x.clone().requires_grad_()
    y = execute(p, tx, impl=impl)
    assert y.grad_fn is not None
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    monkeypatch.undo()
    (y ** 2).sum().backward()
    _close(tx.grad, 2 * np.asarray(a).T @ want.numpy())


def test_bf16_stream_and_backend_override(rng):
    """A bf16 stream gets a bf16 gradient; a per-call backend runs the
    backward on that backend too."""
    csr, _ = random_csr(rng, 18, 12, 0.3)
    p = plan(_port(csr), backend="hopper")
    v32 = torch.from_numpy(np.array(csr.data))
    x = torch.randn(12, 4)
    tv = v32.bfloat16().requires_grad_()
    tx = x.clone().requires_grad_()
    execute(p, tx, vals=tv, backend="torch").sum().backward()
    assert tv.grad.dtype == torch.bfloat16 and tx.grad.dtype == torch.float32
    assert p.transposed().backend == "hopper"
    want_v = torch.from_numpy(np.asarray(
        jax.grad(lambda v: ref_execute(ref_plan(csr), jnp.asarray(x.numpy()),
                                       vals=v).sum())(
            jnp.asarray(tv.detach().float().numpy()))))
    _close(tv.grad.float(), want_v.bfloat16().float().numpy(), rtol=1e-2)
