"""The backward of the port's SDDMM (``core/vjp.py::ExecSddmm``) against
``jax.grad`` of the reference's ``execute_sddmm`` on the same numpy inputs:
the ``"torch"`` backend and the ``"hopper"`` entries' CPU path against the
reference's ``"xla"`` backend (and its Pallas kernel in interpret mode for
one case), float32 and bfloat16 operands, empty rows, padding slots, and
only some operands requiring grad; ``sddmm_bwd_plain`` against the
reference's ``_exec_sddmm_bwd``.

Tolerance: float32 rtol 1e-5 with an absolute floor of 5e-5 of the largest
magnitude (sums reassociated); bfloat16 2e-2."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import plan as ref_plan
from repro.core import vjp as ref_vjp
from repro.core.plan import execute_sddmm as ref_execute_sddmm
from repro.core.rmat import rmat as ref_rmat
import repro_torch
from repro_torch import interop
from repro_torch.core import formats
from repro_torch.core.plan import execute_sddmm, plan
from repro_torch.core.vjp import sddmm_bwd_plain

BACKENDS = ("torch", "hopper")
TOL = {"float32": (1e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _close(got, want, dtype="float32"):
    rtol, atol = TOL[dtype]
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _graph():
    """R-MAT scale 7 (Graph500's a, b, c): 128 rows, some of them empty."""
    csr = ref_rmat(7, 8, seed=0)
    assert (np.diff(np.asarray(csr.indptr)) == 0).any()
    return csr


def _operands(rng, csr, d, dtype):
    m, k = csr.shape
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((k, d)).astype(np.float32)
    ge = rng.standard_normal(csr.nnz).astype(np.float32)
    if dtype == "bfloat16":     # the same bf16 values on both sides
        a, b = (np.asarray(torch.from_numpy(t).bfloat16().float())
                for t in (a, b))
    return a, b, ge


def _ref_grads(csr, a, b, ge, dtype, backend="xla", **kw):
    p = ref_plan(csr, tile=16, backend=backend)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    f = lambda aa, bb: (ref_execute_sddmm(p, aa, bb, **kw) * ge).sum()  # noqa: E731
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(a, jt), jnp.asarray(b, jt))


def _port_grads(csr, a, b, ge, dtype, backend, want=(True, True)):
    p = plan(_port(csr), tile=16, backend=backend)
    tt = getattr(torch, dtype)
    ta = torch.from_numpy(a).to(tt).requires_grad_(want[0])
    tb = torch.from_numpy(b).to(tt).requires_grad_(want[1])
    e = execute_sddmm(p, ta, tb)
    assert e.grad_fn is not None
    (e * torch.from_numpy(ge)).sum().backward()
    return ta.grad, tb.grad


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sddmm_grads_match_reference(rng, backend, d, dtype):
    csr = _graph()
    a, b, ge = _operands(rng, csr, d, dtype)
    ra, rb = _ref_grads(csr, a, b, ge, dtype)
    ga, gb = _port_grads(csr, a, b, ge, dtype, backend)
    assert ga.dtype == getattr(torch, dtype) and ga.shape == a.shape
    _close(ga, ra, dtype)
    _close(gb, rb, dtype)


def test_sddmm_grads_match_the_reference_pallas_backend(rng):
    """The reference's backward behind its Pallas forward (interpret mode)
    against the port's behind the Hopper entry's CPU path."""
    csr = _graph()
    a, b, ge = _operands(rng, csr, 8, "float32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ra, rb = _ref_grads(csr, a, b, ge, "float32", backend="pallas",
                            interpret=True)
    ga, gb = _port_grads(csr, a, b, ge, "float32", "hopper")
    _close(ga, ra)
    _close(gb, rb)


@pytest.mark.parametrize("want", [(True, False), (False, True)])
def test_sddmm_grad_of_one_operand(rng, want):
    """Only the operand that requires grad gets one; the other's product is
    not run (its transposed plan is not even built for ``a`` alone)."""
    csr = _graph()
    a, b, ge = _operands(rng, csr, 8, "float32")
    ra, rb = _ref_grads(csr, a, b, ge, "float32")
    p = plan(_port(csr), tile=16, backend="hopper")
    ta = torch.from_numpy(a).requires_grad_(want[0])
    tb = torch.from_numpy(b).requires_grad_(want[1])
    (execute_sddmm(p, ta, tb) * torch.from_numpy(ge)).sum().backward()
    if want[0]:
        _close(ta.grad, ra)
        assert tb.grad is None and p._transposed is None
    else:
        _close(tb.grad, rb)
        assert ta.grad is None and p._transposed is not None


def test_sddmm_facade_grads_and_no_node_without_grad(rng):
    """``A.sddmm`` and ``repro_torch.sddmm`` give a ``grad_fn`` when an
    operand requires grad, none otherwise or under ``no_grad``; empty rows
    of A get a zero gradient."""
    csr = _graph()
    a, b, ge = _operands(rng, csr, 8, "float32")
    pc = _port(csr)
    ra, rb = _ref_grads(csr, a, b, ge, "float32")
    for backend in BACKENDS:
        A = repro_torch.sparse(pc, device="cpu", backend=backend, cache=False)
        ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b)
        e = A.sddmm(ta, tb)
        (e * torch.from_numpy(ge)).sum().backward()
        _close(ta.grad, ra)
        empty = torch.diff(pc.indptr) == 0
        assert (ta.grad[empty] == 0).all()
        tb2 = tb.clone().requires_grad_()
        e2 = repro_torch.sddmm(pc, torch.from_numpy(a), tb2, device="cpu",
                               backend=backend)
        (e2 * torch.from_numpy(ge)).sum().backward()
        _close(tb2.grad, rb)
        assert A.sddmm(torch.from_numpy(a), tb).grad_fn is None
        with torch.no_grad():
            assert A.sddmm(ta, tb).grad_fn is None


def test_sddmm_bwd_plain_matches_the_reference(rng):
    """``sddmm_bwd_plain`` against the reference's ``_exec_sddmm_bwd`` on a
    balanced pattern with padding slots (g nonzero there: ignored)."""
    csr = _graph()
    rows, cols = formats.balanced_pattern(_port(csr), 64)
    assert (rows >= csr.shape[0]).any()
    a, b, _ = _operands(rng, csr, 8, "float32")
    g = rng.standard_normal(tuple(rows.shape)).astype(np.float32)
    da, db = sddmm_bwd_plain(rows, cols, torch.from_numpy(a),
                             torch.from_numpy(b), torch.from_numpy(g),
                             csr.shape)
    ref = ref_vjp._exec_sddmm_bwd(
        (None, csr.shape), (jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
                            jnp.asarray(a), jnp.asarray(b)), jnp.asarray(g))
    _close(da, ref[2])
    _close(db, ref[3])
