"""The backward of the port's block-granule ``"bsr"`` backend
(``core/vjp.py::ExecBsr``) against ``jax.grad`` of the reference's
``execute(..., backend="bsr")`` (its Pallas block kernel in interpret mode)
on the same numpy inputs, mirroring the reference's
``tests/test_grads.py::test_bsr_backend_grads*``: every logical kernel name,
X of width 4 and 1-D, several block shapes, bfloat16 blocks (the value
gradient rounded through the blocks' type), baked values with ``x``
requiring grad, and Aᵀ's plan at the transposed block; ``bsr_bwd_plain``
against the reference's ``_exec_bsr_bwd``.

Tolerance: float32 rtol 1e-5 with an absolute floor of 5e-5 of the largest
magnitude; bfloat16 2e-2."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import MATMUL_KERNELS
from repro.core import execute as ref_execute
from repro.core import formats as ref_formats
from repro.core import plan as ref_plan
from repro.core import vjp as ref_vjp
import repro_torch
from repro_torch import interop
from repro_torch.core import formats
from repro_torch.core.plan import execute, plan
from repro_torch.core.vjp import bsr_bwd_plain

from conftest import random_csr

TOL = {"float32": (1e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}


def _port(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data, np.float32), csr.shape)


def _close(got, want, dtype="float32"):
    rtol, atol = TOL[dtype]
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _ref_grads(csr, v, x, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p = ref_plan(csr, **{k: kw.pop(k) for k in ("bsr_block",) if k in kw})
        f = lambda vv, xx: (ref_execute(p, xx, vals=vv, backend="bsr",  # noqa: E731
                                        interpret=True, **kw) ** 2).sum()
        return jax.grad(f, argnums=(0, 1))(v, jnp.asarray(x))


def _port_grads(p, v, x, **kw):
    tv = torch.from_numpy(np.array(v)).requires_grad_()
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    y = execute(p, tx, vals=tv, backend="bsr", **kw)
    assert y.grad_fn is not None
    (y.float() ** 2).sum().backward()
    return tv.grad, tx.grad


@pytest.mark.parametrize("impl", MATMUL_KERNELS)
def test_bsr_backend_grads(rng, impl):
    """Value and dense-operand grads for every logical kernel name the
    block kernel serves, N = 4, the default (8, 128) block."""
    csr, _ = random_csr(rng, 35, 30, 0.2)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    rv, rx = _ref_grads(csr, csr.data, x, impl=impl)
    gv, gx = _port_grads(plan(_port(csr)), np.asarray(csr.data), x, impl=impl)
    assert gv.shape == (csr.nnz,) and gx.shape == x.shape
    _close(gv, rv)
    _close(gx, rx)


@pytest.mark.parametrize("block", [(8, 128), (4, 8), (16, 4), (3, 5)])
def test_bsr_backend_grads_spmv_and_blocks(rng, block):
    """1-D x, and block shapes whose transpose differs: Aᵀ's plan takes
    the block ``(bk, bm)`` and as many blocks as A."""
    csr, _ = random_csr(rng, 24, 20, 0.25)
    x = rng.standard_normal((20,)).astype(np.float32)
    rv, rx = _ref_grads(csr, csr.data, x, bsr_block=block)
    p = plan(_port(csr), backend="bsr", bsr_block=block)
    gv, gx = _port_grads(p, np.asarray(csr.data), x)
    _close(gv, rv)
    _close(gx, rx)
    pt = p.transposed()
    assert pt.bsr_block == block[::-1]
    assert pt.substrate("bsr").nblocks == p.substrate("bsr").nblocks


def test_bsr_grads_bf16_blocks(rng):
    """bfloat16 blocks: the value gradient is rounded through the blocks'
    type, as the reference rounds ``dblocks``."""
    csr, _ = random_csr(rng, 35, 30, 0.2)
    data16 = jnp.asarray(csr.data).astype(jnp.bfloat16)
    ref_csr = ref_formats.CSR(csr.indptr, csr.indices, data16, csr.shape)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    rv, rx = _ref_grads(ref_csr, data16, x)
    pc = _port(csr)
    pc = formats.CSR(pc.indptr, pc.indices, pc.data.bfloat16(), pc.shape)
    p = plan(pc, backend="bsr")
    tv = pc.data.clone().requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    (execute(p, tx, vals=tv).float() ** 2).sum().backward()
    assert tv.grad.dtype == torch.bfloat16
    _close(tv.grad, rv, "bfloat16")
    _close(tx.grad, rx, "bfloat16")


def test_bsr_baked_values_give_dx_only(rng):
    """``A @ x`` on baked values with ``x`` requiring grad: ``dX`` alone
    (the plan's values are constants), through K11's plain version on
    Aᵀ's BSR."""
    csr, _ = random_csr(rng, 35, 30, 0.2)
    x = rng.standard_normal((30, 3)).astype(np.float32)
    _, rx = _ref_grads(csr, csr.data, x)
    A = repro_torch.sparse(_port(csr), device="cpu", backend="bsr", cache=False)
    tx = torch.from_numpy(x).requires_grad_()
    y = A @ tx
    assert y.grad_fn is not None
    (y ** 2).sum().backward()
    _close(tx.grad, rx)
    assert A.plan.transposed().built_substrates == ("bsr",)


def test_bsr_bwd_plain_matches_the_reference(rng):
    csr, _ = random_csr(rng, 35, 30, 0.2)
    p = plan(_port(csr), backend="bsr", bsr_block=(8, 16))
    sub = p.substrate("bsr")
    x = rng.standard_normal((30, 4)).astype(np.float32)
    g = rng.standard_normal((35, 4)).astype(np.float32)
    dblocks, dx = bsr_bwd_plain(sub, p.bsr_brow(), torch.from_numpy(x),
                                torch.from_numpy(g))
    ref = ref_vjp._exec_bsr_bwd(
        (None, csr.shape, (8, 16)),
        tuple(jnp.asarray(t.numpy()) for t in (sub.indptr, sub.indices,
                                               p.bsr_brow(), sub.blocks))
        + (jnp.asarray(x),), jnp.asarray(g))
    _close(dblocks, ref[3])
    _close(dx, ref[4])
    # the port's value gradient is dblocks gathered through the scatter map
    tv = p.csr.data.clone().requires_grad_()
    y = execute(p, torch.from_numpy(x), vals=tv)
    y.backward(torch.from_numpy(g))
    _close(tv.grad, np.asarray(ref[3])[tuple(p.bsr_map().long().numpy())])


def test_bsr_grad_needs_no_balanced_substrate(rng):
    """The value gradient samples the plan's balanced pattern, built
    without values: the BSR plan keeps only its BSR substrate."""
    csr, _ = random_csr(rng, 35, 30, 0.2)
    A = repro_torch.sparse(_port(csr), device="cpu", backend="bsr", cache=False)
    v = torch.from_numpy(np.array(csr.data)).requires_grad_()
    (A.with_values(v) @ torch.randn(30, 3)).sum().backward()
    assert A.plan.built_substrates == ("bsr",)
    assert v.grad is not None and v.grad.abs().max() > 0
