"""The backward of the port's SDDMM→transform→SpMM chain
(``core/vjp.py::ExecChain``) against ``jax.grad`` of the reference's
``execute_chain`` on the same numpy inputs: every transform, X of width 1
(1-D), 4 and 16, ``alpha`` given or None, the ``"torch"`` backend and the
``"hopper"`` entries' CPU path (the fused chain, and the unfused pair with
the fuse gate shut) against the reference's ``"xla"`` backend (and its
fused Pallas kernel in interpret mode for one case), float32 and bfloat16,
empty rows, only some operands requiring grad, the facade; and
``chain_bwd_plain`` against the reference's ``_exec_chain_bwd``.

Tolerance: float32 rtol 1e-5 with an absolute floor of 5e-5 of the largest
magnitude (exp and sums reassociated); bfloat16 2e-2."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import plan as ref_plan
from repro.core import vjp as ref_vjp
from repro.core.plan import execute_chain as ref_execute_chain
from repro.core.rmat import rmat as ref_rmat
import repro_torch
from repro_torch import interop
from repro_torch.core import formats
from repro_torch.core.plan import execute_chain, plan
from repro_torch.core.vjp import chain_bwd_plain

BACKENDS = ("torch", "hopper")
TRANSFORMS = ("identity", "scale", "softmax")
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
    csr = ref_rmat(7, 8, seed=0)
    assert (np.diff(np.asarray(csr.indptr)) == 0).any()
    return csr


def _operands(rng, csr, d, n, dtype="float32"):
    """A (m, d), B (k, d), X (k,) for n = 1 else (k, n), and the output's
    cotangent, as numpy float32 holding values of ``dtype``."""
    m, k = csr.shape
    a = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((k, d)) * 0.5).astype(np.float32)
    x = rng.standard_normal((k,) if n == 1 else (k, n)).astype(np.float32)
    gy = rng.standard_normal((m,) if n == 1 else (m, n)).astype(np.float32)
    if dtype == "bfloat16":
        a, b, x = (np.asarray(torch.from_numpy(t).bfloat16().float())
                   for t in (a, b, x))
    return a, b, x, gy


def _ref_grads(csr, ops, transform, alpha, dtype="float32", backend="xla",
               **kw):
    a, b, x, gy = ops
    p = ref_plan(csr, tile=16, backend=backend, chain_op=transform)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(aa, bb, xx):
        y = ref_execute_chain(p, aa, bb, xx, transform=transform, alpha=alpha,
                              **kw)
        return (y.astype(jnp.float32) * gy).sum()
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t, jt)
                                            for t in (a, b, x)))


def _port_grads(csr, ops, transform, alpha, backend, dtype="float32",
                want=(True, True, True), **plan_kw):
    a, b, x, gy = ops
    p = plan(_port(csr), tile=16, backend=backend, chain_op=transform,
             **plan_kw)
    tt = getattr(torch, dtype)
    ts = [torch.from_numpy(t).to(tt).requires_grad_(w)
          for t, w in zip((a, b, x), want)]
    y = execute_chain(p, *ts, transform=transform, alpha=alpha)
    assert y.grad_fn is not None
    (y.float() * torch.from_numpy(gy)).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("n", [1, 4, 16])
def test_chain_grads_match_reference(rng, backend, transform, n):
    csr = _graph()
    ops = _operands(rng, csr, 8, n)
    want = _ref_grads(csr, ops, transform, 0.35)
    got = _port_grads(csr, ops, transform, 0.35, backend)
    for g, w, t in zip(got, want, ops):
        assert g.shape == t.shape and g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("transform", ["scale", "softmax"])
def test_chain_grads_alpha_none(rng, transform):
    """``alpha=None`` is 1, as in the reference."""
    csr = _graph()
    ops = _operands(rng, csr, 16, 4)
    want = _ref_grads(csr, ops, transform, None)
    for backend in BACKENDS:
        for g, w in zip(_port_grads(csr, ops, transform, None, backend), want):
            _close(g, w)


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_chain_grads_bf16(rng, transform):
    csr = _graph()
    ops = _operands(rng, csr, 16, 4, "bfloat16")
    want = _ref_grads(csr, ops, transform, 0.35, "bfloat16")
    for backend in BACKENDS:
        got = _port_grads(csr, ops, transform, 0.35, backend, "bfloat16")
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            _close(g, w, "bfloat16")


def test_chain_grads_fuse_gate_shut(rng):
    """The unfused pair a ``"hopper"`` plan runs below ``chain_fuse_min_n``
    gives the same gradients (one backward for every forward)."""
    csr = _graph()
    ops = _operands(rng, csr, 8, 4)
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               chain_fuse_min_n=1 << 20)
    for transform in TRANSFORMS:
        want = _ref_grads(csr, ops, transform, 0.35)
        got = _port_grads(csr, ops, transform, 0.35, "hopper", thresholds=shut)
        for g, w in zip(got, want):
            _close(g, w)


def test_chain_grads_match_the_reference_pallas_backend(rng):
    """The reference's backward behind its fused Pallas chain (interpret
    mode) against the port's behind the Hopper entry's CPU path."""
    csr = _graph()
    ops = _operands(rng, csr, 8, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _ref_grads(csr, ops, "softmax", 0.35, backend="pallas",
                          interpret=True)
    for g, w in zip(_port_grads(csr, ops, "softmax", 0.35, "hopper"), want):
        _close(g, w)


@pytest.mark.parametrize("want", [(False, False, True), (True, False, False),
                                  (False, True, False)])
def test_chain_grad_of_some_operands(rng, want):
    """Only the operands that require grad get one; x alone needs neither
    ``dW`` nor the score gradient."""
    csr = _graph()
    ops = _operands(rng, csr, 8, 4)
    ref = _ref_grads(csr, ops, "softmax", 0.35)
    got = _port_grads(csr, ops, "softmax", 0.35, "hopper", want=want)
    for g, w, asked in zip(got, ref, want):
        if asked:
            _close(g, w)
        else:
            assert g is None


def test_chain_facade_grads_and_empty_rows(rng):
    """``A.chain`` and ``sparse_chain`` carry a ``grad_fn``; rows of A with
    no edge get exactly zero ``dA``; nothing requiring grad makes no
    node."""
    csr = _graph()
    pc = _port(csr)
    a, b, x, gy = _operands(rng, csr, 8, 4)
    want = _ref_grads(csr, (a, b, x, gy), "softmax", 0.35)
    empty = torch.diff(pc.indptr) == 0
    for backend in BACKENDS:
        A = repro_torch.sparse(pc, device="cpu", backend=backend,
                               chain_op="softmax", cache=False)
        ta = torch.from_numpy(a).requires_grad_()
        y = A.chain(ta, torch.from_numpy(b), torch.from_numpy(x), alpha=0.35)
        (y * torch.from_numpy(gy)).sum().backward()
        _close(ta.grad, want[0])
        assert (ta.grad[empty] == 0).all()
        tx = torch.from_numpy(x).requires_grad_()
        y = repro_torch.sparse_chain(pc, torch.from_numpy(a), torch.from_numpy(b),
                                     tx, alpha=0.35, device="cpu",
                                     backend=backend)
        (y * torch.from_numpy(gy)).sum().backward()
        _close(tx.grad, want[2])
        assert A.chain(*(torch.from_numpy(t) for t in (a, b, x))).grad_fn is None


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("n,chunk", [(1, None), (4, None), (4, 100)])
def test_chain_bwd_plain_matches_the_reference(rng, transform, n, chunk):
    """``chain_bwd_plain`` against the reference's ``_exec_chain_bwd`` on a
    balanced pattern with padding slots, whole or ``chunk`` slots a
    gather."""
    csr = _graph()
    rows, cols = formats.balanced_pattern(_port(csr), 64)
    a, b, x, gy = _operands(rng, csr, 8, n)
    got = chain_bwd_plain(rows, cols, *(torch.from_numpy(t) for t in (a, b, x, gy)),
                          csr.shape, transform, 0.35, chunk=chunk)
    ref = ref_vjp._exec_chain_bwd(
        (None, csr.shape, transform, 0.35),
        tuple(jnp.asarray(t) for t in (rows.numpy(), cols.numpy(), a, b, x)),
        jnp.asarray(gy))
    for g, w in zip(got, ref[2:]):
        _close(g, w)
