"""The port's GAT training path (``repro_torch.examples.train_gat``)
against the reference's ``examples/train_gat.py`` loop run on its ``"xla"``
backend, at the reference's defaults (R-MAT scale 9, edge factor 8, d_in
32, d_head 16, lr 0.5, seed 0): the graph with self-loops equal to the
reference's dense construction, the seeded initialisation, and three
steps' losses and grads, on the ``"torch"`` backend and the ``"hopper"``
entries' CPU path.

Tolerance: float32 rtol 1e-5 with an absolute floor of 1e-5 of the largest
magnitude."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as ref_api
from repro.core import rmat as ref_rmat
import repro_torch
from repro_torch.examples import train_gat

STEPS = 3


def _close(got, want, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _reference_dense(scale=9, edge_factor=8, seed=0):
    """The reference example's adjacency: ``dense[i, cols] = 1`` and
    ``dense[i, i] = 1``."""
    csr = ref_rmat(scale=scale, edge_factor=edge_factor, seed=seed)
    dense = np.zeros(csr.shape, np.float32)
    indptr, cols = np.asarray(csr.indptr), np.asarray(csr.indices)
    for i in range(csr.shape[0]):
        dense[i, cols[indptr[i]:indptr[i + 1]]] = 1.0
        dense[i, i] = 1.0
    return dense


def _reference_loop(steps=STEPS, d_in=32, d_head=16, lr=0.5):
    """The reference example's loop on ``"xla"``: the loss and the grads
    before each step."""
    dense = _reference_dense()
    n = dense.shape[0]
    A = ref_api.sparse(dense, backend="xla", chain_op="softmax")
    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.standard_normal((n, d_in)).astype(np.float32))
    target = jnp.asarray(rng.standard_normal((n, d_head)).astype(np.float32))
    params = {k: jnp.asarray(rng.standard_normal((d_in, d_head)) * 0.1,
                             jnp.float32) for k in ("wq", "wk", "wv")}
    alpha = 1.0 / np.sqrt(d_head)

    def loss_fn(p):
        y = A.chain(h @ p["wq"], h @ p["wk"], h @ p["wv"], transform="softmax",
                    alpha=alpha)
        return jnp.mean((y - target) ** 2)

    out = []
    for _ in range(steps):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        out.append((float(loss), grads))
        params = {k: w - lr * grads[k] for k, w in params.items()}
    return out


@pytest.fixture(scope="module")
def reference():
    return _reference_loop()


def test_gat_graph_is_the_reference_adjacency():
    csr = train_gat.gat_graph(device="cpu")
    dense = _reference_dense()
    got = torch.zeros(csr.shape)
    rows = torch.repeat_interleave(torch.arange(csr.shape[0]),
                                   torch.diff(csr.indptr.long()))
    got[rows, csr.indices.long()] = csr.data
    np.testing.assert_array_equal(got.numpy(), dense)
    assert csr.nnz == int((dense != 0).sum())


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_gat_losses_and_grads_match_the_reference(reference, backend):
    """Three SGD steps through ``A.chain`` and ``ExecChain``: each step's
    loss and grads of ``wq``, ``wk``, ``wv`` against ``jax.value_and_grad``
    of the reference's loop."""
    csr = train_gat.gat_graph(device="cpu")
    A = repro_torch.sparse(csr, device="cpu", backend=backend,
                           chain_op="softmax")
    h, target, params = train_gat.init_params(csr.shape[0], 32, 16, 0, "cpu")
    for loss_ref, grads_ref in reference:
        leaves = {k: w.clone().requires_grad_() for k, w in params.items()}
        loss = train_gat.loss_fn(A, h, target, leaves, 0.25)
        loss.backward()
        _close(loss, loss_ref)
        for k, w in leaves.items():
            _close(w.grad, grads_ref[k])
        params = {k: w.detach() - 0.5 * w.grad for k, w in leaves.items()}


def test_gat_train_on_the_cpu(reference):
    """``train(device="cpu")`` at the reference's defaults: its first three
    losses are the reference's, on either CPU backend."""
    for backend in ("torch", "hopper"):
        with repro_torch.use_backend(backend):
            losses = train_gat.train(steps=STEPS, device="cpu")
        assert len(losses) == STEPS
        for got, (want, _) in zip(losses, reference):
            _close(np.float32(got), want)


def test_gat_main_runs_and_the_loss_falls(capsys):
    train_gat.main(["--device", "cpu", "--steps", "6", "--scale", "7"])
    out = capsys.readouterr().out
    assert "OK" in out and "loss" in out
