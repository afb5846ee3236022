"""Train a graph-attention layer through the SDDMM→softmax→SpMM chain;
counterpart of the reference's ``examples/train_gat.py``.

    python -m repro_torch.examples.train_gat                # on the card
    python -m repro_torch.examples.train_gat --device cpu   # plain versions

A GAT-style layer over an R-MAT adjacency with self-loops: project node
features to queries ``Q = H Wq``, keys ``K = H Wk`` and values ``V = H Wv``,
then one ``A.chain`` call computes the masked-softmax attention over the
graph's edges and aggregates the values,

    y = softmax_rows(mask(Q Kᵀ / sqrt(d_head))) @ V

On the card the forward is the fused chain (K7 in edge mode, then K8: the
edge scores never reach device memory).  The backward is itself an
SDDMM+SpMM pair (``core/vjp.py::ExecChain``: K6, K7 full mode, K6, the
plan's SpMV for the softmax's row sum, the SpMMs of A and Aᵀ), so ``Wq``,
``Wk`` and ``Wv`` all train, here with MSE to a seeded target and plain
SGD.  The defaults are the reference's (R-MAT scale 9, edge factor 8,
d_in 32, d_head 16, 20 steps at lr 0.5, seed 0), and the initial weights
come from the same ``numpy.random.default_rng(seed)`` draws.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .. import api
from ..core.formats import CSR
from ..core.registry import resolve_device
from ..core.rmat import rmat


def gat_graph(scale: int = 9, edge_factor: int = 8, seed: int = 0, *,
              device=None) -> CSR:
    """The R-MAT adjacency (Graph500's a, b, c) with every self-loop added,
    all values 1: the reference's ``dense[i, cols] = 1; dense[i, i] = 1``,
    built from the edge list on ``device`` without the dense ``n × n``
    array."""
    g = rmat(scale, edge_factor, seed=seed, device=resolve_device(device))
    n = g.shape[0]
    ids = torch.arange(n, device=g.device)
    rows = torch.repeat_interleave(ids, torch.diff(g.indptr.long()),
                                   output_size=g.nnz)
    keys = torch.unique(torch.cat([rows * n + g.indices.long(), ids * (n + 1)]))
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=g.device)
    indptr[1:] = torch.cumsum(torch.bincount(keys // n, minlength=n), 0)
    return CSR(indptr, (keys % n).int(),
               torch.ones(keys.numel(), dtype=torch.float32, device=g.device),
               (n, n))


def init_params(n_nodes: int, d_in: int, d_head: int, seed: int, device
                ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Node features H, the regression target and ``{"wq", "wk", "wv"}``,
    drawn from ``numpy.random.default_rng(seed)`` in the reference's
    order."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n_nodes, d_in)).astype(np.float32)
    target = rng.standard_normal((n_nodes, d_head)).astype(np.float32)
    params = {name: torch.from_numpy(
        (rng.standard_normal((d_in, d_head)) * 0.1).astype(np.float32)
    ).to(device) for name in ("wq", "wk", "wv")}
    return (torch.from_numpy(h).to(device), torch.from_numpy(target).to(device),
            params)


def forward(A: api.SparseMatrix, h: torch.Tensor, params: dict,
            alpha: float) -> torch.Tensor:
    """One chain call over the graph: SDDMM, masked row softmax, SpMM."""
    q, k, v = h @ params["wq"], h @ params["wk"], h @ params["wv"]
    return A.chain(q, k, v, transform="softmax", alpha=alpha)


def loss_fn(A, h, target, params, alpha) -> torch.Tensor:
    err = forward(A, h, params, alpha) - target
    return torch.mean(err * err)


def _train(*, scale, edge_factor, d_in, d_head, steps, lr, seed, device,
           log=None, on_step=None):
    dev = resolve_device(device)
    csr = gat_graph(scale, edge_factor, seed, device=dev)
    A = api.sparse(csr, device=dev, chain_op="softmax")
    if log:
        log(f"graph: {A.shape}, nnz={A.nnz}, backend={A.backend}")
    h, target, params = init_params(csr.shape[0], d_in, d_head, seed, dev)
    alpha = 1.0 / math.sqrt(d_head)
    losses = []
    for step in range(steps):
        leaves = {k: w.clone().requires_grad_() for k, w in params.items()}
        loss = loss_fn(A, h, target, leaves, alpha)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        gnorms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        if not all(gn > 0 for gn in gnorms.values()):
            raise RuntimeError(f"a projection received zero gradient: {gnorms}")
        params = {k: w - lr * grads[k] for k, w in params.items()}
        if on_step:
            on_step(step, losses[-1])
        if log and step % 5 == 0:
            log(f"step {step:2d}  loss={losses[-1]:.5f}  "
                + "  ".join(f"|g_{k}|={v:.4f}" for k, v in gnorms.items()))
    return losses, (csr, A, h, params, alpha)


def train(*, scale: int = 9, edge_factor: int = 8, d_in: int = 32,
          d_head: int = 16, steps: int = 20, lr: float = 0.5, seed: int = 0,
          device=None, on_step=None) -> list[float]:
    """Train the layer's ``Wq``, ``Wk`` and ``Wv`` by plain SGD on the MSE
    to the target; returns the loss before each step.  ``device=None`` is
    the card.  ``on_step(step, loss)``, if given, is called after each
    step's update."""
    return _train(scale=scale, edge_factor=edge_factor, d_in=d_in,
                  d_head=d_head, steps=steps, lr=lr, seed=seed,
                  device=device, on_step=on_step)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=9)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    losses, (csr, A, h, params, alpha) = _train(
        scale=args.scale, edge_factor=args.edge_factor, d_in=32, d_head=16,
        steps=args.steps, lr=0.5, seed=args.seed, device=args.device,
        log=print)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} in {len(losses)} steps")
    # the chain of the plan's backend against the plain "torch" backend's,
    # on the same device
    with torch.no_grad():
        y = forward(A, h, params, alpha)
        plain = api.sparse(csr, device=csr.device, backend="torch",
                           chain_op="softmax")
        y_ref = forward(plain, h, params, alpha)
    err = float((y - y_ref).abs().max())
    print(f"{A.backend} vs torch max abs err: {err:.2e}")
    if not err < 1e-4:
        raise RuntimeError(f"the chain disagrees with the plain backend: {err}")
    print("OK")


if __name__ == "__main__":
    main()
