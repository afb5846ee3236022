"""Quickstart: the paper's adaptive SpMV/SpMM library in five minutes;
counterpart of the reference's ``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu   # plain "torch"

Builds a skewed R-MAT matrix, wraps it in a sparse operand
(``repro_torch.sparse``: statistics and the Fig. 4 selector, the plan cached
by topology, substrates built lazily on first use), runs all four kernels of
the 2x2 design space through ``A @ x`` / ``A.matmul``, holds the Hopper
kernels against the plain ``"torch"`` backend through the same door (the
reference's Pallas interpret-mode step; on the card only), streams live
values, and freezes a ``PlanArtifact`` whose ``execute`` a CUDA graph
captures (the reference's ``jax.jit`` transit; on the card only).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch
from repro_torch.core import MATMUL_KERNELS, rmat
from repro_torch.core.registry import resolve_device


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def main(device=None) -> dict:
    """Run the six steps on ``device`` (``None``: the card, raising without
    one); returns the agreements and errors it printed."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    out: dict = {}

    # 1. a skewed sparse matrix (Graph500 R-MAT parameters)
    csr = rmat(scale=10, edge_factor=16, seed=0)

    # 2. the operand: statistics and thresholds once; the plan is cached by
    #    sparsity topology and substrates build lazily, only for the kernels
    #    that run (the paper's offline/online split)
    A = repro_torch.sparse(csr, tile=512, device=device)
    s = A.stats
    print(f"matrix: {A.shape}, nnz={A.nnz}, avg_row={s.avg_row:.1f}, "
          f"cv={s.cv:.2f}; backend={A.backend}")
    rng = np.random.default_rng(0)

    def dense(n: int) -> torch.Tensor:
        return torch.from_numpy(rng.standard_normal(
            (A.shape[1], n)).astype(np.float32)).to(device)

    # 3. the 2x2 space, SpMV and SpMM, all through the one operand
    for n in (1, 4, 64):
        x = dense(n)
        xv = x[:, 0] if n == 1 else x
        picked = A.plan.select(n)
        outs = {k: A.matmul(xv, impl=k) for k in MATMUL_KERNELS}
        agree = all(torch.allclose(o, outs["nb_pr"], atol=1e-3)
                    for o in outs.values())
        out[f"agree_n{n}"] = agree
        print(f"N={n:3d}: rules pick {picked}; all four kernels agree: "
              f"{agree} (substrates built so far: {A.plan.built_substrates})")

    # 4. the Hopper kernels against the plain "torch" backend through the
    #    same front door: just another registry column
    x = dense(16)
    ref = A.matmul(x, impl="nb_pr", backend="torch")
    if on_card:
        for k in ("nb_pr", "rs_sr"):
            out[f"hopper_{k}"] = err = _max_err(
                A.matmul(x, impl=k, backend="hopper"), ref)
            print(f"hopper {k} maxerr: {err:.2e}")
        out["hopper_spmv"] = err = _max_err(
            A.matmul(x[:, 0].contiguous(), impl="nb_pr", backend="hopper"),
            ref[:, 0])
        print(f"hopper spmv maxerr: {err:.2e}")
    else:
        print("hopper column: skipped (no CUDA device)")

    # 5. value streams are live: same pattern and cached plan, new values;
    #    differentiable, so trainable sparse weights ride the same dispatch
    A2 = A.with_values(A.values * 2.0)
    out["live"] = err = _max_err(A2 @ x, 2 * (A @ x))
    print(f"live values: ||2A@x - 2(A@x)|| = {err:.2e}")

    # 6. freeze to a PlanArtifact: every host step done, so its execute can
    #    be captured in a CUDA graph and replayed
    art = A.finalize(n=16)
    y = repro_torch.execute(art, x)
    out["artifact"] = err = _max_err(y, A @ x)
    print(f"PlanArtifact maxerr against A @ x: {err:.2e}")
    if on_card:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            repro_torch.execute(art, x)          # warm-up off the capture
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y_graph = repro_torch.execute(art, x)
        graph.replay()
        torch.cuda.synchronize(device)
        out["graph"] = err = _max_err(y_graph, y)
        print(f"PlanArtifact through a CUDA graph maxerr: {err:.2e}")
    print(f"plan cache: {repro_torch.cache_stats()}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain versions")
    main(ap.parse_args().device)
