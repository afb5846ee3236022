"""The backward of the balanced and ELL families; counterpart of
``repro.core.vjp`` (``_coo_bwd``, ``_exec_balanced``, ``_exec_ell`` and
``_stream_to_balanced``).

The VJP of ``Y = A·X`` is kernel-independent: ``dvals[e] = <G[row_e],
X[col_e]>`` on the pattern (an SDDMM of G and X) and ``dX = Aᵀ·G`` (an SpMM
on the transposed pattern).  ``ExecBalanced`` and ``ExecEll`` wrap the
forward kernel the registry resolved, unchanged, and take the live value
stream itself, so the value gradient comes back in the stream's order and
no substrate scatter needs a transpose.  Their backward asks the call's
``vjp`` object for the two products, each through the registry:

* ``vjp.dvals(g2, x2)``: the SDDMM entry over the pattern's balanced slabs
  (K6 on the card, ``"seq"`` or ``"par"`` by N), f32 and shaped like the
  slabs, 0 at padding slots;
* ``vjp.dx(vals, g)``: ``Aᵀ·G`` for the forward's value stream (the adaptive
  SpMM on a transposed plan, or the forward's kernel on a pattern's
  transposed slabs).

Only what ``ctx.needs_input_grad`` asks for is computed.  ``coo_bwd_plain``
is the reference's ``_coo_bwd`` in plain PyTorch: the tests' oracle, never
on the card's path.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from .formats import ELL, BalancedCOO


def _as_2d(t: torch.Tensor) -> torch.Tensor:
    return t[:, None] if t.ndim == 1 else t


def coo_bwd_plain(rows, cols, valid, vals, x, g, shape
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_coo_bwd``: ``dvals[e] = <g[row_e], x[col_e]>``
    (f32, 0 where ``valid`` is false) and ``dx = Aᵀ·g`` (cast to
    ``x.dtype``), for flat ``rows``, ``cols``, ``valid`` and ``vals``."""
    k = int(shape[1])
    x2, g2 = _as_2d(x), _as_2d(g)
    r = torch.where(valid, rows, 0).long()
    g_rows = torch.where(valid[:, None], g2.index_select(0, r).float(), 0.0)
    x_cols = x2.index_select(0, cols.long()).float()
    dvals = (g_rows * x_cols).sum(dim=-1)
    dx = torch.zeros((k, x2.shape[1]), dtype=torch.float32, device=x.device)
    dx.index_add_(0, cols.long(), vals.float()[:, None] * g_rows)
    return dvals, dx.reshape(x.shape).to(x.dtype)


def _stream_to_balanced(stream: torch.Tensor, bal: BalancedCOO) -> torch.Tensor:
    """Pad the CSR-ordered value stream to the tile grid (the balanced slabs
    keep row-major order, so this is a pad and a reshape)."""
    flat = stream.reshape(-1)
    total = bal.n_tiles * bal.tile
    return torch.nn.functional.pad(flat, (0, total - flat.shape[0])).reshape(
        bal.rows.shape)


def _stream_to_ell(stream: torch.Tensor, ell: ELL, src: torch.Tensor
                   ) -> torch.Tensor:
    """The ELL slab of a CSR-ordered stream: ``where(slot < lens,
    stream[src], 0)`` in the slab's type (``src`` from
    ``PlanBuilder.ell_src``)."""
    if stream.numel() == 0:
        return torch.zeros_like(ell.vals)
    valid = (torch.arange(ell.width, device=ell.lens.device)[None, :]
             < ell.lens[:, None])
    gathered = stream.reshape(-1).index_select(0, src.reshape(-1)).reshape(
        ell.vals.shape)
    return torch.where(valid, gathered, 0).to(ell.vals.dtype)


def _with_balanced(bal: BalancedCOO, vals: torch.Tensor) -> BalancedCOO:
    return BalancedCOO(bal.rows, bal.cols, _stream_to_balanced(vals, bal),
                       bal.shape)


def _stream_grads(ctx, g: torch.Tensor):
    """``(dvals, dx)`` of the saved ``(vals, x)``, each None unless asked."""
    vals, x = ctx.saved_tensors
    want_vals, want_x = ctx.needs_input_grad[-2:]
    dvals = dx = None
    if want_vals:
        slab = ctx.vjp.dvals(_as_2d(g).to(x.dtype).contiguous(),
                             _as_2d(x).contiguous())
        dvals = slab.reshape(-1)[:vals.numel()].to(vals.dtype).reshape(
            vals.shape)
    if want_x:
        dx = ctx.vjp.dx(vals.reshape(-1), g.contiguous())
        dx = dx.to(x.dtype).reshape(x.shape)
    return dvals, dx


def _fill_ell(ell: ELL, src, vals, baked: bool) -> ELL:
    return ell if baked else dataclasses.replace(
        ell, vals=_stream_to_ell(vals, ell, src))


class ExecBalanced(torch.autograd.Function):
    """``fn(bal with vals, x)``, differentiable in ``vals`` (the stream in
    the slabs' order, any shape, padded to the grid) and ``x``.  With
    ``baked``, ``bal`` as built already holds ``vals``, which the backward
    alone reads."""

    @staticmethod
    def forward(ctx, fn, bal, vjp, baked, vals, x):
        ctx.vjp = vjp
        ctx.save_for_backward(vals, x)
        return fn(bal if baked else _with_balanced(bal, vals), x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (None, None, None, None, *_stream_grads(ctx, g))


class ExecEll(torch.autograd.Function):
    """``fn(ell with the stream gathered in, x)``, differentiable in the
    CSR-ordered ``vals`` and ``x``: the gradient of ``vals`` is taken on the
    CSR pattern, so slots past ``lens`` have none to carry.  With
    ``baked``, ``ell`` as built already holds ``vals`` (``src`` unused)."""

    @staticmethod
    def forward(ctx, fn, ell, src, vjp, baked, vals, x):
        ctx.vjp = vjp
        ctx.save_for_backward(vals, x)
        return fn(_fill_ell(ell, src, vals, baked), x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (None, None, None, None, None, *_stream_grads(ctx, g))


def _tracked(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def exec_balanced(fn, bal: BalancedCOO, vjp, vals, x, *,
                  baked: bool = False) -> torch.Tensor:
    """``ExecBalanced`` where an operand requires grad, else the same
    forward without an autograd node."""
    if _tracked(vals, x):
        return ExecBalanced.apply(fn, bal, vjp, baked, vals, x)
    return fn(bal if baked else _with_balanced(bal, vals), x)


def exec_ell(fn, ell: ELL, src, vjp, vals, x, *,
             baked: bool = False) -> torch.Tensor:
    """``ExecEll`` where an operand requires grad, else the same forward."""
    if _tracked(vals, x):
        return ExecEll.apply(fn, ell, src, vjp, baked, vals, x)
    return fn(_fill_ell(ell, src, vals, baked), x)
