"""The backward of every substrate family; counterpart of
``repro.core.vjp`` (``_coo_bwd``, ``_exec_balanced``, ``_exec_ell``,
``_exec_bsr``, ``_exec_sddmm``, ``_exec_chain``, ``_exec_attn`` and
``_stream_to_balanced``).

The VJP of ``Y = A·X`` is kernel-independent: ``dvals[e] = <G[row_e],
X[col_e]>`` on the pattern (an SDDMM of G and X) and ``dX = Aᵀ·G`` (an SpMM
on the transposed pattern).  ``ExecBalanced``, ``ExecEll`` and ``ExecBsr``
wrap the forward kernel the registry resolved, unchanged, and take the live
value stream itself, so the value gradient comes back in the stream's order
and no substrate scatter needs a transpose.  Their backward asks the call's
``vjp`` object for the two products, each through the registry:

* ``vjp.dvals(g2, x2)``: the SDDMM entry over the pattern's balanced slabs
  (K6 on the card, ``"seq"`` or ``"par"`` by N), f32 (rounded through the
  BSR blocks' type for the block family) and shaped like the slabs, 0 at
  padding slots;
* ``vjp.dx(vals, g)``: ``Aᵀ·G`` for the forward's value stream (the adaptive
  SpMM on a transposed plan — K11 on Aᵀ's BSR for the block family — or the
  forward's kernel on a pattern's transposed slabs).

The SDDMM, the chain and attention (``ExecSddmm``, ``ExecChain``,
``ExecAttn``) keep no edge stream from the forward: their backward is itself
an SDDMM+SpMM pair over the plan's pattern, every product through the
registry on the call's backend (``vjp`` is ``core/plan.py::_ChainVJP``):

* ``vjp.weights(a, b[, bias])``: the edge weights W recomputed as the
  unfused forward computes them (K6, then K7 or K9 in the design the
  pattern routes to, the weights by elementwise ops);
* ``vjp.sample(g, x)``: ``dW = <G[r], X[c]>``, the SDDMM entry (K6);
* ``vjp.rowsum(vals)``: ``Σ_c vals`` a row, the plan's SpMV against ones
  (K2), for the softmax's ``s = rowsum(W∘dW)``;
* ``vjp.spmm(vals, x)`` / ``vjp.spmm_t(vals, x)``: the plan's and the
  transposed plan's adaptive SpMM with a live stream (K1 / K2 / K3).

Every stream there is CSR-ordered and f32; the transform's jacobian is
elementwise tensor math, as in the reference.  Only what
``ctx.needs_input_grad`` asks for is computed.  No Function has a
higher-order gradient (``once_differentiable``), as the reference's
``custom_vjp`` has none.  Every backward passes its gradients through
the guardrails' ``sanitize_grads`` (a no-op unless a
``guardrails.grad_scope("sanitize")`` was active at the forward or is at
the backward), as the reference's do.  ``coo_bwd_plain``, ``sddmm_bwd_plain``,
``chain_bwd_plain``, ``attn_bwd_plain`` and ``bsr_bwd_plain`` are the
reference's backward formulas in plain PyTorch: the tests' oracles, never
on the card's path.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.autograd.function import once_differentiable

from .formats import BSR, ELL, BalancedCOO
from .guardrails import active_grad_sentinel, sanitize_grads
from .spmm import _sddmm_flat, attn_weights, chain_weights


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


def _segment_sum(vals: torch.Tensor, index: torch.Tensor, n: int
                 ) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, index.long(), vals.float())


def sddmm_bwd_plain(rows, cols, a, b, g, shape
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_exec_sddmm_bwd``: ``dA = Σ_c g·B[c]`` and ``dB =
    Σ_r g·A[r]`` in f32, cast to each operand's type, for a pattern of any
    shape (padding ``rows >= M``) and ``g`` shaped like it."""
    m, k = (int(s) for s in shape)
    r, c = rows.reshape(-1).long(), cols.reshape(-1).long()
    valid = r < m
    gf = torch.where(valid, g.reshape(-1).float(), 0.0)
    rr = torch.where(valid, r, m)
    ag = a.float().index_select(0, torch.where(valid, r, 0))
    bg = b.float().index_select(0, c)
    da = _segment_sum(gf[:, None] * bg, rr, m + 1)[:m]
    db = _segment_sum(gf[:, None] * ag, c, k)
    return da.to(a.dtype), db.to(b.dtype)


def _softmax_dz(w, dw, rr, m: int) -> torch.Tensor:
    """The masked row softmax's jacobian: ``W∘(dW − rowsum(W∘dW))``."""
    s = _segment_sum(w * dw, rr, m + 1)
    return w * (dw - s[rr])


def _chunks(n: int, chunk: int | None):
    step = n if not chunk else chunk
    return [slice(i, i + step) for i in range(0, max(n, 1), max(step, 1))]


def _pair_bwd_plain(r, c, valid, a, b, x, g, m: int, k: int, w, de,
                    chunk=None):
    """``dA``, ``dB`` and ``dX`` of the chain and attention from their edge
    weights ``w`` and score gradient ``de`` (flat, f32), the gathers
    ``chunk`` slots at a time."""
    g2 = _as_2d(g).float()
    da = torch.zeros((m + 1, a.shape[1]), device=a.device)
    db = torch.zeros((k, b.shape[1]), device=b.device)
    dx = torch.zeros((k, g2.shape[1]), device=g.device)
    for s in _chunks(r.numel(), chunk):
        rs, cs, vs = r[s], c[s], valid[s]
        rz = torch.where(vs, rs, 0)
        des = torch.where(vs, de[s], 0.0)[:, None]
        da.index_add_(0, torch.where(vs, rs, m), des * b.float().index_select(0, cs))
        db.index_add_(0, cs, des * a.float().index_select(0, rz))
        gr = torch.where(vs[:, None], g2.index_select(0, rz), 0.0)
        dx.index_add_(0, cs, w[s][:, None] * gr)
    return (da[:m].to(a.dtype), db.to(b.dtype),
            dx.reshape(x.shape).to(x.dtype))


def _scores_plain(r, c, valid, a, b, chunk=None):
    """``<A[r], B[c]>`` a slot (f32, 0 at padding), ``chunk`` at a time."""
    return torch.cat([_sddmm_flat(r[s], c[s], a, b, valid[s])
                      for s in _chunks(r.numel(), chunk)])


def chain_bwd_plain(rows, cols, a, b, x, g, shape, transform: str, alpha, *,
                    chunk: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``_exec_chain_bwd``: E and W recomputed flat, ``dW``
    the SDDMM of (G, X), the transform's jacobian (softmax: ``dE =
    α·W∘(dW − rowsum(W∘dW))``), then ``dA``, ``dB`` and ``dX`` as segment
    sums in f32, each cast to its operand's type.  ``chunk`` bounds the
    slots a gather holds (for patterns of millions of entries)."""
    m, k = (int(s) for s in shape)
    r, c = rows.reshape(-1).long(), cols.reshape(-1).long()
    valid = r < m
    al = 1.0 if alpha is None else float(alpha)
    w = chain_weights(_scores_plain(r, c, valid, a, b, chunk), r, valid, m,
                      transform, alpha)
    dw = _scores_plain(r, c, valid, _as_2d(g), _as_2d(x), chunk)
    if transform == "identity":
        de = dw
    elif transform == "scale":
        de = al * dw
    else:
        de = al * _softmax_dz(w, dw, torch.where(valid, r, m), m)
    return _pair_bwd_plain(r, c, valid, a, b, x, g, m, k, w, de, chunk)


def attn_bwd_plain(rows, cols, q, k, bias, v, g, shape, scale, *,
                   chunk: int | None = None):
    """The reference's ``_exec_attn_bwd``: W recomputed flat, ``dZ =
    W∘(dW − rowsum(W∘dW))``, ``dE = scale·dZ``, ``dBias = dZ`` (shaped like
    ``bias``, in its type), then ``dQ``, ``dK`` and ``dV`` as segment sums:
    ``(dq, dk, dbias, dv)``.  ``chunk`` as for ``chain_bwd_plain``."""
    m, kdim = (int(s) for s in shape)
    r, c = rows.reshape(-1).long(), cols.reshape(-1).long()
    valid = r < m
    bf = torch.where(valid, bias.reshape(-1).float(), 0.0)
    w = attn_weights(_scores_plain(r, c, valid, q, k, chunk), bf, r, valid, m,
                     scale)
    dw = _scores_plain(r, c, valid, _as_2d(g), _as_2d(v), chunk)
    dz = torch.where(valid, _softmax_dz(w, dw, torch.where(valid, r, m), m),
                     0.0)
    dq, dk, dv = _pair_bwd_plain(r, c, valid, q, k, v, g, m, kdim, w,
                                 float(scale) * dz, chunk)
    dbias = dz.reshape(bias.shape).to(
        bias.dtype if bias.dtype.is_floating_point else torch.float32)
    return dq, dk, dbias, dv


def bsr_bwd_plain(bsr: BSR, brow, x, g) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_exec_bsr_bwd``: the block-level ``dblocks =
    G_blockrow · X_blockcolᵀ`` (in the blocks' type) and ``dX`` as the
    block-transposed segment sum (in ``x``'s type)."""
    m, k = bsr.shape
    bm, bk = bsr.block_shape
    mb, kb = -(-m // bm), -(-k // bk)
    g2, x2 = _as_2d(g).float(), _as_2d(x).float()
    n = g2.shape[1]
    g3 = torch.zeros((mb * bm, n), device=g.device)
    g3[:m] = g2
    x3 = torch.zeros((kb * bk, n), device=x.device)
    x3[:k] = x2
    gb = g3.reshape(mb, bm, n).index_select(0, brow.long())
    xb = x3.reshape(kb, bk, n).index_select(0, bsr.indices.long())
    dblocks = torch.einsum("bmn,bkn->bmk", gb, xb).to(bsr.blocks.dtype)
    p = torch.einsum("bmk,bmn->bkn", bsr.blocks.float(), gb)
    dx = _segment_sum(p, bsr.indices, kb).reshape(kb * bk, n)[:k]
    return dblocks, dx.reshape(x.shape).to(x.dtype)


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
    return sanitize_grads(dvals, dx, policy=ctx.grad_policy)


def _fill_ell(ell: ELL, src, vals, baked: bool) -> ELL:
    return ell if baked else dataclasses.replace(
        ell, vals=_stream_to_ell(vals, ell, src))


def _fill_bsr(bsr: BSR, bmap, vals, baked: bool) -> BSR:
    """The BSR with the CSR-ordered stream scattered into zeroed blocks
    through ``bmap`` (``PlanBuilder.bsr_map``), in the blocks' type."""
    if baked:
        return bsr
    blocks = torch.zeros_like(bsr.blocks).index_put_(
        tuple(bmap), vals.reshape(-1).to(bsr.blocks.dtype), accumulate=True)
    return dataclasses.replace(bsr, blocks=blocks)


class ExecBalanced(torch.autograd.Function):
    """``fn(bal with vals, x)``, differentiable in ``vals`` (the stream in
    the slabs' order, any shape, padded to the grid) and ``x``.  With
    ``baked``, ``bal`` as built already holds ``vals``, which the backward
    alone reads (a quantized plan's codes, which its ``vjp.dx`` decodes:
    integer codes take no gradient)."""

    @staticmethod
    def forward(ctx, fn, bal, vjp, baked, vals, x):
        ctx.vjp = vjp
        ctx.grad_policy = active_grad_sentinel()
        ctx.save_for_backward(vals, x)
        return fn(bal if baked else _with_balanced(bal, vals), x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (None, None, None, None, *_stream_grads(ctx, g))


class ExecBsr(torch.autograd.Function):
    """``fn(bsr with the stream scattered into its blocks, x)`` — the
    block-granule family — differentiable in the CSR-ordered ``vals`` and
    ``x``.  The value gradient is taken on the CSR pattern (each nonzero
    owns one block slot, so it equals the reference's block-level
    ``dblocks`` gathered back through the scatter map), rounded through the
    blocks' type as the reference rounds it; ``dX`` is K11 on Aᵀ's BSR.
    With ``baked``, ``bsr`` as built already holds ``vals`` (``bmap``
    unused)."""

    @staticmethod
    def forward(ctx, fn, bsr, bmap, vjp, baked, vals, x):
        ctx.vjp = vjp
        ctx.grad_policy = active_grad_sentinel()
        ctx.save_for_backward(vals, x)
        return fn(_fill_bsr(bsr, bmap, vals, baked), x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return (None, None, None, None, None, *_stream_grads(ctx, g))


class ExecEll(torch.autograd.Function):
    """``fn(ell with the stream gathered in, x)``, differentiable in the
    CSR-ordered ``vals`` and ``x``: the gradient of ``vals`` is taken on the
    CSR pattern, so slots past ``lens`` have none to carry.  With
    ``baked``, ``ell`` as built already holds ``vals`` (``src`` unused)."""

    @staticmethod
    def forward(ctx, fn, ell, src, vjp, baked, vals, x):
        ctx.vjp = vjp
        ctx.grad_policy = active_grad_sentinel()
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


def exec_bsr(fn, bsr: BSR, bmap, vjp, vals, x, *,
             baked: bool = False) -> torch.Tensor:
    """``ExecBsr`` where an operand requires grad, else the same forward."""
    if _tracked(vals, x):
        return ExecBsr.apply(fn, bsr, bmap, vjp, baked, vals, x)
    return fn(_fill_bsr(bsr, bmap, vals, baked), x)


# ---------------------------------------------------------------------------
# the GNN pair and attention: SDDMM, the chain, attention with a bias
# ---------------------------------------------------------------------------

def _operand(t: torch.Tensor, like: torch.dtype) -> torch.Tensor:
    """``t`` as the dense operand of a product whose result is cast to
    ``like``: widened to the two types' promotion, so that no operand is
    rounded below the type the reference sums in."""
    return t.to(torch.promote_types(t.dtype, like)).contiguous()


class ExecSddmm(torch.autograd.Function):
    """``fn(rows, cols, a, b)``, the SDDMM's f32 score slab, differentiable
    in ``a`` and ``b`` (reference ``_exec_sddmm``): ``dA`` is the plan's
    SpMM of B with the score gradient as its stream, ``dB`` the transposed
    plan's SpMM of A."""

    @staticmethod
    def forward(ctx, fn, rows, cols, vjp, a, b):
        ctx.vjp = vjp
        ctx.grad_policy = active_grad_sentinel()
        ctx.save_for_backward(a, b)
        return fn(rows, cols, a, b)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        want_a, want_b = ctx.needs_input_grad[-2:]
        vjp = ctx.vjp
        de = vjp.stream(g)
        da = vjp.spmm(de, _operand(b, a.dtype)).to(a.dtype) if want_a else None
        db = vjp.spmm_t(de, _operand(a, b.dtype)).to(b.dtype) if want_b else None
        return (None, None, None, None,
                *sanitize_grads(da, db, policy=ctx.grad_policy))


def _pair_grads(vjp, a, b, x, g, w, de, want) -> tuple:
    """``dA``, ``dB`` (from the score gradient ``de``) and ``dX`` (from the
    weights ``w``), each through the registry, those ``want`` asks for."""
    want_a, want_b, want_x = want
    da = vjp.spmm(de, _operand(b, a.dtype)).to(a.dtype) if want_a else None
    db = vjp.spmm_t(de, _operand(a, b.dtype)).to(b.dtype) if want_b else None
    dx = (vjp.spmm_t(w, g.contiguous()).to(x.dtype).reshape(x.shape)
          if want_x else None)
    return da, db, dx


def _softmax_grad(vjp, w, dw) -> torch.Tensor:
    """``W∘(dW − s[row])`` with ``s = rowsum(W∘dW)`` by the plan's SpMV."""
    s = vjp.rowsum(w * dw)
    return w * (dw - s.index_select(0, vjp.row_ids()))


class ExecChain(torch.autograd.Function):
    """``fn(rows, cols, a, b, x)``, the SDDMM→transform→SpMM chain (fused
    or unfused, as the registry and the fuse gate chose), differentiable in
    ``a``, ``b`` and ``x`` (reference ``_exec_chain``).  The backward
    recomputes W, samples ``dW`` over (G, X) and applies the transform's
    jacobian: identity ``dE = dW``, scale ``α·dW``, softmax ``α·W∘(dW −
    rowsum(W∘dW))``."""

    @staticmethod
    def forward(ctx, fn, rows, cols, vjp, a, b, x):
        ctx.vjp = vjp
        ctx.grad_policy = active_grad_sentinel()
        ctx.save_for_backward(a, b, x)
        return fn(rows, cols, a, b, x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        want = ctx.needs_input_grad[-3:]
        vjp = ctx.vjp
        w = vjp.weights(a, b)
        de = None
        if want[0] or want[1]:
            dw = vjp.sample(g, x)
            al = 1.0 if vjp.alpha is None else float(vjp.alpha)
            if vjp.transform == "identity":
                de = dw
            elif vjp.transform == "scale":
                de = al * dw
            else:
                de = al * _softmax_grad(vjp, w, dw)
        return (None, None, None, None, *sanitize_grads(
            *_pair_grads(vjp, a, b, x, g, w, de, want),
            policy=ctx.grad_policy))


class ExecAttn(torch.autograd.Function):
    """``fn(rows, cols, q, k, bias, v)``, block-sparse attention with an
    additive per-edge bias (a f32 slab shaped like ``rows``),
    differentiable in ``q``, ``k``, ``bias`` and ``v`` (reference
    ``_exec_attn``): ``dZ = W∘(dW − rowsum(W∘dW))``, ``dE = scale·dZ``,
    ``dBias = dZ``."""

    @staticmethod
    def forward(ctx, fn, rows, cols, vjp, q, k, bias, v):
        ctx.vjp = vjp
        ctx.grad_policy = active_grad_sentinel()
        ctx.save_for_backward(q, k, bias, v)
        return fn(rows, cols, q, k, bias, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, bias, v = ctx.saved_tensors
        want_q, want_k, want_bias, want_v = ctx.needs_input_grad[-4:]
        vjp = ctx.vjp
        w = vjp.weights(q, k, bias)
        dz = de = dbias = None
        if want_q or want_k or want_bias:
            dz = _softmax_grad(vjp, w, vjp.sample(g, v))
            de = float(vjp.alpha) * dz
        if want_bias:
            dbias = torch.nn.functional.pad(
                dz, (0, bias.numel() - dz.numel())).reshape(bias.shape).to(
                bias.dtype)
        dq, dk, dv = _pair_grads(vjp, q, k, v, g, w, de,
                                 (want_q, want_k, want_v))
        return (None, None, None, None, *sanitize_grads(
            dq, dk, dbias, dv, policy=ctx.grad_policy))


def exec_sddmm(fn, rows, cols, vjp, a, b) -> torch.Tensor:
    """``ExecSddmm`` where an operand requires grad, else the same
    forward without an autograd node."""
    if _tracked(a, b):
        return ExecSddmm.apply(fn, rows, cols, vjp, a, b)
    return fn(rows, cols, a, b)


def exec_chain(fn, rows, cols, vjp, a, b, x) -> torch.Tensor:
    """``ExecChain`` where an operand requires grad, else the same
    forward."""
    if _tracked(a, b, x):
        return ExecChain.apply(fn, rows, cols, vjp, a, b, x)
    return fn(rows, cols, a, b, x)


def exec_attn(fn, rows, cols, vjp, q, k, bias, v) -> torch.Tensor:
    """``ExecAttn`` where an operand requires grad, else the same
    forward."""
    if _tracked(q, k, bias, v):
        return ExecAttn.apply(fn, rows, cols, vjp, q, k, bias, v)
    return fn(rows, cols, q, k, bias, v)
