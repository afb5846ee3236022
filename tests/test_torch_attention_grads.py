"""The backward of the port's block-sparse attention against ``jax.grad`` of
the reference's ``sparse_attention`` on the same numpy inputs: without a
bias (the softmax chain, ``ExecChain``) and with an ALiBi-style bias
(``ExecAttn``, the bias's own gradient too), through Q/K/V projections
(mirroring the reference's ``tests/test_attention.py``), on the ``"torch"``
backend and the ``"hopper"`` entries' CPU path (fused, and the unfused pair
below ``attn_fuse_min_seq``), float32 and bfloat16, a mask with an empty
block row, batched heads, the model's ``_block_sparse_attention`` at
Gemma-3's smoke widths; and ``attn_bwd_plain`` against the reference's
``_exec_attn_bwd``.

Tolerance: float32 rtol 1e-5 with an absolute floor of 5e-5 of the largest
magnitude; bfloat16 2e-2."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as ref_api
from repro.attention import patterns as ref_patterns
from repro.configs import gemma3_12b as ref_gemma
from repro.core import vjp as ref_vjp
from repro.models import transformer as ref_transformer
import repro_torch
from repro_torch import interop
from repro_torch.configs import gemma3_12b
from repro_torch.core import formats
from repro_torch.core.vjp import attn_bwd_plain
from repro_torch.models import transformer

BACKENDS = ("torch", "hopper")
TOL = {"float32": (1e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}


def _block_mask_with_empty_row(nb=5):
    bm = np.tril(np.ones((nb, nb), bool))
    bm[2, :] = False
    return bm


SPECS = {
    "window_causal": ref_api.sliding_window(40, 1, block=8, causal=True),
    "window": ref_api.sliding_window(24, 1, block=8),
    "empty_row": ref_api.from_block_mask(_block_mask_with_empty_row(), 40,
                                         block=8, causal=True),
}


def _port_spec(spec):
    return interop.attention_spec_from_fields(**dataclasses.asdict(spec))


def _close(got, want, dtype="float32"):
    rtol, atol = TOL[dtype]
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _inputs(rng, spec, d, bias=False, lead=(), dtype="float32"):
    s = spec.seq
    q = (rng.standard_normal(lead + (s, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal(lead + (s, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal(lead + (s, d)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (np.asarray(torch.from_numpy(t).bfloat16().float())
                   for t in (q, k, v))
    nnz = ref_patterns.build_mask(spec).csr.nnz
    b = (rng.standard_normal(nnz) * 0.5).astype(np.float32) if bias else None
    gy = rng.standard_normal(lead + (s, d)).astype(np.float32)
    return q, k, v, b, gy


def _ref_grads(spec, q, k, v, b, gy, dtype="float32", backend="xla"):
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    args = [jnp.asarray(t, jt) for t in (q, k, v)]

    def f(*ops):
        bb = ops[3] if len(ops) == 4 else None
        y = ref_api.sparse_attention(spec, *ops[:3], bias=bb, backend=backend,
                                     cache=False)
        return (y.astype(jnp.float32) * gy).sum()
    if b is not None:
        args.append(jnp.asarray(b))
    return jax.grad(f, argnums=tuple(range(len(args))))(*args)


def _port_grads(spec, q, k, v, b, gy, backend, dtype="float32",
                thresholds=None):
    tt = getattr(torch, dtype)
    ts = [torch.from_numpy(t).to(tt).requires_grad_() for t in (q, k, v)]
    if b is not None:
        ts.append(torch.from_numpy(b).requires_grad_())
    y = repro_torch.sparse_attention(_port_spec(spec), *ts[:3],
                                     bias=ts[3] if b is not None else None,
                                     backend=backend, thresholds=thresholds,
                                     cache=False)
    assert y.grad_fn is not None
    (y.float() * torch.from_numpy(gy)).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("spec", ["window_causal", "empty_row"])
def test_attention_grads_match_reference(rng, backend, bias, spec):
    spec = SPECS[spec]
    ops = _inputs(rng, spec, 16, bias)
    want = _ref_grads(spec, *ops)
    got = _port_grads(spec, *ops, backend)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bias", [False, True])
def test_attention_grads_bf16(rng, bias):
    spec = SPECS["window_causal"]
    ops = _inputs(rng, spec, 16, bias, dtype="bfloat16")
    want = _ref_grads(spec, *ops, dtype="bfloat16")
    for backend in BACKENDS:
        got = _port_grads(spec, *ops, backend, dtype="bfloat16")
        for g, w in zip(got, want):
            _close(g, w, "bfloat16")


@pytest.mark.parametrize("bias", [False, True])
def test_attention_grads_fuse_gate_shut(rng, bias):
    """Below ``attn_fuse_min_seq`` a ``"hopper"`` plan runs the unfused
    pair; the backward is the same."""
    spec = SPECS["window_causal"]
    ops = _inputs(rng, spec, 8, bias)
    want = _ref_grads(spec, *ops)
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               attn_fuse_min_seq=1 << 20)
    for g, w in zip(_port_grads(spec, *ops, "hopper", thresholds=shut), want):
        _close(g, w)


@pytest.mark.parametrize("bias", [False, True])
def test_attention_grads_match_the_reference_pallas_backend(rng, bias):
    """The reference's backward behind its Pallas forward (interpret mode)
    against the port's behind the Hopper entries' CPU path."""
    spec = SPECS["window_causal"]
    ops = _inputs(rng, spec, 16, bias)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _ref_grads(spec, *ops, backend="pallas")
    for g, w in zip(_port_grads(spec, *ops, "hopper"), want):
        _close(g, w)


def test_attention_batched_heads_grads(rng):
    """(batch, heads, seq, d) operands: each head its own autograd node
    over one plan; the bias stream shared by all heads sums their
    gradients."""
    spec = SPECS["window_causal"]
    ops = _inputs(rng, spec, 8, True, lead=(2, 3))
    want = _ref_grads(spec, *ops)
    for backend in BACKENDS:
        for g, w in zip(_port_grads(spec, *ops, backend), want):
            _close(g, w)


@pytest.mark.parametrize("backend", BACKENDS)
def test_attention_projection_grads(rng, backend):
    """Grads flow through the Q/K/V projections, the transformer use: d/dW
    of ``attention(X@Wq, X@Wk, X@Wv)`` against the reference's."""
    spec = SPECS["window"]
    d = 8
    x = (rng.standard_normal((24, d)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal((d, d)) * 0.3).astype(np.float32)
          for _ in range(3)]

    def f(wq, wk, wv, xx):
        return jnp.sum(jnp.cos(ref_api.sparse_attention(
            spec, xx @ wq, xx @ wk, xx @ wv, backend="xla", cache=False)))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(t) for t in ws + [x]))
    ts = [torch.from_numpy(t).requires_grad_() for t in ws + [x]]
    wq, wk, wv, xx = ts
    y = repro_torch.sparse_attention(_port_spec(spec), xx @ wq, xx @ wk,
                                     xx @ wv, backend=backend, cache=False)
    torch.cos(y).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad, w)


def test_block_sparse_attention_gemma3_smoke_grads():
    """``_block_sparse_attention`` at ``gemma3_12b.SMOKE`` (4 query heads,
    2 KV heads: GQA's repeat carries the KV grads back to their heads)
    against ``jax.grad`` of the reference's, on both CPU backends."""
    ref_cfg = dataclasses.replace(ref_gemma.SMOKE, attn_pattern="block_sparse",
                                  attn_block=8)
    cfg = dataclasses.replace(gemma3_12b.SMOKE, attn_pattern="block_sparse",
                              attn_block=8)
    rng = np.random.default_rng(11)
    b, s, h, hk, hd = 2, 48, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qt = (rng.standard_normal((b, h, s, hd)) * 0.3).astype(np.float32)
    kt = (rng.standard_normal((b, hk, s, hd)) * 0.3).astype(np.float32)
    vt = rng.standard_normal((b, hk, s, hd)).astype(np.float32)
    gy = rng.standard_normal((b, h, s, hd)).astype(np.float32)

    def f(q, k, v):
        return (ref_transformer._block_sparse_attention(q, k, v, ref_cfg, True)
                * gy).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (qt, kt, vt)))
    for backend in BACKENDS:
        ts = [torch.from_numpy(t).requires_grad_() for t in (qt, kt, vt)]
        with repro_torch.use_backend(backend):
            y = transformer._block_sparse_attention(*ts, cfg, True)
        assert y.grad_fn is not None
        (y * torch.from_numpy(gy)).sum().backward()
        for t, w in zip(ts, want):
            _close(t.grad, w)


@pytest.mark.parametrize("spec,chunk", [("window_causal", None),
                                        ("empty_row", None),
                                        ("window_causal", 37)])
def test_attn_bwd_plain_matches_the_reference(rng, spec, chunk):
    """``attn_bwd_plain`` against the reference's ``_exec_attn_bwd`` on the
    mask's balanced pattern with padding slots, the bias a slab."""
    spec = SPECS[spec]
    csr = interop.csr_from_arrays(*(np.asarray(t) for t in (
        ref_patterns.build_mask(spec).csr.indptr,
        ref_patterns.build_mask(spec).csr.indices,
        ref_patterns.build_mask(spec).csr.data)), (spec.seq, spec.seq))
    rows, cols = formats.balanced_pattern(csr, 64)
    q, k, v, _, gy = _inputs(rng, spec, 8)
    bias = (rng.standard_normal(tuple(rows.shape)) * 0.5).astype(np.float32)
    got = attn_bwd_plain(rows, cols, *(torch.from_numpy(t) for t in (q, k, bias, v, gy)),
                         csr.shape, 8 ** -0.5, chunk=chunk)
    ref = ref_vjp._exec_attn_bwd(
        (None, csr.shape, 8 ** -0.5),
        tuple(jnp.asarray(t) for t in (rows.numpy(), cols.numpy(), q, k, bias, v)),
        jnp.asarray(gy))
    for g, w in zip(got, ref[2:]):
        _close(g, w)
