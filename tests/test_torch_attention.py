"""The port's block-sparse attention against the reference, on the CPU: the
pattern builders (element-equal masks, the reference's properties), the
``"torch"`` lowerings and the plain versions of K9 and K10 against
``repro``'s xla functions and Pallas kernels (interpret mode),
``sparse_attention`` against ``repro.api.sparse_attention`` on both of its
backends, the plan rules of the slice (the fuse gate, plan sharing, cache
segments, validation, refusing operands that require grad) and the model's
``_block_sparse_attention`` at Gemma-3's smoke widths.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance, float32: rtol 1e-5 and atol 2e-5 of the result's largest
magnitude (exp and sums reassociated), unless a test states another."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.attention import patterns as ref_patterns
from repro.configs import gemma3_12b as ref_gemma
from repro.core import formats as ref_formats
from repro.core import spmm as ref_spmm
from repro.kernels import attention as ref_attention
from repro.kernels import vsr as ref_vsr
from repro.models import transformer as ref_transformer
import repro_torch
from repro_torch import interop
from repro_torch.attention import module as attn_module
from repro_torch.attention import patterns
from repro_torch.configs import gemma3_12b
from repro_torch.core import formats, plan as plan_mod, registry, spmm
from repro_torch.core.cache import PlanCache, cached_plan
from repro_torch.kernels import (attention, fused_chain, launch_counts,
                                 reset_launch_counts, vsr)
from repro_torch.models import transformer

from _hypothesis_compat import given, settings, st

TILE = 512


def _block_mask_with_empty_row(nb=4):
    bm = np.tril(np.ones((nb, nb), bool))
    bm[2, :] = False                 # tokens of block row 2 attend to nothing
    return bm


#: (name, reference spec) of the parity tests: windows, causal, BigBird with
#: global and random blocks, dense, and a block mask with an empty block row
SPECS = {
    "window": ref_api.sliding_window(40, 1, block=8),
    "window_causal": ref_api.sliding_window(64, 2, block=8, causal=True),
    "bigbird": ref_api.bigbird(64, 1, 1, 2, block=8, seed=3),
    "bigbird_causal": ref_api.bigbird(48, 1, 1, 1, block=16, seed=1,
                                      causal=True),
    "dense_causal": ref_api.dense_attention(33, block=8, causal=True),
    "empty_row": ref_api.from_block_mask(_block_mask_with_empty_row(), 32,
                                         block=8, causal=True),
}


def _port_spec(spec):
    return interop.attention_spec_from_fields(**dataclasses.asdict(spec))


def _port_csr(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr),
                                   np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _qkv(rng, seq, d, n=None, lead=()):
    q = (rng.standard_normal(lead + (seq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal(lead + (seq, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal(lead + (seq, d if n is None else n)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _close(got, want, rtol=1e-5, atol_rel=2e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol = atol_rel * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _empty_rows(csr):
    return np.diff(np.asarray(csr.indptr)) == 0


# ---------------------------------------------------------------------------
# pattern builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_masks_element_equal_to_reference(name):
    ref = ref_patterns.build_mask(SPECS[name])
    got = patterns.build_mask(_port_spec(SPECS[name]))
    np.testing.assert_array_equal(got.block_mask, ref.block_mask)
    assert got.nnz_blocks == ref.nnz_blocks and got.stats == ref.stats
    for field in ("indptr", "indices", "data"):
        want = np.asarray(getattr(ref.csr, field))
        have = getattr(got.csr, field).numpy()
        assert have.dtype == want.dtype
        np.testing.assert_array_equal(have, want)
    assert got.csr.shape == ref.csr.shape and got.csr.device.type == "cpu"


@settings(max_examples=25, deadline=None)
@given(nb=st.integers(1, 9), window=st.integers(0, 10),
       block=st.sampled_from((4, 8)), causal=st.sampled_from((False, True)))
def test_band_block_count_closed_form(nb, window, block, causal):
    mask = patterns.build_mask(patterns.sliding_window(nb * block, window,
                                                       block=block,
                                                       causal=causal))
    want = patterns.expected_band_blocks(nb, window, causal=causal)
    assert want == ref_patterns.expected_band_blocks(nb, window, causal=causal)
    assert mask.nnz_blocks == want == mask.stats["nnz_blocks"]
    assert mask.block_mask.shape == (nb, nb)


@settings(max_examples=25, deadline=None)
@given(seq=st.integers(3, 40), window=st.integers(0, 3),
       block=st.sampled_from((4, 8)), causal=st.sampled_from((False, True)),
       n_global=st.integers(0, 2), n_random=st.integers(0, 2))
def test_token_csr_invariants(seq, window, block, causal, n_global, n_random):
    """Sorted unique in-range columns, token-level causality, every edge
    covered by an active block — and the reference's CSR, element for
    element."""
    spec = patterns.bigbird(seq, window, n_global, n_random, block=block,
                            causal=causal)
    mask = patterns.build_mask(spec)
    indptr, indices = mask.csr.indptr.numpy(), mask.csr.indices.numpy()
    bm = mask.block_mask
    assert mask.csr.shape == (seq, seq)
    for i in range(seq):
        cols = indices[indptr[i]:indptr[i + 1]]
        assert (np.diff(cols) > 0).all()
        assert (cols < seq).all() and (cols >= 0).all()
        if causal:
            assert (cols <= i).all()
        assert bm[i // block, cols // block].all()
    if causal:
        assert not np.triu(bm, 1).any()
    ref = ref_patterns.build_mask(ref_patterns.bigbird(
        seq, window, n_global, n_random, block=block, causal=causal))
    np.testing.assert_array_equal(indices, np.asarray(ref.csr.indices))


def test_bigbird_deterministic_and_superset():
    spec = patterns.bigbird(96, 1, n_global=1, n_random=2, block=16, seed=3)
    m1, m2 = patterns.build_mask(spec), patterns.build_mask(spec)
    np.testing.assert_array_equal(m1.block_mask, m2.block_mask)
    band = patterns.build_mask(patterns.sliding_window(96, 1, block=16)).block_mask
    assert (m1.block_mask | band).sum() == m1.nnz_blocks
    assert m1.block_mask[0, :].all() and m1.block_mask[:, 0].all()


def test_spec_validation_and_hashability():
    with pytest.raises(ValueError):
        patterns.AttentionSpec("poisson", 64)
    with pytest.raises(ValueError):
        patterns.sliding_window(0, 1)
    with pytest.raises(ValueError):
        patterns.AttentionSpec("sliding_window", 64, window=-1)
    with pytest.raises(ValueError):
        patterns.from_block_mask(np.ones((2, 2), bool), 64, block=8)
    with pytest.raises(ValueError):                # nothing active
        patterns.build_mask(patterns.from_block_mask(np.zeros((2, 2), bool),
                                                     16, block=8))
    s1 = patterns.sliding_window(64, 2, block=8, causal=True)
    assert s1 == patterns.sliding_window(64, 2, block=8, causal=True)
    assert len({s1, patterns.dense_attention(64, block=8)}) == 2


# ---------------------------------------------------------------------------
# the "torch" lowerings and the plain K9 / K10 against the reference
# ---------------------------------------------------------------------------

def _slabs(spec, rng, d=16, n=None):
    """One pattern in both packages' balanced slabs, Q/K/V and a bias
    stream and slab, as numpy (ref) and torch (port)."""
    csr = ref_patterns.build_mask(spec).csr
    rb = ref_formats.csr_to_balanced(csr, TILE)
    pb = formats.csr_to_balanced(_port_csr(csr), TILE)
    np.testing.assert_array_equal(pb.rows.numpy(), np.asarray(rb.rows))
    q, k, v = _qkv(rng, spec.seq, d, n)
    bias = (rng.standard_normal(csr.nnz) * 0.5).astype(np.float32)
    slab = np.zeros(rb.rows.size, np.float32)
    slab[:csr.nnz] = bias
    return csr, rb, pb, (q, k, v), bias, slab.reshape(rb.rows.shape)


@pytest.mark.parametrize("name", ["window_causal", "bigbird", "empty_row"])
@pytest.mark.parametrize("scale", [0.25, 1.0])
def test_attn_stats_match_reference(name, scale):
    csr, rb, pb, (q, k, _), _, slab = _slabs(SPECS[name],
                                            np.random.default_rng(0))
    m = csr.shape[0]
    jq, jk, js = jnp.asarray(q), jnp.asarray(k), jnp.asarray(slab)
    want_xla = ref_spmm.attn_stats_xla(rb.rows, rb.cols, jq, jk, js,
                                       shape=csr.shape, scale=scale)
    wb = 8
    vt, vb, vs = map(jnp.asarray, ref_vsr.plan_visits(rb, wb))
    pm, ps = ref_attention.attn_stats_pallas(
        rb.rows, rb.cols, jq, jk, js, shape=csr.shape, scale=scale, wb=wb,
        visit_tile=vt, visit_block=vb, visit_start=vs, interpret=True)
    want_pallas = (np.asarray(pm).reshape(-1)[:m], np.asarray(ps).reshape(-1)[:m])
    tq, tk, ts = _t(q, k, slab)
    rm, rs = spmm.attn_stats_torch(pb.rows, pb.cols, tq, tk, ts,
                                   shape=csr.shape, scale=scale)
    assert rm.shape == (m + 1,) and rs.shape == (m + 1,)
    empty = _empty_rows(csr)
    for fn in (attention.attn_stats_plain, attention.attn_stats_fused):
        got = fn(pb.rows, pb.cols, tq, tk, ts, shape=csr.shape, scale=scale)
        assert got[0].shape == (m,) and got[1].shape == (m,)
        assert (got[0].numpy()[empty] == spmm.SOFTMAX_NEG).all()
        assert (got[1].numpy()[empty] == 0).all()
        for want in ((np.asarray(want_xla[0])[:m], np.asarray(want_xla[1])[:m]),
                     want_pallas):
            _close(got[0][torch.from_numpy(~empty)], want[0][~empty])
            _close(got[1], want[1])
        _close(got[0], rm[:m].numpy())


@pytest.mark.parametrize("name", ["window", "bigbird_causal", "empty_row"])
@pytest.mark.parametrize("n", [1, 24])
def test_attn_chain_matches_reference(name, n):
    csr, rb, pb, (q, k, v), _, slab = _slabs(SPECS[name],
                                            np.random.default_rng(1), n=n)
    v = v[:, 0] if n == 1 else v
    jq, jk, js, jv = map(jnp.asarray, (q, k, slab, v))
    kw = dict(shape=csr.shape, scale=0.25)
    want_xla = ref_spmm.attn_chain_xla(rb.rows, rb.cols, jq, jk, js, jv, **kw)
    want_pallas = ref_attention.attn_chain_pallas(rb.rows, rb.cols, jq, jk,
                                                  js, jv, interpret=True, **kw)
    tq, tk, ts, tv = _t(q, k, slab, v)
    empty = _empty_rows(csr)
    for fn in (spmm.attn_chain_torch, attention.attn_chain_plain,
               attention.attn_chain_fused, attention.attn_unfused):
        got = fn(pb.rows, pb.cols, tq, tk, ts, tv, **kw)
        assert got.dtype == torch.float32 and got.shape == tuple(want_xla.shape)
        _close(got, want_xla)
        _close(got, want_pallas)
        assert (got.numpy()[empty] == 0).all()


def test_attn_chain_external_stats_and_bf16_v():
    csr, rb, pb, (q, k, v), _, slab = _slabs(SPECS["bigbird"],
                                            np.random.default_rng(2))
    m = csr.shape[0]
    jq, jk, js, jv = map(jnp.asarray, (q, k, slab, v))
    kw = dict(shape=csr.shape, scale=0.25)
    # stats from the reference's own pass 1 (the sharded merge's hook), its
    # (mb, wb) blocks flattened for the port
    wb = 8
    visits = dict(zip(("visit_tile", "visit_block", "visit_start"),
                      map(jnp.asarray, ref_vsr.plan_visits(rb, wb))))
    rm, rs = ref_attention.attn_stats_pallas(rb.rows, rb.cols, jq, jk, js,
                                             wb=wb, interpret=True, **visits,
                                             **kw)
    want = ref_attention.attn_chain_pallas(rb.rows, rb.cols, jq, jk, js, jv,
                                           interpret=True, stats=(rm, rs),
                                           wb=wb, **visits, **kw)
    tq, tk, ts, tv = _t(q, k, slab, v)
    stats = _t(np.asarray(rm).reshape(-1)[:m], np.asarray(rs).reshape(-1)[:m])
    for fn in (attention.attn_chain_plain, attention.attn_chain_fused,
               attention.attn_unfused):
        _close(fn(pb.rows, pb.cols, tq, tk, ts, tv, stats=stats, **kw), want)
    got = attention.attn_chain_fused(pb.rows, pb.cols, tq, tk, ts, tv.bfloat16(),
                                     **kw)
    assert got.dtype == torch.bfloat16
    want_bf16 = ref_attention.attn_chain_pallas(
        rb.rows, rb.cols, jq, jk, js, jv.astype(jnp.bfloat16), interpret=True,
        **kw)
    # bfloat16 V: rtol 2e-2 (V and the output rounded to 8 bits)
    _close(got, np.asarray(want_bf16.astype(jnp.float32)), rtol=2e-2,
           atol_rel=2e-2)


def test_cpu_attention_wrappers_count_no_launches_and_reject():
    csr, _, pb, (q, k, v), _, slab = _slabs(SPECS["window"],
                                           np.random.default_rng(3))
    tq, tk, ts, tv = _t(q, k, slab, v)
    reset_launch_counts()
    attention.attn_stats_fused(pb.rows, pb.cols, tq, tk, ts, shape=csr.shape)
    attention.attn_chain_fused(pb.rows, pb.cols, tq, tk, ts, tv,
                               shape=csr.shape)
    assert set(launch_counts().values()) == {0}
    with pytest.raises(ValueError):          # operands on two devices
        attention.attn_chain_fused(pb.rows, pb.cols, tq, tk, ts.to("meta"), tv,
                                   shape=csr.shape)


# ---------------------------------------------------------------------------
# sparse_attention against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["window", "window_causal", "bigbird",
                                  "empty_row"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_sparse_attention_matches_reference(name, with_bias):
    ref_spec = SPECS[name]
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, ref_spec.seq, 16)
    nnz = ref_patterns.build_mask(ref_spec).csr.nnz
    bias = (rng.standard_normal(nnz) * 0.5).astype(np.float32) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    spec = _port_spec(ref_spec)
    tq, tk, tv = _t(q, k, v)
    empty = _empty_rows(ref_patterns.build_mask(ref_spec).csr)
    for ref_backend in ("xla", "pallas"):
        want = ref_api.sparse_attention(ref_spec, jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), bias=jb,
                                        backend=ref_backend, cache=False)
        for backend in ("torch", "hopper"):
            got = repro_torch.sparse_attention(spec, tq, tk, tv, bias=tb,
                                               backend=backend, cache=False)
            _close(got, want)
            assert np.isfinite(got.numpy()).all()
            assert (got.numpy()[empty] == 0).all()    # fully masked rows
    assert empty.any() == (name == "empty_row")


def test_sparse_attention_batched_leading_dims_and_scale():
    ref_spec = SPECS["window_causal"]
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, ref_spec.seq, 8, lead=(2, 3))
    bias = ref_api.build_mask(ref_spec).csr.nnz
    bias = (rng.standard_normal(bias) * 0.5).astype(np.float32)
    want = ref_api.sparse_attention(ref_spec, *map(jnp.asarray, (q, k, v)),
                                    scale=0.4, bias=jnp.asarray(bias),
                                    backend="xla", cache=False)
    cache = PlanCache()
    got = repro_torch.sparse_attention(_port_spec(ref_spec), *_t(q, k, v),
                                       scale=0.4, bias=torch.from_numpy(bias),
                                       cache=cache)
    assert got.shape == q.shape
    _close(got, want)
    assert cache.stats()["builds"] == 1        # one plan for all six heads


def test_sparse_attention_validation():
    spec = _port_spec(SPECS["window"])
    q, k, v = _t(*_qkv(np.random.default_rng(6), spec.seq, 8))
    with pytest.raises(ValueError):          # sequence length
        repro_torch.sparse_attention(spec, q[:16], k[:16], v[:16], cache=False)
    with pytest.raises(ValueError):          # q/k shapes disagree
        repro_torch.sparse_attention(spec, q, k[:12], v, cache=False)
    with pytest.raises(ValueError):          # bias not one value an edge
        repro_torch.sparse_attention(spec, q, k, v, bias=torch.ones(3),
                                     cache=False)
    with pytest.raises(ValueError):          # operands on two devices
        repro_torch.sparse_attention(spec, q, k, v.to("meta"), cache=False)
    p = repro_torch.attention_plan(spec, device="cpu", cache=False)
    with pytest.raises(ValueError):          # Q rows != M
        plan_mod.execute_attention(p, q[1:], k, v)
    with pytest.raises(ValueError):          # V rows != K
        plan_mod.execute_attention(p, q, k, v[1:])
    with pytest.raises(ValueError):          # a 2-D bias
        plan_mod.execute_attention(p, q, k, v,
                                   bias=torch.zeros(1, p.csr.nnz))


def test_attention_plan_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    spec = _port_spec(SPECS["window"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.attention_plan(spec, cache=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.SparseAttention(spec).plan
    p = repro_torch.attention_plan(spec, device="cpu", cache=False)
    assert p.device.type == "cpu" and p.backend == "torch"
    assert p.chain_op == "attn"
    layer = repro_torch.SparseAttention(spec, device="cpu")
    assert layer.plan.device.type == "cpu"
    q, k, v = _t(*_qkv(np.random.default_rng(7), spec.seq, 8))
    with pytest.raises(ValueError):          # operands off the layer's device
        layer(q.to("meta"), k.to("meta"), v.to("meta"))


# ---------------------------------------------------------------------------
# plan rules
# ---------------------------------------------------------------------------

def _recording(monkeypatch, module, name, calls):
    original = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return original(*args, **kw)
    monkeypatch.setattr(module, name, wrapped)


def test_shut_attention_gate_runs_the_ports_unfused_kernels(monkeypatch):
    """``attn_fuse_min_seq`` above the sequence length: a ``"hopper"`` plan
    runs K6 → K9 → K1 with a bias and K6 → K7 → K1 without (their plain
    versions on the CPU), never the ``"torch"`` entries; the results equal
    the fused path's."""
    ref_spec = SPECS["window_causal"]
    spec = _port_spec(ref_spec)
    rng = np.random.default_rng(8)
    q, k, v = _t(*_qkv(rng, spec.seq, 16))
    bias = torch.from_numpy(interop.alibi_bias(
        patterns.build_mask(spec).csr, 0.125))
    calls = []
    for name in ("sddmm_fused", "chain_stats_fused", "chain_fused"):
        _recording(monkeypatch, fused_chain, name, calls)
    for name in ("attn_stats_fused", "attn_chain_fused"):
        _recording(monkeypatch, attention, name, calls)
    _recording(monkeypatch, vsr, "spmm_vsr_fused", calls)

    def refuse(*args, **kw):
        raise AssertionError("a torch entry ran on a hopper plan")
    for logical in ("chain", "attn_chain"):
        entry = registry.resolve(logical, "torch")
        monkeypatch.setitem(registry._REGISTRY, (logical, "torch"),
                            dataclasses.replace(entry, fn=refuse))
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               attn_fuse_min_seq=spec.seq + 1)
    run = dict(backend="hopper", cache=False)
    fused = repro_torch.sparse_attention(spec, q, k, v, bias=bias, **run)
    assert calls == ["attn_chain_fused"]
    calls.clear()
    unfused = repro_torch.sparse_attention(spec, q, k, v, bias=bias,
                                           thresholds=shut, **run)
    assert calls == ["sddmm_fused", "attn_stats_fused", "spmm_vsr_fused"]
    _close(unfused, fused.numpy())
    calls.clear()
    plain = repro_torch.sparse_attention(spec, q, k, v, **run)
    assert calls == ["chain_fused"]
    calls.clear()
    plain_unfused = repro_torch.sparse_attention(spec, q, k, v,
                                                 thresholds=shut, **run)
    assert calls == ["sddmm_fused", "chain_stats_fused", "spmm_vsr_fused"]
    _close(plain_unfused, plain.numpy())
    # the gate's edge: a sequence of exactly attn_fuse_min_seq fuses
    calls.clear()
    at_edge = dataclasses.replace(shut, attn_fuse_min_seq=spec.seq)
    repro_torch.sparse_attention(spec, q, k, v, bias=bias, thresholds=at_edge,
                                 **run)
    assert calls == ["attn_chain_fused"]


def test_plan_reuse_across_layers_and_scoped_cache():
    spec = _port_spec(SPECS["window_causal"])
    q, k, v = _t(*_qkv(np.random.default_rng(9), spec.seq, 8))
    pc = PlanCache(8)
    layers = [repro_torch.SparseAttention(spec, device="cpu", cache=pc)
              for _ in range(2)]
    y0, y1 = layers[0](q, k, v), layers[1](q, k, v)
    assert torch.equal(y0, y1)
    assert pc.stats()["builds"] == 1 and pc.stats()["hits"] >= 1
    assert layers[0].plan is layers[1].plan
    assert "seq=64" in repr(layers[0])
    scoped = PlanCache(4)
    with repro_torch.scoped_plan_cache(scoped):
        repro_torch.sparse_attention(spec, q, k, v)
        repro_torch.sparse_attention(spec, q, k, v)
    assert scoped.stats()["builds"] == 1 and scoped.stats()["hits"] == 1
    assert attn_module._resolve_cache(True) is repro_torch.api.DEFAULT_CACHE


def test_plan_cache_segments_attention_from_chain():
    """An attention plan and a chain plan over one CSR topology are distinct
    cache entries (the ``chain_op`` key segment)."""
    csr = patterns.build_mask(patterns.sliding_window(24, 1, block=8)).csr
    pc = PlanCache(8)
    pa = cached_plan(csr, cache=pc, backend="torch", chain_op="attn")
    ps = cached_plan(csr, cache=pc, backend="torch", chain_op="softmax")
    assert pa is not ps and pa.chain_op == "attn"
    assert cached_plan(csr, cache=pc, backend="torch", chain_op="attn") is pa
    assert pc.stats()["builds"] == 2 and pc.stats()["hits"] == 1


def test_operands_requiring_grad_get_grads():
    """The calls the refusal made before attention's backward (q, v or the
    bias requiring grad) carry a ``grad_fn`` on both backends, and their
    grads are ``jax.grad`` of the reference's ``sparse_attention``; under
    ``no_grad`` no output requires grad (``tests/test_torch_attention_
    grads.py`` holds the whole backward)."""
    import jax
    ref_spec = SPECS["window"]
    spec = _port_spec(ref_spec)
    qn, kn, vn = _qkv(np.random.default_rng(10), spec.seq, 8)
    q, k, v = _t(qn, kn, vn)
    bias = torch.zeros(patterns.build_mask(spec).csr.nnz)
    jq, jk, jv = (jnp.asarray(t) for t in (qn, kn, vn))
    jb = jnp.zeros(bias.shape[0])
    att = lambda qq, kk, vv, bb=None: ref_api.sparse_attention(  # noqa: E731
        ref_spec, qq, kk, vv, bias=bb, backend="xla", cache=False).sum()
    want = (jax.grad(lambda qq: att(qq, jk, jv))(jq),
            jax.grad(lambda vv: att(jq, jk, vv))(jv),
            jax.grad(lambda bb: att(jq, jk, jv, bb))(jb))
    for backend in ("torch", "hopper"):
        run = dict(backend=backend, cache=False)
        leaves = (q.clone().requires_grad_(), v.clone().requires_grad_(),
                  bias.clone().requires_grad_())
        calls = (
            lambda: repro_torch.sparse_attention(spec, leaves[0], k, v, **run),
            lambda: repro_torch.sparse_attention(spec, q, k, leaves[1], **run),
            lambda: repro_torch.sparse_attention(spec, q, k, v, bias=leaves[2],
                                                 **run))
        for call, leaf, w in zip(calls, leaves, want):
            y = call()
            assert y.grad_fn is not None
            y.sum().backward()
            _close(leaf.grad, w)
            with torch.no_grad():
                assert not call().requires_grad


# ---------------------------------------------------------------------------
# the model's block-sparse attention, and the state carried across
# ---------------------------------------------------------------------------

def test_block_sparse_attention_gemma3_smoke():
    """``_block_sparse_attention`` at ``gemma3_12b.SMOKE`` with the
    ``block_sparse`` pattern (4 query heads, 2 KV heads: GQA 2:1 repeats
    each KV head in place) against the reference's."""
    ref_cfg = dataclasses.replace(ref_gemma.SMOKE, attn_pattern="block_sparse",
                                  attn_block=8)
    cfg = dataclasses.replace(gemma3_12b.SMOKE, attn_pattern="block_sparse",
                              attn_block=8)
    assert cfg == interop.model_config_from_fields(**dataclasses.asdict(ref_cfg))
    rng = np.random.default_rng(11)
    b, s, h, hk, hd = 2, 48, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert (h, hk) == (4, 2)
    qt = (rng.standard_normal((b, h, s, hd)) * 0.3).astype(np.float32)
    kt = (rng.standard_normal((b, hk, s, hd)) * 0.3).astype(np.float32)
    vt = rng.standard_normal((b, hk, s, hd)).astype(np.float32)
    for causal in (True, False):
        spec = transformer._block_sparse_spec(cfg, s, causal)
        ref_spec = ref_transformer._block_sparse_spec(ref_cfg, s, causal)
        assert spec == _port_spec(ref_spec)
        want = ref_transformer._block_sparse_attention(
            jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt), ref_cfg, causal)
        got = transformer._block_sparse_attention(*_t(qt, kt, vt), cfg,
                                                  causal)
        assert got.shape == (b, h, s, hd) and got.dtype == torch.float32
        _close(got, want)


def test_interop_fields_and_alibi_bias():
    ref_spec = SPECS["empty_row"]
    spec = _port_spec(ref_spec)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    assert hash(spec) == hash(_port_spec(ref_spec))
    assert interop.model_config_from_fields(
        **dataclasses.asdict(ref_gemma.CONFIG)) == gemma3_12b.CONFIG
    ref_csr = ref_patterns.build_mask(SPECS["bigbird"]).csr
    port_csr = patterns.build_mask(_port_spec(SPECS["bigbird"])).csr
    a, b = interop.alibi_bias(ref_csr, 0.5), interop.alibi_bias(port_csr, 0.5)
    assert a.dtype == np.float32 and a.shape == (ref_csr.nnz,)
    np.testing.assert_array_equal(a, b)
    dense = np.asarray(ref_csr.to_dense()) != 0
    i, j = np.nonzero(dense)
    np.testing.assert_array_equal(a, -0.5 * np.abs(i - j).astype(np.float32))
