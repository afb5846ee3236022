"""K7 and K8 on the block design, on the CPU: the block evaluator without a
bias (``attn_*_blocks_plain(..., bias=None)``, ``z = alpha·s`` at the kept
keys) against the reference's Pallas chain kernels in interpret mode and the
port's plain versions; the routing rule of the ``chain`` entry (a block
pattern to the block design; a scattered graph, identity and scale, a mixed
X type and d > 256 to the slot-tile design); one block layout per plan for
the ``chain`` and ``attn_chain`` entries; and non-finite values at masked
keys (a V row poisons only the rows that keep its key, a K row none), for
the chain and for attention with a zero bias, against the reference.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance, float32: rtol 1e-5 and atol 1e-5 of the result's largest
magnitude (the tiles sum the dot products and the rows' exponentials in
another order than the slot stream)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.attention import patterns as ref_patterns
from repro.core import formats as ref_formats
from repro.kernels import fused_chain as ref_chain
from repro.kernels import vsr as ref_vsr
import repro_torch
from repro_torch import interop
from repro_torch.attention import patterns
from repro_torch.core import formats
from repro_torch.core.rmat import rmat
from repro_torch.kernels import (attention, blocks, fused_chain, launch_counts,
                                 reset_launch_counts)

TILE = 512

#: reference specs of the parity tests: a causal window and BigBird (its
#: global row blocks span the whole sequence), ragged against the 64-row
#: block at seq 300
PARITY_SPECS = {
    "window_causal_256": ref_api.sliding_window(256, 1, block=64, causal=True),
    "window_causal_300": ref_api.sliding_window(300, 2, block=32, causal=True),
    "bigbird_512": ref_api.bigbird(512, 1, 1, 1, block=64, seed=1),
}


def _port_csr(csr):
    return interop.csr_from_arrays(np.asarray(csr.indptr),
                                   np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _operands(spec, rng, d, n):
    """The pattern in both packages (reference slab, port slab, the port's
    block layout) and A, B, X of the chain."""
    csr = ref_patterns.build_mask(spec).csr
    rb = ref_formats.csr_to_balanced(csr, TILE)
    pb = formats.csr_to_balanced(_port_csr(csr), TILE)
    layout = blocks.build_block_layout(pb.rows, pb.cols, csr.shape)
    assert layout is not None
    seq = csr.shape[0]
    a = (rng.standard_normal((seq, d)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((seq, d)) * 0.5).astype(np.float32)
    x = rng.standard_normal((seq, n)).astype(np.float32)
    return csr, rb, pb, layout, a, b, (x[:, 0] if n == 1 else x)


def _visits(rb, wb=8):
    return dict(zip(("visit_tile", "visit_block", "visit_start"),
                    map(jnp.asarray, ref_vsr.plan_visits(rb, wb))), wb=wb)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol = atol_rel * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ---------------------------------------------------------------------------
# the no-bias block evaluator against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("alpha", [None, 0.3])
@pytest.mark.parametrize("name", sorted(PARITY_SPECS))
def test_block_chain_stats_match_pallas_and_plain(name, alpha, d):
    csr, rb, pb, layout, a, b, _ = _operands(PARITY_SPECS[name],
                                             np.random.default_rng(0), d, 1)
    m = csr.shape[0]
    ta, tb = _t(a, b)
    scale = 1.0 if alpha is None else alpha
    got = blocks.attn_stats_blocks_plain(layout, ta, tb, scale=scale)
    assert all(g.shape == (m,) and g.dtype == torch.float32 for g in got)
    pm, ps = ref_chain.chain_stats_pallas(
        rb.rows, rb.cols, jnp.asarray(a), jnp.asarray(b), shape=csr.shape,
        alpha=alpha, interpret=True, **_visits(rb))
    pallas = (np.asarray(pm).reshape(-1)[:m], np.asarray(ps).reshape(-1)[:m])
    plain = fused_chain.chain_stats_plain(pb.rows, pb.cols, ta, tb,
                                          shape=csr.shape, alpha=alpha)
    for want in (pallas, (plain[0].numpy(), plain[1].numpy())):
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("n", [1, 64, 300])
@pytest.mark.parametrize("name", sorted(PARITY_SPECS))
def test_block_chain_matches_pallas_and_plain(name, n):
    csr, rb, pb, layout, a, b, x = _operands(PARITY_SPECS[name],
                                             np.random.default_rng(1), 32, n)
    ta, tb, tx = _t(a, b, x)
    alpha = 0.3
    got = blocks.attn_chain_blocks_plain(layout, ta, tb, None, tx,
                                         scale=alpha)
    kw = dict(shape=csr.shape, transform="softmax", alpha=alpha)
    pallas = ref_chain.chain_pallas(rb.rows, rb.cols, jnp.asarray(a),
                                    jnp.asarray(b), jnp.asarray(x),
                                    interpret=True, **_visits(rb), **kw)
    plain = fused_chain.chain_plain(pb.rows, pb.cols, ta, tb, tx, **kw)
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    _close(got, np.asarray(pallas))
    _close(got, plain.numpy())
    # given statistics, as K8 takes K7's
    stats = fused_chain.chain_stats_plain(pb.rows, pb.cols, ta, tb,
                                          shape=csr.shape, alpha=alpha)
    _close(blocks.attn_chain_blocks_plain(layout, ta, tb, None, tx,
                                          scale=alpha, stats=stats),
           plain.numpy())


def test_no_bias_evaluator_equals_a_zero_bias():
    """Without a bias the evaluator computes what it computes with a zero
    bias slab, bit for bit."""
    csr, _, pb, layout, a, b, x = _operands(PARITY_SPECS["bigbird_512"],
                                            np.random.default_rng(2), 64, 8)
    ta, tb, tx = _t(a, b, x)
    zero = torch.zeros(pb.rows.shape)
    for got, want in (
            (blocks.attn_stats_blocks_plain(layout, ta, tb, scale=0.2),
             blocks.attn_stats_blocks_plain(layout, ta, tb, zero, scale=0.2)),
            ((blocks.attn_chain_blocks_plain(layout, ta, tb, None, tx,
                                             scale=0.2),),
             (blocks.attn_chain_blocks_plain(layout, ta, tb, zero, tx,
                                             scale=0.2),))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the routing rule of the chain entry
# ---------------------------------------------------------------------------

def _band(seq=256):
    csr = patterns.build_mask(patterns.sliding_window(seq, 1, block=64,
                                                      causal=True)).csr
    return csr, formats.csr_to_balanced(csr, TILE)


@pytest.mark.parametrize("case", ["band_softmax", "band_bf16", "rmat_softmax",
                                  "band_identity", "band_scale",
                                  "mixed_x_type", "d_264"])
def test_chain_routing_rule(case):
    if case == "rmat_softmax":
        csr = rmat(12, 8, seed=0)
        bal = formats.csr_to_balanced(csr, TILE)
    else:
        csr, bal = _band()
    m, k = csr.shape
    d = 264 if case == "d_264" else 64
    dt = torch.bfloat16 if case == "band_bf16" else torch.float32
    a, b = torch.zeros(m, d, dtype=dt), torch.zeros(k, d, dtype=dt)
    x = torch.zeros(k, 8, dtype=torch.bfloat16 if case == "mixed_x_type"
                    else dt)
    transform = {"band_identity": "identity",
                 "band_scale": "scale"}.get(case, "softmax")
    cache = blocks.AttnBlocks()
    route, layout = fused_chain._route(None, transform, cache, bal.rows,
                                       bal.cols, csr.shape, a, b, x)
    want = "block" if case in ("band_softmax", "band_bf16") else "slot"
    assert route == want and (layout is not None) == (want == "block")
    assert fused_chain._route("slot", transform, cache, bal.rows, bal.cols,
                              csr.shape, a, b, x) == ("slot", None)
    if want == "slot":
        with pytest.raises(ValueError):
            fused_chain._route("block", transform, cache, bal.rows, bal.cols,
                               csr.shape, a, b, x)
    # K7 alone sees no X: the band takes the block design whatever X is
    stats_route = blocks._route("chain_stats", None, cache, bal.rows,
                                bal.cols, csr.shape, a, b)[0]
    assert stats_route == ("slot" if case in ("rmat_softmax", "d_264")
                           else "block")


def test_plan_shares_one_layout_across_chain_and_attention():
    """The ``chain`` and ``attn_chain`` entries of one plan read one
    ``AttnBlocks``; a second plan has its own."""
    spec = patterns.sliding_window(256, 1, block=64, causal=True)
    p = repro_torch.attention_plan(spec, backend="hopper", device="cpu",
                                   cache=False)
    chain = p.kernel_opts(p.entry("chain"))["blocks"]
    assert isinstance(chain, blocks.AttnBlocks)
    assert p.kernel_opts(p.entry("attn_chain"))["blocks"] is chain
    q = repro_torch.attention_plan(spec, backend="hopper", device="cpu",
                                   cache=False)
    assert q.kernel_opts(q.entry("chain"))["blocks"] is not chain
    g = repro_torch.sparse(rmat(8, 4, seed=1), device="cpu", cache=False,
                           chain_op="softmax").plan
    assert isinstance(g.kernel_opts(g.entry("chain", "hopper"))["blocks"],
                      blocks.AttnBlocks)


def test_cpu_chain_wrappers_take_the_plain_version_with_blocks():
    csr, bal = _band()
    rng = np.random.default_rng(5)
    a, b, x = (torch.from_numpy(rng.standard_normal((256, 16))
                                .astype(np.float32)) for _ in range(3))
    kw = dict(shape=csr.shape, alpha=0.25, blocks=blocks.AttnBlocks())
    reset_launch_counts()
    y = fused_chain.chain_fused(bal.rows, bal.cols, a, b, x,
                                transform="softmax", **kw)
    rm, rs = fused_chain.chain_stats_fused(bal.rows, bal.cols, a, b, **kw)
    yu = fused_chain.chain_unfused(bal.rows, bal.cols, a, b, x,
                                   transform="softmax", **kw)
    assert set(launch_counts().values()) == {0}
    assert all(set(c.values()) == {0}
               for c in fused_chain.DESIGN_LAUNCHES.values())
    want = fused_chain.chain_plain(bal.rows, bal.cols, a, b, x,
                                   shape=csr.shape, transform="softmax",
                                   alpha=0.25)
    _close(y, want.numpy())
    _close(yu, want.numpy())
    _close(rs, fused_chain.chain_stats_plain(bal.rows, bal.cols, a, b,
                                             shape=csr.shape, alpha=0.25)[1])


# ---------------------------------------------------------------------------
# non-finite values at masked keys
# ---------------------------------------------------------------------------

#: the input of the fault: rows 64-69 of the causal band do not keep key 70,
#: rows 70-127 (and the next block row's) do
FAULT_SEQ, FAULT_D, FAULT_KEY = 256, 64, 70


def _fault_inputs(value, where="v"):
    """Q, K, V from seed 0, ``value`` (unless None) in row 70 of V or K."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((FAULT_SEQ, FAULT_D)).astype(np.float32)
               for _ in range(3))
    if value is not None:
        {"v": v, "k": k}[where][FAULT_KEY] = value
    return q, k, v


def _same_class(got, want):
    """Equal where the reference is finite (within tolerance); NaN and ±inf
    exactly where it has them."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("value", [np.nan, np.inf])
@pytest.mark.parametrize("bias", [False, True], ids=["chain", "attention"])
def test_nonfinite_v_reaches_only_the_rows_that_keep_its_key(bias, value):
    """Reference: ``repro.api.sparse_attention`` (xla).  Rows 64-69 stay
    finite and equal the reference's; the rows that keep key 70 are NaN or
    inf as there — in the block evaluator, which models the block kernel,
    and in the port's plain versions."""
    spec = ref_api.sliding_window(FAULT_SEQ, 1, block=64, causal=True)
    q, k, v = _fault_inputs(value)
    csr = ref_patterns.build_mask(spec).csr
    keeps = np.zeros(FAULT_SEQ, bool)
    rows = np.repeat(np.arange(FAULT_SEQ), np.diff(np.asarray(csr.indptr)))
    keeps[rows[np.asarray(csr.indices) == FAULT_KEY]] = True
    assert not keeps[64:FAULT_KEY].any() and keeps[FAULT_KEY:128].all()
    ref_bias = jnp.zeros(csr.nnz, jnp.float32) if bias else None
    want = np.asarray(ref_api.sparse_attention(
        spec, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=ref_bias,
        backend="xla"))
    assert np.isfinite(want[64:FAULT_KEY]).all()
    assert not np.isfinite(want[keeps]).any()
    assert np.isfinite(want[~keeps]).all()

    pb = formats.csr_to_balanced(_port_csr(csr), TILE)
    layout = blocks.build_block_layout(pb.rows, pb.cols, csr.shape)
    tq, tk, tv = _t(q, k, v)
    scale = FAULT_D ** -0.5
    slab = torch.zeros(pb.rows.shape) if bias else None
    got = blocks.attn_chain_blocks_plain(layout, tq, tk, slab, tv,
                                         scale=scale)
    _same_class(got, want)
    if bias:
        plain = attention.attn_chain_plain(pb.rows, pb.cols, tq, tk, slab, tv,
                                           shape=csr.shape, scale=scale)
    else:
        plain = fused_chain.chain_plain(pb.rows, pb.cols, tq, tk, tv,
                                        shape=csr.shape, transform="softmax",
                                        alpha=scale)
    _same_class(plain, want)
    port = repro_torch.sparse_attention(
        patterns.sliding_window(FAULT_SEQ, 1, block=64, causal=True), tq, tk,
        tv, bias=torch.zeros(csr.nnz) if bias else None, cache=False)
    _same_class(port, want)


@pytest.mark.parametrize("bias", [False, True], ids=["chain", "attention"])
def test_nonfinite_k_at_a_masked_key_changes_nothing(bias):
    """Masking selects: a NaN K row at key 70 leaves rows 64-69 exactly as
    they are without it, in the block evaluator as in the reference."""
    spec = ref_api.sliding_window(FAULT_SEQ, 1, block=64, causal=True)
    csr = ref_patterns.build_mask(spec).csr
    pb = formats.csr_to_balanced(_port_csr(csr), TILE)
    layout = blocks.build_block_layout(pb.rows, pb.cols, csr.shape)
    slab = torch.zeros(pb.rows.shape) if bias else None
    out = {}
    for value in (None, np.nan):
        q, k, v = _fault_inputs(value, where="k")
        tq, tk, tv = _t(q, k, v)
        want = ref_api.sparse_attention(
            spec, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.125,
            bias=jnp.zeros(csr.nnz) if bias else None, backend="xla")
        out[value] = (blocks.attn_chain_blocks_plain(layout, tq, tk, slab, tv,
                                                     scale=0.125),
                      np.asarray(want))
    got, want = out[np.nan]
    assert torch.isfinite(got[64:FAULT_KEY]).all()
    assert torch.equal(got[64:FAULT_KEY], out[None][0][64:FAULT_KEY])
    _same_class(got, want)
