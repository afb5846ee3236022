"""The port's SSM mixers (``repro_torch.models.ssm``, ``.rwkv``) against the
reference's, on the CPU, in float32, with inputs made by numpy from a seed:
``causal_conv`` one-shot and streaming, ``ssd_chunked`` with a chunk that
divides the sequence, one that does not (the dt = 0 padding) and one longer
than it (``l = S``), ``ssd_decode_step``, ``mamba2_mix`` at prefill and
decode, ``_token_shift``, ``wkv6_scan``, ``rwkv6_time_mix`` and
``rwkv6_channel_mix``; mirrors of ``tests/test_models.py``'s
``test_rwkv_state_streaming`` and ``test_mamba_chunked_vs_stepwise`` on the
port; and the port's serve engine against ``repro``'s on the RWKV-6 and
Zamba2 smoke models (equal tokens, synchronous and asynchronous, the same
plan-cache builds).

Tolerance: relative inf-norm error (a tensor's largest difference over its
largest magnitude) 1e-5 against the reference; the reference tests' own
bounds (1e-3) for the streaming and stepwise contracts."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.configs import paper_spmm as ref_paper_spmm
from repro.models import Model as RefModel
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import configs, interop
from repro_torch.configs import paper_spmm
from repro_torch.models import Model, rwkv, ssm
from repro_torch.models.transformer import mamba_specs, rwkv_specs
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _batch_axes

CPU = torch.device("cpu")
TOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(*arrays):
    """Each numpy array as (jax array, torch tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(np.array(a))) for a in arrays]


def _ssd_inputs(b=2, s=16, h=4, p=8, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            (rng.random((b, s, h)) * 0.5 + 0.1).astype(np.float32),
            rng.random(h).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal(h).astype(np.float32))


def _random_params(specs, seed):
    """numpy arrays of the specs' shapes: N(0, 0.3²), ``a_log`` in [0, 1),
    the decay base ``w0`` around −1 (so the decay is neither 0 nor 1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(specs):
        shape = specs[k].shape
        if k == "a_log":
            out[k] = rng.random(shape).astype(np.float32)
        elif k == "w0":
            out[k] = (rng.standard_normal(shape) * 0.5 - 1.0).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True])
def test_causal_conv_matches_reference(streaming):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 12)).astype(np.float32)
    (jx, tx), (jw, tw), (jc, tc) = _both(x, w, cache)
    want, want_c = ref_ssm.causal_conv(jx, jw, jc if streaming else None)
    got, got_c = ssm.causal_conv(tx, tw, tc if streaming else None)
    assert _rel(got, want) <= TOL
    assert _rel(got_c, want_c) <= TOL
    # one token at a time through the cache is the one-shot conv
    c, ys = tc if streaming else torch.zeros(2, 3, 12), []
    for t in range(x.shape[1]):
        y, c = ssm.causal_conv(tx[:, t:t + 1], tw, c)
        ys.append(y)
    assert _rel(torch.cat(ys, 1), want) <= TOL


@pytest.mark.parametrize("chunk", [4, 5, 512])
def test_ssd_chunked_matches_reference(chunk):
    """chunk 4 divides S = 16; 5 does not (three padded steps, dt = 0);
    512 is past S (one chunk of ``l = S``)."""
    arrays = _ssd_inputs()
    jin, tin = zip(*_both(*arrays))
    want_y, want_s = ref_ssm.ssd_chunked(*jin, chunk=chunk)
    got_y, got_s = ssm.ssd_chunked(*tin, chunk=chunk)
    assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
    assert _rel(got_y, want_y) <= TOL
    assert _rel(got_s, want_s) <= TOL


def test_ssd_decode_step_matches_reference():
    x, dt, a_log, b, c, d = _ssd_inputs(s=1)
    state = np.random.default_rng(2).standard_normal(
        (2, 4, 8, 8)).astype(np.float32)
    jin, tin = zip(*_both(state, x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0],
                          d))
    want_y, want_s = ref_ssm.ssd_decode_step(*jin)
    got_y, got_s = ssm.ssd_decode_step(*tin)
    assert _rel(got_y, want_y) <= TOL
    assert _rel(got_s, want_s) <= TOL


def test_mamba_chunked_vs_stepwise():
    """The mirror of the reference's test: zamba2's SSD chunked scan equals
    the step-by-step recurrence (y and the final state), on the port."""
    x, dt, a_log, bb, cc, _ = (torch.from_numpy(a) for a in _ssd_inputs())
    d = torch.zeros(4)
    y_chunk, state_chunk = ssm.ssd_chunked(x, dt, a_log, bb, cc, d, chunk=4)
    state = torch.zeros(2, 4, 8, 8)
    ys = []
    for t in range(x.shape[1]):
        y, state = ssm.ssd_decode_step(state, x[:, t], dt[:, t], a_log,
                                       bb[:, t], cc[:, t], d)
        ys.append(y)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(state_chunk.numpy(), state.numpy(),
                               atol=1e-3, rtol=1e-3)


def test_mamba2_mix_prefill_and_decode_match_reference():
    """The mixer at prefill (13 tokens, chunk 8: the padding path) with a
    zero conv cache, then one decode step on the state and conv cache the
    prefill left."""
    cfg = configs.get_smoke("zamba2-2.7b")
    ref_cfg = ref_configs.get_smoke("zamba2-2.7b")
    params = _random_params(mamba_specs(cfg), 3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x = np.random.default_rng(4).standard_normal(
        (2, 14, cfg.d_model)).astype(np.float32)
    s_ = cfg.ssm
    conv0 = np.zeros((2, s_.conv_width - 1,
                      s_.expand * cfg.d_model + 2 * s_.d_state), np.float32)
    want, (ws, wc) = ref_ssm.mamba2_mix(jp, jnp.asarray(x[:, :13]), ref_cfg.ssm,
                                        cfg.d_model,
                                        conv_cache=jnp.asarray(conv0))
    got, (gs, gc) = ssm.mamba2_mix(tp, torch.from_numpy(x[:, :13]), cfg.ssm,
                                   cfg.d_model,
                                   conv_cache=torch.from_numpy(conv0))
    for g, w in ((got, want), (gs, ws), (gc, wc)):
        assert _rel(g, w) <= TOL
    want, (ws, wc) = ref_ssm.mamba2_mix(jp, jnp.asarray(x[:, 13:]), ref_cfg.ssm,
                                        cfg.d_model, state=ws, conv_cache=wc,
                                        decode=True)
    got, (gs, gc) = ssm.mamba2_mix(tp, torch.from_numpy(x[:, 13:]), cfg.ssm,
                                   cfg.d_model, state=gs, conv_cache=gc,
                                   decode=True)
    for g, w in ((got, want), (gs, ws), (gc, wc)):
        assert _rel(g, w) <= TOL


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeded", [False, True])
def test_token_shift_matches_reference(seeded):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    prev = rng.standard_normal((2, 8)).astype(np.float32)
    (jx, tx), (jp, tp) = _both(x, prev)
    want = ref_rwkv._token_shift(jx, jp if seeded else None)
    got = rwkv._token_shift(tx, tp if seeded else None)
    assert _rel(got, want) == 0.0


def test_wkv6_scan_matches_reference():
    rng = np.random.default_rng(6)
    b, s, h, n = 2, 9, 3, 8
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 0.99, (b, s, h, n)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    state = rng.standard_normal((b, h, n, n)).astype(np.float32)
    jin, tin = zip(*_both(r, k, v, w, u, state))
    want_y, want_s = ref_rwkv.wkv6_scan(*jin)
    got_y, got_s = rwkv.wkv6_scan(*tin)
    assert _rel(got_y, want_y) <= TOL
    assert _rel(got_s, want_s) <= TOL


@pytest.mark.parametrize("streaming", [False, True])
def test_rwkv6_mixers_match_reference(streaming):
    """Time mix and channel mix on 6 tokens, from no state or from a state
    and previous tokens; the new ``x_prev`` is the input's last token."""
    cfg = configs.get_smoke("rwkv6-3b")
    params = _random_params(rwkv_specs(cfg), 7)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    rng = np.random.default_rng(8)
    d, h = cfg.d_model, cfg.num_heads
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    state = rng.standard_normal((2, h, d // h, d // h)).astype(np.float32)
    tm_prev, cm_prev = (rng.standard_normal((2, d)).astype(np.float32)
                        for _ in range(2))
    (jx, tx), (js, ts), (jt, tt), (jc, tc) = _both(x, state, tm_prev, cm_prev)
    kw_j = dict(state=js, x_prev=jt) if streaming else {}
    kw_t = dict(state=ts, x_prev=tt) if streaming else {}
    want, (ws, wx) = ref_rwkv.rwkv6_time_mix(jp, jx, h, **kw_j)
    got, (gs, gx) = rwkv.rwkv6_time_mix(tp, tx, h, **kw_t)
    assert _rel(got, want) <= TOL
    assert _rel(gs, ws) <= TOL
    assert torch.equal(gx, tx[:, -1])
    want, wx = ref_rwkv.rwkv6_channel_mix(jp, jx,
                                          x_prev=jc if streaming else None)
    got, gx = rwkv.rwkv6_channel_mix(tp, tx, x_prev=tc if streaming else None)
    assert _rel(got, want) <= TOL
    assert torch.equal(gx, tx[:, -1])


# ---------------------------------------------------------------------------
# the models' state handoff
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(name, **scaled):
    """(reference model, its params, port model, the same params)."""
    ref = RefModel(ref_configs.get_smoke(name).scaled(**scaled))
    ref_p = ref.init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke(name).scaled(**scaled)
    p = interop.model_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, ref_p), device=CPU)
    return ref, ref_p, Model(cfg), p


def test_rwkv_state_streaming():
    """The mirror of the reference's test: rwkv6's prefill of 11 tokens and
    a decode step equal the one-shot prefill of 12 (state handoff)."""
    _, _, model, params = _pair("rwkv6-3b")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (1, 12))).long()
    with torch.no_grad():
        logits_a, _ = model.prefill(params, {"tokens": toks}, 16)
        _, cache = model.prefill(params, {"tokens": toks[:, :11]}, 16)
        logits_b, _ = model.decode_step(params, cache, toks[:, 11:12])
    np.testing.assert_allclose(logits_a.numpy(), logits_b.numpy(), atol=1e-3)


def test_rwkv_cache_does_not_grow_with_max_len():
    """The RWKV-6 cache is O(1) in the sequence: the same bytes at any
    ``max_len``; Zamba2's grows only in its shared attention's KV."""
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in
                           jax.tree_util.tree_leaves(c))
    rwkv_m = Model(configs.get("rwkv6-3b"))
    small, large = (rwkv_m.init_cache(2, n, device="meta") for n in (640, 8192))
    assert nbytes(small) == nbytes(large)
    zamba = Model(configs.get("zamba2-2.7b"))
    small, large = (zamba.init_cache(1, n, device="meta") for n in (640, 8192))
    assert {k: v.shape for k, v in small.items() if k not in ("kv", "length")} \
        == {k: v.shape for k, v in large.items() if k not in ("kv", "length")}


@pytest.mark.parametrize("name", ["rwkv6-3b", "zamba2-2.7b", "whisper-tiny"])
def test_cache_axes_match_reference(name):
    """The engine's slot axes of the new caches, from skeletons on the meta
    device, are the reference's: the lane axis 1 of ``wkv`` / ``tm_prev`` /
    ``cm_prev`` and of the shared KV, 2 of ``ssm`` / ``conv``."""
    ref, _, model, _ = _pair(name)
    axes = _batch_axes(model.init_cache(1, 16, device="meta"),
                       model.init_cache(2, 16, device="meta"))
    ref_axes = _batch_axes(jax.eval_shape(lambda: ref.init_cache(1, 16)),
                           jax.eval_shape(lambda: ref.init_cache(2, 16)))
    assert axes == ref_axes
    want = {"rwkv6-3b": {"wkv": 1, "tm_prev": 1, "cm_prev": 1, "length": -1},
            "zamba2-2.7b": {"ssm": 2, "conv": 2, "kv": {"k": 1, "v": 1},
                            "length": -1},
            "whisper-tiny": {"kv": {"k": 1, "v": 1}, "length": -1}}[name]
    assert axes == want
    for k, v in jax.tree_util.tree_leaves_with_path(
            model.init_cache(2, 16, device=CPU)):
        assert v.device == CPU


# ---------------------------------------------------------------------------
# serving the new caches
# ---------------------------------------------------------------------------

ENGINE_CASES = {"rwkv6-3b": ("rwkv6-3b", {}),
                "zamba2-2.7b": ("zamba2-2.7b", {}),
                "zamba2-2.7b+block_sparse": ("zamba2-2.7b", dict(
                    attn_pattern="block_sparse", window=16, attn_block=8))}


def _serve(engine_cls, request_cls, model, params, prompts, **kw):
    eng = engine_cls(model, params, slots=2, max_len=48, **kw)
    for rid, prompt in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=list(prompt), max_new=5))
    done = eng.run_until_done(max_ticks=500)
    eng.close()
    assert all(r.done for r in done), [(r.rid, r.status) for r in done]
    return {r.rid: list(r.out) for r in done}, eng.plan_cache.stats()


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference_engine(case):
    """Three requests on two slots (churn: the third installs into a freed
    lane, each lane decoding at its own length): the port's synchronous and
    asynchronous engines give the tokens of the reference's synchronous
    engine, which equal the sequential greedy oracle; the plan-cache builds
    are the reference's (one attention plan a prompt length with
    ``block_sparse``, none without)."""
    name, scaled = ENGINE_CASES[case]
    ref, ref_p, model, p = _pair(name, **scaled)
    prompts = [[(5 * i + 3 * j + 1) % 256 for j in range(n)]
               for i, n in enumerate((9, 4, 12))]
    sync = dict(async_prefill=False, async_plans=False)
    want, ref_stats = _serve(RefServeEngine, RefRequest, ref, ref_p, prompts,
                             **sync)
    got, stats = _serve(ServeEngine, Request, model, p, prompts, **sync)
    got_async, _ = _serve(ServeEngine, Request, model, p, prompts)
    assert got == want
    assert got_async == got
    assert stats["builds"] == ref_stats["builds"] == \
        (len(prompts) if scaled else 0)
    assert stats["hits"] >= ref_stats["hits"]
    with torch.no_grad():
        for rid, prompt in enumerate(prompts):
            logits, cache = model.prefill(
                p, {"tokens": torch.tensor([prompt])}, 48)
            oracle = [int(logits[0].argmax())]
            while len(oracle) < 5:
                logits, cache = model.decode_step(
                    p, cache, torch.tensor([[oracle[-1]]]))
                oracle.append(int(logits[0].argmax()))
            assert got[rid] == oracle, rid


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_names_and_paper_spmm_match_reference():
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    assert dataclasses.asdict(paper_spmm.CONFIG) == \
        dataclasses.asdict(ref_paper_spmm.CONFIG)
    assert [f.name for f in dataclasses.fields(paper_spmm.PaperSpmmConfig)] \
        == [f.name for f in dataclasses.fields(ref_paper_spmm.PaperSpmmConfig)]
    assert "paper_spmm" not in configs.ARCH_NAMES
