"""The port's sparse-weight training path against the reference: AdamW,
its schedule and clip (``repro_torch.train.optim`` against
``repro.train.optim``), microbatch accumulation, and the ``SparseFFN``
layer — ``SparsePattern``, ``sparse_mlp_apply``, ``ffn_apply``'s sparse
branch — at ``gemma3_12b.SMOKE`` widths with a sparse FFN (tile 16): its
output and a 3-step AdamW loss trajectory against ``repro.train.
make_train_step`` on the reference's ``ffn_apply``, the weights carried by
``interop.sparse_ffn_from_arrays``.

Tolerances (float32): optimizer steps relative 1e-6; the layer's output and
the first step's grads relative 1e-5 of the largest magnitude (sums
reassociated); each loss of the trajectory relative 1e-5 and the parameters
after it 1e-5 of their largest magnitude (AdamW divides by sqrt(v), so a
reassociated sum moves an update by a few ulps of lr)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import gemma3_12b as ref_gemma
from repro.models.config import SparseFFNConfig as RefSparseFFNConfig
from repro.models.layers import SparsePattern as RefSparsePattern
from repro.models.transformer import ffn_apply as ref_ffn_apply
from repro.models.transformer import sparse_patterns as ref_sparse_patterns
from repro.train import OptConfig as RefOptConfig
from repro.train import TrainConfig as RefTrainConfig
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro.train.optim import adamw_update as ref_adamw_update
from repro.train.optim import schedule as ref_schedule
from repro_torch import interop
from repro_torch.configs import gemma3_12b
from repro_torch.core.plan import PATTERN_PREP, pattern_prep
from repro_torch.models import SparseFFN, SparsePattern, sparse_patterns
from repro_torch.models.config import SparseFFNConfig
from repro_torch.train import (OptConfig, TrainConfig, adamw_update, global_norm,
                               init_opt_state, init_state, make_train_step,
                               schedule)

REF_CFG = ref_gemma.SMOKE.scaled(sparse_ffn=RefSparseFFNConfig(tile=16))
CFG = gemma3_12b.SMOKE.scaled(sparse_ffn=SparseFFNConfig(tile=16))
TOKENS = (4, 8)            # batch, seq


def _close(got, want, rtol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _ref_layer(seed=17):
    """One layer of the reference's patterns and parameters (numpy), and the
    port's SparseFFN carrying them."""
    pats = ref_sparse_patterns(REF_CFG, seed)
    patterns = {k: RefSparsePattern(v.rows[0], v.cols[0], v.shape)
                for k, v in pats.items()}
    rng = np.random.default_rng(seed)
    params = {"ln": (0.1 * rng.standard_normal(REF_CFG.d_model)).astype(np.float32)}
    for name, pat in patterns.items():
        params[f"v_{name}"] = (0.1 * rng.standard_normal(pat.rows.shape)).astype(np.float32)
    ffn = interop.sparse_ffn_from_arrays(
        CFG, {k: (np.asarray(p.rows), np.asarray(p.cols)) for k, p in patterns.items()},
        params, device="cpu")
    return patterns, params, ffn


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    shape = TOKENS + (CFG.d_model,)
    return {"x": rng.standard_normal(shape).astype(np.float32),
            "y": rng.standard_normal(shape).astype(np.float32)}


def _ref_loss(patterns):
    def loss(p, batch):
        out, _ = ref_ffn_apply(p, batch["x"], REF_CFG, patterns)
        return jnp.mean((out - batch["y"]) ** 2), {}
    return loss


def _port_loss(ffn):
    def loss(p, batch):
        return torch.mean((ffn(batch["x"], p) - batch["y"]) ** 2), {}
    return loss


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_adamw_matches_reference():
    """One AdamW step against a hand-rolled numpy reference and against
    ``repro.train.optim.adamw_update`` with clipping and decay on."""
    cfg = OptConfig(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.0,
                    clip_norm=1e9, warmup_steps=0, total_steps=1, min_lr_ratio=1.0)
    p = {"w": torch.tensor([[1.0, -2.0]])}
    g = {"w": torch.tensor([[0.5, 0.5]])}
    newp, newst, _ = adamw_update(p, g, init_opt_state(p, cfg), cfg)
    m, v = 0.1 * 0.5, 0.01 * 0.25
    expect = 1.0 - 1e-2 * (m / 0.1) / (np.sqrt(v / 0.01) + 1e-8)
    np.testing.assert_allclose(float(newp["w"][0, 0]), expect, rtol=1e-5)
    assert int(newst["step"]) == 1
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    kw = dict(lr=3e-3, weight_decay=0.1, clip_norm=0.5, warmup_steps=2,
              total_steps=10)
    rcfg, pcfg = RefOptConfig(**kw), OptConfig(**kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    rst, pst = ref_init_state(rp, RefTrainConfig(opt=rcfg))["opt"], init_opt_state(pp, pcfg)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        rp, rst, rmet = ref_adamw_update(rp, {k: jnp.asarray(v) for k, v in grads.items()},
                                         rst, rcfg)
        pp, pst, pmet = adamw_update(pp, {k: torch.from_numpy(v) for k, v in grads.items()},
                                     pst, pcfg)
        for k in params:
            _close(pp[k], rp[k], 1e-6)
            _close(pst["m"][k], rst["m"][k], 1e-6)
            _close(pst["v"][k], rst["v"][k], 1e-6)
        np.testing.assert_allclose(float(pmet["grad_norm"]), float(rmet["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(pmet["lr"]), float(rmet["lr"]), rtol=1e-6)


def test_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    s = [float(schedule(cfg, i)) for i in [0, 5, 10, 50, 100]]
    assert s[0] == 0.0 and abs(s[1] - 0.5) < 1e-6 and abs(s[2] - 1.0) < 1e-6
    assert s[3] < 1.0 and abs(s[4] - 0.1) < 1e-3
    rcfg = RefOptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for i in (0, 3, 10, 11, 57, 100, 140):
        np.testing.assert_allclose(float(schedule(cfg, torch.tensor(i))),
                                   float(ref_schedule(rcfg, jnp.asarray(i))), rtol=1e-6)


def test_clip_norm():
    cfg = OptConfig(clip_norm=1.0, warmup_steps=0, total_steps=1, min_lr_ratio=1.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = adamw_update(p, g, init_opt_state(p, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(global_norm({"a": torch.ones(3), "b": torch.ones(1)})) == pytest.approx(2.0)


def test_moment_dtype_bf16():
    cfg = OptConfig(moment_dtype="bfloat16", warmup_steps=0, total_steps=1)
    p = {"w": torch.ones(3)}
    _, st, _ = adamw_update(p, {"w": torch.ones(3)}, init_opt_state(p, cfg), cfg)
    assert st["m"]["w"].dtype == torch.bfloat16 and st["v"]["w"].dtype == torch.bfloat16


def test_sparse_pattern_random_is_the_reference_draw():
    key = jax.random.PRNGKey(3)
    ref = RefSparsePattern.random(key, 40, 24, 0.1, 16)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    got = SparsePattern.random(seed, 40, 24, 0.1, 16, device="cpu")
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert got.shape == (40, 24) and got.rows.dtype == torch.int32
    pats = sparse_patterns(CFG.scaled(num_layers=2), device="cpu")
    assert [len(v) for v in pats.values()] == [2, 2, 2]
    assert pats["down"][0].shape == (CFG.d_model, CFG.d_ff)
    if not torch.cuda.is_available():        # device=None is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            SparsePattern.random(seed, 4, 4, 0.5, 4)


def test_sparse_ffn_matches_reference_ffn_apply():
    """The carried layer's output and the grads of a loss of it."""
    patterns, params, ffn = _ref_layer()
    b = _batch()
    want, _ = ref_ffn_apply({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(b["x"]), REF_CFG, patterns)
    got = ffn(torch.from_numpy(b["x"]))
    assert got.shape == TOKENS + (CFG.d_model,)
    _close(got, want, 1e-5)
    rl, rg = jax.value_and_grad(lambda p: _ref_loss(patterns)(p, b)[0])(
        {k: jnp.asarray(v) for k, v in params.items()})
    loss = _port_loss(ffn)(ffn.params(), _torch_batch(b))[0]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    for name, p in ffn.named_parameters():
        _close(p.grad, rg[name], 1e-5)
    assert {n for n, _ in ffn.named_buffers()} == {
        f"{k}_{s}" for k in ("gate", "up", "down") for s in ("rows", "cols")}


def test_sparse_ffn_trajectory_matches_reference():
    """Three AdamW steps of the carried layer, MSE to a seeded target."""
    patterns, params, ffn = _ref_layer()
    b = _batch()
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    rstep = ref_make_train_step(_ref_loss(patterns), RefTrainConfig(opt=RefOptConfig(**opt)))
    rstate = ref_init_state({k: jnp.asarray(v) for k, v in params.items()},
                            RefTrainConfig(opt=RefOptConfig(**opt)))
    tcfg = TrainConfig(opt=OptConfig(**opt))
    pstep = make_train_step(_port_loss(ffn), tcfg)
    pstate = init_state(ffn.params(), tcfg)
    builds = PATTERN_PREP["builds"]
    rb, pb = {k: jnp.asarray(v) for k, v in b.items()}, _torch_batch(b)
    losses = []
    for _ in range(3):
        rstate, rm = rstep(rstate, rb)
        pstate, pm = pstep(pstate, pb)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-5)
        losses.append(float(pm["loss"]))
    assert losses[2] < losses[0]
    for k in params:
        _close(pstate["params"][k], rstate["params"][k], 1e-5)
    # the three patterns' transposed slabs, each built once over the steps
    assert PATTERN_PREP["builds"] - builds == 3


def test_microbatch_equals_full_batch():
    """Gradient accumulation over 4 microbatches ≈ one full-batch step."""
    _, _, ffn = _ref_layer()
    b = _torch_batch(_batch())
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10, min_lr_ratio=1.0)
    s1, m1 = make_train_step(_port_loss(ffn), TrainConfig(opt=opt))(
        init_state(ffn.params(), TrainConfig(opt=opt)), b)
    s4, m4 = make_train_step(_port_loss(ffn), TrainConfig(opt=opt, microbatches=4))(
        init_state(ffn.params(), TrainConfig(opt=opt)), b)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-5
    d = max(float((s1["params"][k] - s4["params"][k]).abs().max()) for k in s1["params"])
    assert d < 5e-3


def test_sparse_backend_scope_and_unported_guardrail():
    """``sparse_backend`` pins the kernels' backend for the step; both CPU
    routes give the same step.  ``skip_nonfinite`` (ported since; its own
    tests are in ``test_torch_guardrails.py``) leaves a finite step as it
    is."""
    _, _, ffn = _ref_layer()
    b = _torch_batch(_batch())
    out = []
    for backend in ("torch", "hopper"):
        tcfg = TrainConfig(opt=OptConfig(warmup_steps=0), sparse_backend=backend)
        st, m = make_train_step(_port_loss(ffn), tcfg)(init_state(ffn.params(), tcfg), b)
        out.append((float(m["loss"]), st["params"]["v_up"]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    _close(out[0][1], out[1][1].numpy(), 1e-5)
    # skip_nonfinite is ported (tests/test_torch_guardrails.py): a finite
    # step is the step without it, bit for bit
    tcfg = TrainConfig(opt=OptConfig(warmup_steps=0), skip_nonfinite=True)
    st, m = make_train_step(_port_loss(ffn), tcfg)(
        init_state(ffn.params(), tcfg), b)
    assert int(m["skipped_nonfinite"]) == 0
    assert torch.equal(st["params"]["v_up"], out[0][1])


def test_sparse_ffn_module_defaults():
    """A SparseFFN drawn from its own seed: the reference's value-stream
    shapes (``mlp_specs``), zero ``ln``, and patterns over the buffers,
    whose prep is rebuilt only when the buffers move."""
    ffn = SparseFFN(CFG, device="cpu")
    tiles = lambda m, k: -(-max(int(m * k * 0.1), 1) // 16)  # noqa: E731
    assert ffn.v_gate.shape == (tiles(CFG.d_ff, CFG.d_model), 16)
    assert ffn.v_down.shape == (tiles(CFG.d_model, CFG.d_ff), 16)
    assert float(ffn.ln.abs().max()) == 0.0
    first = ffn.patterns["up"]
    assert first.rows is ffn.up_rows and first.cols is ffn.up_cols
    prep = pattern_prep(first.rows, first.cols, first.shape)
    ffn.to(torch.float64)
    up = ffn.patterns["up"]
    assert up.rows is first.rows and ffn.v_up.dtype == torch.float64
    assert pattern_prep(up.rows, up.cols, up.shape) is prep


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_pattern_entry_routes_its_kernel_by_n(monkeypatch, backend):
    """A ``pattern_matmul`` call that names no ``impl`` takes ``nb_pr`` up
    to the selector's default ``n_threshold`` (4) and ``nb_sr`` above it,
    forward and backward alike (K1's pr design at N = 2,048 ran 2.8× its
    sr design); a named ``impl`` still forces its kernel.  The result is
    the dense product whichever runs."""
    from repro_torch.core import registry
    from repro_torch.core.plan import _pattern_impl, execute_pattern
    from repro_torch.core.selector import SelectorThresholds
    assert [_pattern_impl(n) for n in (1, 4, 5, 2048)] == \
        ["nb_pr", "nb_pr", "nb_sr", "nb_sr"]
    assert SelectorThresholds.n_threshold == 4
    resolved = []
    real = registry.resolve

    def spy(logical, be):
        resolved.append(logical)
        return real(logical, be)
    monkeypatch.setattr(registry, "resolve", spy)
    rng = np.random.default_rng(3)
    pat = SparsePattern.random(1, 30, 20, 0.3, 16, device="cpu")
    vals = torch.from_numpy(rng.standard_normal(pat.rows.shape).astype(np.float32))
    for n, impl, want in ((4, None, "nb_pr"), (5, None, "nb_sr"),
                          (64, None, "nb_sr"), (64, "nb_pr", "nb_pr")):
        x = torch.from_numpy(rng.standard_normal((20, n)).astype(np.float32))
        resolved.clear()
        v = vals.clone().requires_grad_()
        y = execute_pattern(pat.rows, pat.cols, v, pat.shape, x.requires_grad_(),
                            impl=impl, backend=backend)
        y.sum().backward()
        assert [r for r in resolved if r.startswith("nb")] == [want], (n, impl)
        np.testing.assert_allclose(y.detach().numpy(), (pat.to_dense(vals) @ x).detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


def _ffn_grads(ffn: SparseFFN, x: torch.Tensor, backend: str):
    """The grads of ``sum(ffn(x)²)`` in ``x`` and every parameter, on the
    named backend's route of ``execute_pattern``."""
    from repro_torch.api import use_backend
    xx = x.clone().requires_grad_()
    with use_backend(backend):
        loss = (ffn(xx) ** 2).sum()
    return torch.autograd.grad(loss, [xx, *ffn.parameters()])


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_load_state_dict_rebuilds_the_pattern_prep(backend):
    """Fault 3.5: ``load_state_dict`` writes a ``SparseFFN``'s pattern
    buffers in place, which keeps their identity; the memo of
    ``pattern_prep`` also keys on the tensors' version counters, so the
    backward after the load runs on the loaded pattern's Aᵀ.  Its grads
    equal the loaded module's exactly."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (*TOKENS, CFG.d_model)).astype(np.float32))
    a = SparseFFN(CFG, seed=0, device="cpu")
    b = SparseFFN(CFG, seed=1, device="cpu")
    assert not torch.equal(a.up_rows, b.up_rows)
    _ffn_grads(a, x, backend)                   # a's prep built
    builds = PATTERN_PREP["builds"]
    a.load_state_dict(b.state_dict())
    got = _ffn_grads(a, x, backend)
    assert PATTERN_PREP["builds"] == builds + 3  # one a matrix, rebuilt
    for g, want in zip(got, _ffn_grads(b, x, backend)):
        assert torch.equal(g, want)


def test_pattern_prep_follows_an_in_place_copy():
    """Fault 3.5 on a bare pattern: ``rows.copy_(other)`` bumps the
    version, and the next backward of ``pattern_matmul`` equals the one on
    a fresh copy of the other pattern."""
    from repro_torch.core.plan import execute_pattern
    one = SparsePattern.random(1, 30, 20, 0.3, 16, device="cpu")
    two = SparsePattern.random(2, 30, 20, 0.3, 16, device="cpu")
    assert one.rows.shape == two.rows.shape
    rng = np.random.default_rng(6)
    vals = torch.from_numpy(rng.standard_normal(one.rows.shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))

    def grads(rows, cols):
        v, xx = vals.clone().requires_grad_(), x.clone().requires_grad_()
        y = execute_pattern(rows, cols, v, one.shape, xx, backend="torch")
        return torch.autograd.grad((y ** 2).sum(), [v, xx])

    rows, cols = one.rows.clone(), one.cols.clone()
    before = pattern_prep(rows, cols, one.shape)
    grads(rows, cols)
    rows.copy_(two.rows)
    cols.copy_(two.cols)
    assert pattern_prep(rows, cols, one.shape) is not before
    for g, want in zip(grads(rows, cols),
                       grads(two.rows.clone(), two.cols.clone())):
        assert torch.equal(g, want)
