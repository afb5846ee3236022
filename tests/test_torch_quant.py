"""Quantized value streams in the port (``repro_torch.core.quant``, the
``quant=`` plans, ``pattern_matmul(quant=)`` and ``train/compress.py``)
against the reference (``tests/test_quant.py``'s cases) on the same numpy
inputs.

Codes, scales and the dynamic-range verdicts are bit-equal to
``repro.core.quant``'s.  Outputs and gradients are held to float32
relative 1e-5 of the largest magnitude (the sums are reassociated); the
unquantized plan is held to the analytic bound ``0.5 · step · max_scale ·
Σ|x[:, j]|`` (each nonzero errs by at most half the coarsest grid step of
its codes, 1 for int8 and 32 for e4m3, times its tile's scale).  On the
CPU the ``"hopper"`` entries run the kernels' plain versions, which decode
the codes and run the float math; ``tests/test_torch_gpu.py`` holds the
coded kernels against them on the card.  The reference's sharded part is
not ported yet; ``modeled_traffic(quant=)`` is held in
``tests/test_torch_tune.py``."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as ref_api
from repro.core import csr_from_dense as ref_csr_from_dense
from repro.core import execute as ref_execute
from repro.core import execute_pattern as ref_execute_pattern
from repro.core import plan as ref_plan
from repro.core import quant as ref_quant
from repro.core.formats import csr_to_balanced as ref_csr_to_balanced
from repro.core.rmat import rmat as ref_rmat
from repro.kernels import spmv as ref_spmv
from repro.kernels import vsr as ref_vsr
from repro.train import compress as ref_compress
import repro_torch
from repro_torch import interop
from repro_torch.core import formats, quant
from repro_torch.core.cache import PlanCache
from repro_torch.core.plan import execute, execute_pattern, plan
from repro_torch.core.selector import SelectorThresholds
from repro_torch.kernels import spmv, vsr
from repro_torch.train import compress

from conftest import random_csr

MODES = ("int8", "fp8")
BACKENDS = ("torch", "hopper")


def _port(csr, data=None):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data if data is None else data),
                                   csr.shape)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol=1e-5):
    got, want = _np(got).astype(np.float32), np.asarray(want, np.float32)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _codes_equal(got: torch.Tensor, want) -> None:
    """Bit-equal codes: the bytes of the port's and the reference's."""
    w = np.asarray(want)
    assert got.element_size() == w.dtype.itemsize
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  w.view(np.uint8))


def _cases():
    """``tests/test_quant.py``'s sweep: a skewed R-MAT, an empty-row band,
    a single row."""
    rng = np.random.default_rng(0)
    cases = [("skewed_rmat", ref_rmat(6, 8, seed=3))]
    a = np.zeros((48, 40), np.float32)
    a[1, :7] = rng.standard_normal(7)
    a[30, 5] = 2.5
    a[45:, :] = (rng.random((3, 40)) < 0.3) * rng.standard_normal((3, 40))
    cases.append(("empty_rows", ref_csr_from_dense(a)))
    b = ((rng.random((1, 40)) < 0.5)
         * rng.standard_normal((1, 40))).astype(np.float32)
    cases.append(("single_row", ref_csr_from_dense(b)))
    return cases


CASES = _cases()


def _dequant_dense(p) -> np.ndarray:
    """The dense matrix a port plan's coded stream represents."""
    sub = p.substrate("balanced")
    v = quant.dequantize_stream(sub.vals, p.quant_scales()).reshape(-1).numpy()
    r, c = sub.rows.reshape(-1).numpy(), sub.cols.reshape(-1).numpy()
    keep = r < p.csr.shape[0]
    dense = np.zeros(p.csr.shape, np.float32)
    np.add.at(dense, (r[keep], c[keep]), v[keep])
    return dense


#: the coarsest grid step of a mode's codes (int8: 1; e4m3: 32, between 256
#: and 448), in units of the tile's scale
GRID_STEP = {"int8": 1.0, "fp8": 32.0}


def _loose_bound(p, x) -> float:
    """Half the coarsest grid step a nonzero, times the largest scale and
    the largest column sum of |x|."""
    x2 = x if x.ndim == 2 else x[:, None]
    return (float(0.5 * GRID_STEP[p.quant] * p.quant_scales().max()
                  * np.abs(x2).sum(axis=0).max()) + 1e-6)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_codes_and_scales_bit_equal_to_reference(mode):
    """64 tiles of 512 values over 6 decades, an all-zero tile and a half-
    zero tile: codes and scales bit-equal, decoded values equal, and the
    round trip within half a tile's scale."""
    rng = np.random.default_rng(1)
    v = (rng.standard_normal((64, 512))
         * np.exp(3 * rng.standard_normal((64, 1)))).astype(np.float32)
    v[3] = 0.0
    v[5, ::2] = 0.0
    q, sc = quant.quantize_stream(torch.from_numpy(v), mode)
    rq, rsc = ref_quant.quantize_stream(jnp.asarray(v), mode)
    assert q.dtype == quant.quant_dtype(mode) and sc.dtype == torch.float32
    _codes_equal(q, rq)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(rsc))
    assert sc[3] == 1.0 and (q[3].float() == 0).all()
    back = quant.dequantize_stream(q, sc)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(ref_quant.dequantize_stream(rq, rsc)))
    if mode == "int8":
        assert (back - torch.from_numpy(v)).abs().max() <= 0.5 * sc.max() + 1e-7


def test_int8_encode_bit_equal_and_compress_reexports():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(257).astype(np.float32)
    q, s = quant.int8_encode(torch.from_numpy(x))
    rq, rs = ref_quant.int8_encode(jnp.asarray(x))
    _codes_equal(q, rq)
    assert float(s) == float(rs)
    z, zs = quant.int8_encode(torch.zeros(5))
    assert float(zs) == 1.0 and (z == 0).all()
    assert compress.int8_encode is quant.int8_encode
    assert compress.int8_decode is quant.int8_decode
    np.testing.assert_allclose(compress.int8_decode(q, s).numpy(), x,
                               atol=float(np.abs(x).max()) / 127 + 1e-7)


def test_check_tile_range_verdicts_match_reference():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((8, 64)).astype(np.float32)
    cases = {"ok": base, "zeros": np.zeros((4, 16), np.float32),
             "empty": np.zeros((0, 16), np.float32)}
    blown = base.copy()
    blown[2, 0] = 1e30
    cases["blown"] = blown
    for name, v in cases.items():
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            got = quant.check_tile_range(torch.from_numpy(v))
        assert got == quant.check_tile_range(v), name
        with warnings.catch_warnings(record=True) as ref_w:
            warnings.simplefilter("always")
            want = ref_quant.check_tile_range(v)
        assert got == want, name
        assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w]
    assert quant.check_tile_range(blown, bound=1e40)


def test_modes_and_dtypes():
    assert quant.QUANT_MODES == ref_quant.QUANT_MODES
    assert quant.QMAX == ref_quant.QMAX
    assert quant.MAX_DYNAMIC_RANGE == ref_quant.MAX_DYNAMIC_RANGE
    assert quant.supports("int8") and quant.supports("fp8")
    assert not quant.supports("int4")
    assert quant.FP8_DTYPE is torch.float8_e4m3fn
    assert quant.is_quantized_dtype(torch.int8)
    assert quant.is_quantized_dtype(torch.float8_e4m3fn)
    assert not quant.is_quantized_dtype(torch.bfloat16)
    assert [quant.value_bytes(t) for t in (torch.float32, torch.bfloat16,
                                           torch.int8, torch.float8_e4m3fn)] \
        == [4, 2, 1, 1]
    with pytest.raises(ValueError, match="quant"):
        quant.quant_dtype("int4")


# ---------------------------------------------------------------------------
# training-side compression
# ---------------------------------------------------------------------------

def test_ef_accumulate_five_rounds_bit_equal():
    """Five rounds of error feedback from the same gradients: codes, scales
    and residuals bit-equal to ``repro.train.compress``."""
    rng = np.random.default_rng(4)
    res = torch.zeros(300)
    rres = jnp.zeros(300, jnp.float32)
    for _ in range(5):
        g = (rng.standard_normal(300) * 1e-2).astype(np.float32)
        q, s, res = compress.ef_accumulate(torch.from_numpy(g), res)
        rq, rs, rres = ref_compress.ef_accumulate(jnp.asarray(g), rres)
        _codes_equal(q, rq)
        assert float(s) == float(rs)
        np.testing.assert_array_equal(res.numpy(), np.asarray(rres))


def test_tree_int8_encode_decode():
    """Over a dict of a tensor and a list of tensors, bit-equal to the
    reference's pytree version; a tuple keeps its type (the reference's
    version takes no tuples: it reads them as its (code, scale) pairs)."""
    rng = np.random.default_rng(5)
    w, l0, l1 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((4, 6), 3, 2))
    qs, scales = compress.tree_int8_encode(
        {"w": torch.from_numpy(w), "layers": [torch.from_numpy(l0),
                                              torch.from_numpy(l1)]})
    rqs, rscales = ref_compress.tree_int8_encode(
        {"w": jnp.asarray(w), "layers": [jnp.asarray(l0), jnp.asarray(l1)]})
    assert isinstance(qs["layers"], list)
    for got, want in ((qs["w"], rqs["w"]), (qs["layers"][1], rqs["layers"][1])):
        _codes_equal(got, want)
    assert float(scales["layers"][0]) == float(rscales["layers"][0])
    back = compress.tree_int8_decode(qs, scales)
    rback = ref_compress.tree_int8_decode(rqs, rscales)
    for got, want in ((back["w"], rback["w"]),
                      (back["layers"][0], rback["layers"][0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tq, ts = compress.tree_int8_encode((torch.from_numpy(l0),))
    assert isinstance(tq, tuple) and isinstance(ts, tuple)
    assert torch.equal(compress.tree_int8_decode(tq, ts)[0],
                       back["layers"][0])


# ---------------------------------------------------------------------------
# quantized plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("impl", ["nb_pr", "nb_sr"])
@pytest.mark.parametrize("n", [1, 128])
def test_quant_plan_matches_reference(backend, mode, impl, n):
    """``plan(quant=)`` on the three cases: the substrate's codes and
    scales bit-equal to the reference's, the output within 1e-5 of the
    reference's ``"xla"`` plan with the same mode, equal to the decoded
    dense product, and within the loose bound of the float plan."""
    rng = np.random.default_rng(n)
    for name, csr in CASES:
        p = plan(_port(csr), backend=backend, quant=mode)
        rp = ref_plan(csr, backend="xla", quant=mode)
        assert p.quant == mode and rp.quant == mode, name
        _codes_equal(p.substrate("balanced").vals, rp.substrate("balanced").vals)
        np.testing.assert_array_equal(p.quant_scales().numpy(),
                                      np.asarray(rp.quant_scales()))
        x = rng.standard_normal((csr.shape[1], n)).astype(np.float32)
        xx = x[:, 0] if n == 1 else x
        got = execute(p, torch.from_numpy(xx), impl=impl)
        _close(got, ref_execute(rp, jnp.asarray(xx), impl=impl))
        _close(got, _dequant_dense(p) @ xx)
        base = execute(plan(_port(csr), backend=backend), torch.from_numpy(xx),
                       impl=impl)
        assert float((got - base).abs().max()) <= _loose_bound(p, x), name


@pytest.mark.parametrize("mode", MODES)
def test_spill_kernels_plain_with_scales_match_pallas(mode):
    """The plain K4 / K5 (and their combine) with scales against the
    reference's spill kernels ``spmm_vsr`` / ``spmv_vsr(scales=)`` in
    interpret mode, on a tile of 64."""
    rng = np.random.default_rng(6)
    for name, csr in CASES:
        rp = ref_plan(csr, backend="xla", tile=64, quant=mode)
        p = plan(_port(csr), backend="hopper", tile=64, quant=mode)
        rsub, rsc = rp.substrate("balanced"), rp.quant_scales()
        sub, sc = p.substrate("balanced"), p.quant_scales()
        for n in (1, 5):
            x = rng.standard_normal((csr.shape[1], n)).astype(np.float32)
            if n == 1:
                want = ref_spmv.spmv_vsr(rsub, jnp.asarray(x[:, 0]), scales=rsc,
                                         interpret=True)
                got = spmv.spmv_vsr(sub, torch.from_numpy(x[:, 0]), scales=sc)
            else:
                want = ref_vsr.spmm_vsr(rsub, jnp.asarray(x), scales=rsc,
                                        interpret=True)
                got = vsr.spmm_vsr(sub, torch.from_numpy(x), scales=sc)
            _close(got, want)
    with pytest.raises(ValueError, match="scales"):
        vsr.spmm_vsr_plain(sub, torch.zeros(csr.shape[1], 2))


def test_quant_pins_nb_family():
    """A uniform matrix the selector routes to ``rs_*`` executes the NB
    kernels on a quantized plan, keeping the SR/PR choice; the result is
    the decoded product, not the exact one."""
    rng = np.random.default_rng(7)
    csr, a = random_csr(rng, 64, 64, 0.2)
    p = plan(_port(csr), backend="torch", quant="int8")
    pf = plan(_port(csr), backend="torch")
    picks = [pf.select(n) for n in (1, 16, 128)]
    assert any(k.startswith("rs_") for k in picks)
    for n, pick in zip((1, 16, 128), picks):
        assert p.select(n).startswith("nb_") and p.select(n)[-2:] == pick[-2:]
    x = rng.standard_normal((64, 16)).astype(np.float32)
    got = execute(p, torch.from_numpy(x))
    assert float(np.abs(got.numpy() - a @ x).max()) > 0
    _close(got, _dequant_dense(p) @ x)
    assert "ell" not in p.built_substrates


@pytest.mark.parametrize("backend", BACKENDS)
def test_quant_bf16_x(backend):
    """A bfloat16 X through the quantized plan: decoded in f32, summed in
    f32, the result in bfloat16 and close to the reference's."""
    rng = np.random.default_rng(8)
    csr, _ = random_csr(rng, 64, 64, 0.2)
    p = plan(_port(csr), backend=backend, quant="int8")
    x = rng.standard_normal((64, 8)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    got = execute(p, xb, impl="nb_pr")
    assert got.dtype == torch.bfloat16
    want = ref_execute(ref_plan(csr, backend="xla", quant="int8"),
                       jnp.asarray(x).astype(jnp.bfloat16), impl="nb_pr")
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2 * float(np.abs(np.asarray(
                                   want, np.float32)).max()))
    _close(got.float(), _dequant_dense(p) @ xb.float().numpy(), rtol=1e-2)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dynamic_range_fallback_is_exact(backend):
    """A tile mixing 1e30 with O(1) values: the plan warns (the reference's
    text), drops to the float stream, and equals the float plan exactly."""
    rng = np.random.default_rng(9)
    a = ((rng.random((32, 32)) < 0.3) * rng.standard_normal((32, 32))
         ).astype(np.float32)
    a[0, 0] = 1e30
    csr = formats.csr_from_dense(a)
    p = plan(csr, backend=backend, quant="int8")
    with pytest.warns(UserWarning, match="dynamic range"):
        p.substrate("balanced")
    assert p.quant is None and p.quant_scales() is None
    assert p.substrate("balanced").vals.dtype == torch.float32
    x = torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float32))
    for impl in ("nb_pr", "nb_sr"):
        assert torch.equal(execute(p, x, impl=impl),
                           execute(plan(csr, backend=backend), x, impl=impl))


def test_quant_min_n_gate_and_unknown_mode():
    rng = np.random.default_rng(10)
    csr, _ = random_csr(rng, 32, 32, 0.3)
    th = dataclasses.replace(SelectorThresholds(), quant_min_n=64)
    low = repro_torch.sparse(_port(csr), device="cpu", quant="int8", n_hint=8,
                             thresholds=th, cache=False)
    assert low.plan.quant is None
    high = repro_torch.sparse(_port(csr), device="cpu", quant="int8",
                              n_hint=128, thresholds=th, cache=False)
    assert high.plan.quant == "int8"
    assert "balanced" in high.plan.built_substrates     # n_hint prebuilds
    assert plan(_port(csr), quant="int8", n_hint=8, thresholds=th).quant is None
    for bad in ("int4", "bf16"):
        with pytest.raises(ValueError, match="quant"):
            plan(_port(csr), quant=bad)
        with pytest.raises(ValueError, match="quant"):
            repro_torch.sparse(_port(csr), device="cpu", quant=bad, cache=False)
    ref_low = ref_api.sparse(csr, quant="int8", n_hint=8, cache=False,
                             thresholds=dataclasses.replace(
                                 ref_api.SelectorThresholds(), quant_min_n=64))
    assert ref_low.plan.quant is None


def test_plan_cache_quant_segmentation():
    rng = np.random.default_rng(11)
    csr, _ = random_csr(rng, 32, 32, 0.3)
    cache = PlanCache(capacity=8)
    A = repro_torch.sparse(_port(csr), device="cpu", cache=cache)
    Q = repro_torch.sparse(_port(csr), device="cpu", quant="int8", cache=cache)
    Q2 = repro_torch.sparse(_port(csr), device="cpu", quant="int8", cache=cache)
    s = cache.stats()
    assert s["size"] == 2 and s["builds"] == 2 and s["hits"] == 1
    assert Q2.plan is Q.plan and Q.plan is not A.plan
    assert A.plan.quant is None and Q.plan.quant == "int8"
    v = torch.from_numpy(np.asarray(csr.data)) * 2
    assert Q.with_values(v).plan.quant == "int8"


def test_no_f32_copy_of_a_baked_stream(monkeypatch):
    """The baked substrate stays coded end to end: int8 codes and f32 scales
    reach the K1 / K2 wrappers (on the card the kernels decode them in
    registers), and the plan holds no f32 slab."""
    rng = np.random.default_rng(12)
    csr, _ = random_csr(rng, 64, 64, 0.2)
    A = repro_torch.sparse(_port(csr), device="cpu", backend="hopper",
                           quant="int8", cache=False)
    sub = A.plan.substrate("balanced")
    assert sub.vals.dtype == torch.int8
    assert A.plan.quant_scales().dtype == torch.float32
    assert A.plan.built_substrates == ("balanced",)
    seen = []
    for mod, name in ((vsr, "spmm_vsr_fused"), (spmv, "spmv_vsr_fused")):
        real = getattr(mod, name)

        def spy(bal, x, *args, _real=real, **kw):
            seen.append((bal.vals.dtype, kw.get("scales")))
            return _real(bal, x, *args, **kw)
        monkeypatch.setattr(mod, name, spy)
    A @ torch.randn(64)
    A @ torch.randn(64, 8)
    A.with_values(A.values * 3) @ torch.randn(64, 8)
    assert [d for d, _ in seen] == [torch.int8] * 3
    assert seen[0][1] is A.plan.quant_scales()
    assert seen[2][1] is not A.plan.quant_scales()      # fresh live scales


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_baked_dx_uses_decoded_values(backend, mode):
    """dX through a baked coded plan is Aᵀ·G of the decoded values (not the
    codes, not the float CSR data), as the reference's."""
    rng = np.random.default_rng(13)
    csr, _ = random_csr(rng, 48, 40, 0.3)
    p = plan(_port(csr), backend=backend, quant=mode)
    x = torch.from_numpy(rng.standard_normal((40, 8)).astype(np.float32))
    g = rng.standard_normal((48, 8)).astype(np.float32)
    for impl in ("nb_pr", "nb_sr"):
        xg = x.clone().requires_grad_()
        (execute(p, xg, impl=impl) * torch.from_numpy(g)).sum().backward()
        _close(xg.grad, _dequant_dense(p).T @ g)
        rp = ref_plan(csr, backend="xla", quant=mode)
        want = jax.grad(lambda xx: (ref_execute(rp, xx, impl=impl) * g).sum())(
            jnp.asarray(x.numpy()))
        _close(xg.grad, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_live_stream_grads_match_reference(backend, mode):
    """``with_values(v)`` on a quantized plan: the stream is quantized in
    the forward, the gradients pass straight through; both within 1e-5 of
    ``jax.grad`` of the reference."""
    rng = np.random.default_rng(14)
    csr, _ = random_csr(rng, 48, 40, 0.3)
    A = repro_torch.sparse(_port(csr), device="cpu", backend=backend,
                           quant=mode, cache=False)
    rA = ref_api.sparse(csr, quant=mode, cache=False)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    v0 = (np.asarray(csr.data) * 1.7).astype(np.float32)
    v = torch.from_numpy(v0).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y = A.with_values(v) @ xt
    (y ** 2).sum().backward()
    gv, gx = jax.grad(lambda vv, xx: ((rA.with_values(vv) @ xx) ** 2).sum(),
                      argnums=(0, 1))(jnp.asarray(v0), jnp.asarray(x))
    _close(y, rA.with_values(jnp.asarray(v0)) @ jnp.asarray(x))
    _close(v.grad, gv)
    _close(xt.grad, gx)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [4, 16])
def test_pattern_matmul_quant_matches_reference(backend, mode, n):
    """``pattern_matmul(..., quant=)``: the live values quantized per tile
    (the coded wrappers reached), output and straight-through grads within
    1e-5 of the reference's ``"xla"`` ``execute_pattern(quant=)``."""
    rng = np.random.default_rng(15 + n)
    csr, dense = random_csr(rng, 48, 40, 0.2)
    rbal = ref_csr_to_balanced(csr, tile=64)
    bal = formats.csr_to_balanced(_port(csr), tile=64)
    vals = np.asarray(rbal.vals)
    x = rng.standard_normal((40, n)).astype(np.float32)
    tv = torch.from_numpy(vals.copy()).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y = execute_pattern(bal.rows, bal.cols, tv, (48, 40), tx, quant=mode,
                        backend=backend)
    (y ** 2).sum().backward()
    f = lambda vv, xx: ref_execute_pattern(  # noqa: E731
        rbal.rows, rbal.cols, vv, (48, 40), xx, impl=y_impl(n), backend="xla",
        quant=mode)
    _close(y, f(jnp.asarray(vals), jnp.asarray(x)))
    gv, gx = jax.grad(lambda vv, xx: (f(vv, xx) ** 2).sum(), argnums=(0, 1))(
        jnp.asarray(vals), jnp.asarray(x))
    _close(tv.grad, gv)
    _close(tx.grad, gx)
    yf = execute_pattern(bal.rows, bal.cols, torch.from_numpy(vals), (48, 40),
                         torch.from_numpy(x), backend=backend)
    ref = dense @ x
    err_q = float(np.abs(_np(y) - ref).max())
    assert err_q > float(np.abs(_np(yf) - ref).max())      # the coded path ran
    assert err_q / float(np.abs(ref).max()) < 0.05
    with pytest.raises(ValueError, match="quant"):
        execute_pattern(bal.rows, bal.cols, tv, (48, 40), tx, quant="int4")


def y_impl(n: int) -> str:
    """The reference's impl for the port's pattern call that names none."""
    return "nb_pr" if n <= SelectorThresholds.n_threshold else "nb_sr"


def test_pattern_matmul_quant_pins_rs_to_nb():
    rng = np.random.default_rng(16)
    csr, _ = random_csr(rng, 32, 32, 0.3)
    bal = formats.csr_to_balanced(_port(csr), tile=64)
    x = torch.randn(32, 8)
    y = execute_pattern(bal.rows, bal.cols, bal.vals, (32, 32), x,
                        impl="rs_pr", quant="int8", backend="torch")
    want = execute_pattern(bal.rows, bal.cols, bal.vals, (32, 32), x,
                           impl="nb_pr", quant="int8", backend="torch")
    assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# chains on a quantized plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_chain_on_quantized_plan_equals_float_chain(backend):
    """A chain reads the pattern, never the coded slab: the SDDMM and the
    softmax chain on a quantized plan equal those on the float plan, and so
    do their gradients (the backward's SpMMs run unquantized)."""
    rng = np.random.default_rng(17)
    csr, _ = random_csr(rng, 40, 40, 0.25)
    outs = []
    for q in (None, "int8"):
        A = repro_torch.sparse(_port(csr), device="cpu", backend=backend,
                               quant=q, cache=False)
        torch.manual_seed(0)
        a, b, x = (torch.randn(40, 8, requires_grad=True) for _ in range(3))
        y = A.chain(a, b, x, transform="softmax", alpha=0.3)
        e = A.sddmm(a.detach(), b.detach())
        (y * torch.linspace(-1, 1, 8)).sum().backward()
        outs.append((y.detach(), e, a.grad, b.grad, x.grad))
        assert A.plan.quant == q
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)
