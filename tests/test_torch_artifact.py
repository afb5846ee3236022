"""The frozen ``PlanArtifact`` of the port against its builder and against
the reference's artifact (mirrors ``tests/test_artifact.py``): the pytree
round-trip (``torch.utils._pytree``), equal metas for equal topology and
unequal ones for another pattern, forward and grads bit-equal to the
builder's on the ``"torch"``, ``"hopper"`` (plain versions on the CPU) and
``"bsr"`` backends, the missing-substrate and frozen-backend errors, full
coverage, the ``SparsePlan`` alias and the ``vals`` guard, an execute that
does no host work, the quant pin the reference's execute skips, parity with
``repro``'s artifact on the same numpy CSR (float32: forward within 1e-5,
grads within 1e-4 of the largest magnitude), and ``topology_key``
string-equal to the reference's.

The reference's donation test (``donate_argnums``) and its sharded
artifacts have no counterpart here: PyTorch has no buffer donation, and the
sharded backend is not ported.  Its ``jax.jit`` / ``scan`` transit becomes
CUDA-graph capture, which needs the card (``tests/test_torch_gpu.py``)."""
import warnings

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import jax
import jax.numpy as jnp

from repro.core.plan import execute as ref_execute
from repro.core.plan import plan as ref_plan
from repro.core.rmat import rmat as ref_rmat
from repro.core.rmat import rmat_suite_small as ref_suite
from repro.core.selector import TileGeometry as RefTileGeometry
from repro_torch import api, interop
from repro_torch.core import formats, plan as plan_mod
from repro_torch.core.plan import (PATTERN_PREP, PlanArtifact, PlanBuilder,
                                   SparsePlan, execute, plan)
from repro_torch.core.selector import SelectorThresholds, TileGeometry

SUITE = {k: v for k, v in ref_suite(seed=0).items() if "_s8_" in k}
BACKENDS = ("torch", "hopper", "bsr")


def _port(csr, data=None):
    return interop.csr_from_arrays(np.asarray(csr.indptr), np.asarray(csr.indices),
                                   np.asarray(csr.data if data is None else data),
                                   csr.shape)


def _dense(csr) -> np.ndarray:
    return np.asarray(csr.to_dense(), np.float64)


def _x(k: int, n: int, seed: int = 0) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    return torch.from_numpy(x[:, 0] if n == 1 else x)


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol)


def _grads(target, csr, x, impl=None):
    """``(d vals, d x)`` of ``sum(execute(target, x, vals)²)``."""
    v = csr.data.clone().requires_grad_()
    xx = x.clone().requires_grad_()
    y = execute(target, xx, vals=v, impl=impl)
    return torch.autograd.grad((y ** 2).sum(), [v, xx])


# ---------------------------------------------------------------------------
# the pytree and the meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_artifact_tree_flatten_roundtrip(backend):
    csr = _port(SUITE["rmat_s8_e16_skewed"])
    art = plan(csr, backend=backend).finalize(8)
    leaves, spec = pytree.tree_flatten(art)
    assert leaves and all(isinstance(t, torch.Tensor) for t in leaves)
    art2 = pytree.tree_unflatten(leaves, spec)
    assert isinstance(art2, PlanArtifact) and art2.meta == art.meta
    assert art2.opts is art.opts
    assert all(a is b for a, b in zip(pytree.tree_leaves(art2), leaves))
    x = _x(csr.shape[1], 8)
    assert torch.equal(execute(art2, x), execute(art, x))


@pytest.mark.parametrize("backend", BACKENDS)
def test_equal_topology_artifacts_have_equal_metas(backend):
    ref = SUITE["rmat_s8_e16_uniform"]
    csr, csr2 = _port(ref), _port(ref, np.asarray(ref.data) * 2.0)
    art1 = plan(csr, backend=backend).finalize(8)
    art2 = plan(csr2, backend=backend).finalize(8)
    assert art1.meta == art2.meta and hash(art1.meta) == hash(art2.meta)
    assert pytree.tree_structure(art1) == pytree.tree_structure(art2)
    x = _x(csr.shape[1], 8)
    want = _dense(csr) @ x.double().numpy()
    _close(execute(art1, x), want, 1e-5)
    _close(execute(art2, x), 2 * want, 1e-5)


def test_different_pattern_artifacts_do_not_collide():
    one = plan(_port(SUITE["rmat_s8_e16_uniform"])).finalize(8)
    other = plan(_port(SUITE["rmat_s8_e16_skewed"])).finalize(8)
    assert one.meta.topology != other.meta.topology
    assert one.meta != other.meta


# ---------------------------------------------------------------------------
# artifact against builder, forward and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", [("rmat_s8_e16_uniform", 20),   # rs_sr
                                    ("rmat_s8_e16_skewed", 20),    # nb_sr
                                    ("rmat_s8_e4_skewed", 1),      # nb_pr
                                    ("rmat_s8_e16_uniform", 2)])   # rs_pr
@pytest.mark.parametrize("backend", BACKENDS)
def test_artifact_matches_builder_and_grads(backend, name, n):
    """Forward and both grads bit-equal to the builder's (the same kernel
    on the same substrates), and the forward within 1e-5 of the dense
    product."""
    csr = _port(SUITE[name])
    p = plan(csr, backend=backend, tile=64)
    art = p.finalize(n)
    x = _x(csr.shape[1], n)
    y = execute(art, x)
    assert torch.equal(y, execute(p, x))
    _close(y, _dense(csr) @ x.double().numpy(), 1e-5)
    for got, want in zip(_grads(art, csr, x), _grads(p, csr, x)):
        assert torch.equal(got, want)
    # baked values, x alone requiring grad
    xx = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad((execute(art, xx) ** 2).sum(), [xx])
    assert torch.equal(gx, _grads(p, csr, x)[1])


def test_full_coverage_finalize_serves_all_kernels():
    csr = _port(SUITE["rmat_s8_e16_skewed"])
    p = plan(csr, backend="hopper")
    art = p.finalize()                   # no n / impl: the whole 2x2 space
    assert set(art.substrates) == {"ell", "balanced", "t:ell", "t:balanced"}
    x = _x(csr.shape[1], 8)
    want = _dense(csr) @ x.double().numpy()
    for impl in ("rs_sr", "rs_pr", "nb_sr", "nb_pr"):
        _close(execute(art, x, impl=impl), want, 1e-5)
        for got, ref in zip(_grads(art, csr, x, impl), _grads(p, csr, x, impl)):
            assert torch.equal(got, ref)


def test_impl_without_n_covers_both_sides_of_the_transposed_selector():
    csr = _port(SUITE["rmat_s8_e16_uniform"])
    p = plan(csr)
    art = p.finalize(impl="nb_pr")
    pt = p.transposed()
    want = {plan_mod.registry.resolve(pt.select(n), "torch").substrate
            for n in (1, 64)}
    assert {k[2:] for k in art.substrates if k.startswith("t:")} == want
    for n in (1, 64):
        x = _x(csr.shape[1], n)
        for got, ref in zip(_grads(art, csr, x, "nb_pr"),
                            _grads(p, csr, x, "nb_pr")):
            assert torch.equal(got, ref)


def test_sparse_matrix_finalize_bakes_a_live_stream():
    ref = SUITE["rmat_s8_e16_skewed"]
    A = api.sparse(_port(ref), device="cpu", cache=False)
    art = A.with_values(A.values * 3.0).finalize(8)
    x = _x(A.shape[1], 8)
    _close(execute(art, x), 3 * (_dense(A.plan.csr) @ x.double().numpy()), 1e-5)
    assert A.finalize(8).meta == art.meta
    assert A.topology_key() == art.meta.topology


def test_with_thresholds_resets_the_opts_and_the_transposed_plan():
    p = plan(_port(SUITE["rmat_s8_e16_uniform"]), backend="hopper")
    p.kernel_opts(p.entry("nb_pr"))
    p.transposed()
    assert p.with_thresholds(p.thresholds) is p
    th = SelectorThresholds(n_threshold=64)
    q = p.with_thresholds(th)
    assert q.thresholds == th and q._opts == {} and q._transposed is None
    assert q._substrates is p._substrates
    assert p._opts and p._transposed is not None
    assert q.select(32) == "nb_pr" and p.select(32) == "rs_sr"
    assert api.sparse(p.csr, device="cpu").with_thresholds(th).plan.thresholds == th


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def test_artifact_missing_substrate_is_a_clear_error():
    csr = _port(SUITE["rmat_s8_e16_uniform"])
    art = plan(csr).finalize(impl="nb_pr")       # the balanced substrate only
    with pytest.raises(ValueError, match="finalize"):
        execute(art, _x(csr.shape[1], 64), impl="rs_sr")


def test_artifact_backend_is_frozen():
    csr = _port(SUITE["rmat_s8_e16_uniform"])
    art = plan(csr, backend="torch").finalize(8)
    with pytest.raises(ValueError, match="frozen"):
        execute(art, _x(csr.shape[1], 8), backend="hopper")
    assert execute(art, _x(csr.shape[1], 8), backend="torch").shape == (256, 8)


def test_builder_alias_and_finalize_vals_guard():
    csr = _port(SUITE["rmat_s8_e16_uniform"])
    p = plan(csr)
    assert isinstance(p, PlanBuilder) and SparsePlan is PlanBuilder
    art = p.finalize(8)
    assert isinstance(art, PlanArtifact)
    with pytest.raises(ValueError, match="nonzeros"):
        execute(art, _x(csr.shape[1], 8), vals=torch.ones(csr.nnz + 1))
    assert (art @ _x(csr.shape[1], 8)).shape == (256, 8)


@pytest.mark.parametrize("kind", ["sddmm", "chain", "attn_chain", "bogus"])
def test_finalize_refuses_what_is_not_a_matmul_kernel(kind):
    p = plan(_port(SUITE["rmat_s8_e16_uniform"]))
    with pytest.raises(ValueError, match="matmul kernel" if kind == "bogus"
                       else "cannot be finalized"):
        p.finalize(kernels=(kind,))


@pytest.mark.parametrize("backend", BACKENDS)
def test_execute_on_an_artifact_does_no_host_work(monkeypatch, backend):
    """Forward and backward through an artifact copy nothing to the host,
    build no substrate, map or pattern prep: every builder is patched to
    raise."""
    csr = _port(SUITE["rmat_s8_e16_skewed"])
    p = plan(csr, backend=backend, tile=64)
    arts = {n: p.finalize(n) for n in (1, 8)}

    def refuse(*args, **kwargs):
        raise AssertionError("host work inside execute(artifact)")
    for mod, names in ((formats, ("host", "csr_to_ell", "csr_to_balanced",
                                  "csr_to_bsr", "balanced_pattern",
                                  "balanced_transpose", "csr_transpose")),
                       (plan_mod, ("host", "csr_to_ell", "csr_to_balanced",
                                   "csr_to_bsr", "balanced_pattern",
                                   "balanced_transpose", "csr_transpose",
                                   "bsr_slots", "bsr_block_rows",
                                   "matrix_stats", "PatternPrep"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(PlanBuilder, "substrate", refuse)
    builds = (dict(formats.BUILD_COUNTS), PATTERN_PREP["builds"])
    for n, art in arts.items():
        x = _x(csr.shape[1], n)
        g_vals, g_x = _grads(art, csr, x)
        assert g_vals.shape == (csr.nnz,) and g_x.shape == x.shape
    assert (dict(formats.BUILD_COUNTS), PATTERN_PREP["builds"]) == builds


# ---------------------------------------------------------------------------
# against the reference's artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", [("rmat_s8_e16_uniform", 20),
                                    ("rmat_s8_e16_skewed", 20),
                                    ("rmat_s8_e4_skewed", 1),
                                    ("rmat_s8_e4_uniform", 4)])
@pytest.mark.parametrize("backend", ["torch", "bsr"])
def test_artifact_matches_reference_artifact(backend, name, n):
    ref = SUITE[name]
    csr = _port(ref)
    ref_backend = "xla" if backend == "torch" else "bsr"
    ref_art = ref_plan(ref, backend=ref_backend).finalize(n)
    art = plan(csr, backend=backend).finalize(n)
    assert art.select(n) == ref_art.select(n)
    x = _x(csr.shape[1], n, seed=n)
    xj = jnp.asarray(x.numpy())
    want = ref_execute(ref_art, xj, interpret=True)
    _close(execute(art, x), want, 1e-5)

    def loss(v, xx):
        return (ref_execute(ref_art, xx, vals=v, interpret=True) ** 2).sum()
    ref_gv, ref_gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(ref.data), xj)
    gv, gx = _grads(art, csr, x)
    _close(gv, ref_gv, 1e-4)
    _close(gx, ref_gx, 1e-4)


@pytest.mark.parametrize("kw", [
    {}, {"tile": 64}, {"bsr_block": (16, 64)},
    {"geometry": "tile256"}, {"quant": "int8"}])
def test_topology_key_matches_reference(kw):
    ref = SUITE["rmat_s8_e16_skewed"]
    port_kw, ref_kw = dict(kw), dict(kw)
    if kw.get("geometry"):
        port_kw["geometry"] = TileGeometry(tile=256, wb=64, tile_n=128)
        ref_kw["geometry"] = RefTileGeometry(tile=256, wb=64, tile_n=128)
    p = plan(_port(ref), **port_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rp = ref_plan(ref, **ref_kw)
    assert p.topology_key() == rp.topology_key()
    assert p.finalize(8).meta.topology == rp.finalize(8).meta.topology


def test_quantized_artifact_runs_its_pinned_kernel():
    """Reference caveat (ROADMAP §3): the reference's ``_execute_artifact``
    selects with the bare ``select_kernel`` and skips the quant pin that its
    own ``finalize`` and ``PlanArtifact.select`` apply, so a quantized
    artifact of a uniform matrix at N = 32 carries only the balanced
    substrate and its execute asks for the ELL.  The port dispatches by
    ``PlanArtifact.select``; it matches the reference's artifact run with
    ``impl="nb_sr"``."""
    ref = ref_rmat(8, 16, a=0.25, b=0.25, c=0.25, seed=0)
    ref_art = ref_plan(ref, quant="int8").finalize(32)
    assert tuple(ref_art.substrates) == ("balanced",)
    x = _x(ref.shape[1], 32)
    xj = jnp.asarray(x.numpy())
    with pytest.raises(ValueError, match="needs 'ell'"):
        ref_execute(ref_art, xj)
    art = plan(_port(ref), quant="int8").finalize(32)
    assert tuple(k for k in art.substrates if not k.startswith("t:")) == ("balanced",)
    assert art.select(32) == "nb_sr" and art.meta.quant == "int8"
    assert "quant_scales" in art.aux
    _close(execute(art, x), ref_execute(ref_art, xj, impl="nb_sr"), 1e-5)
