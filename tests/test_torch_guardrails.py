"""The port's guardrails (``repro_torch.core.guardrails``, DESIGN.md §12)
held to the reference's ``tests/test_guardrails.py``, one counterpart a test
on ``"hopper"`` plans of CPU tensors (the wrappers run their plain
versions, and ``kernel_execute:hopper`` trips the ladder ``"hopper"`` →
``"torch"``), and to ``repro`` itself on the same numpy inputs: the issue
tuples of ``inspect_csr``, ``repair_csr``'s arrays bit for bit, one fault
schedule from one seed, the fault matrix's breaker snapshots and counters
under the backend names mapped (``pallas``→``xla`` ↔ ``hopper``→``torch``)
and ``skip_nonfinite``.  Rerouted outputs and grads are bit for bit the
port's ``"torch"`` backend's.

Reference tests without a counterpart here, and the queue item of
``ROADMAP.md`` each waits for: ``test_sharded_demotes_inner_backend`` and
``test_sharded_attention_bias_names_alternatives`` (item 6, the sharded
backend); ``test_serve_faults_shim_reexports`` and
``test_health_summary_shape`` (item 5, serving).
``test_max_win_demotion_counters`` has the port's rule instead: a
``"hopper"`` plan is not demoted by ``max_win`` and counts no
``demote:max_win_*``.  ``test_sentinel_traced_sanitize``'s counterpart is
the CUDA-graph capture branch, driven here through its one hook and on the
card by ``tests/test_torch_gpu.py``.

Tolerance: where the reference's Pallas kernel and the port's ``"hopper"``
entry on the CPU sum in other orders, 2e-5 relative, as the reference's
own fault-matrix test allows."""
import contextlib
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.api as ref_api
from _hypothesis_compat import MALFORMED_KINDS, malformed_csr
from conftest import random_csr
from repro.core import guardrails as RG
from repro.core.formats import CSR as RefCSR
from repro.core.plan import execute as ref_execute
from repro.core.plan import plan as ref_plan
from repro.runtime import faults as ref_faults
from repro.train.step import TrainConfig as RefTrainConfig
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_train_step as ref_make_train_step
import repro_torch
from repro_torch import api, interop
from repro_torch.core import formats
from repro_torch.core import guardrails as G
from repro_torch.core import registry
from repro_torch.core.cache import PlanCache, cached_plan
from repro_torch.core.plan import (PlanBuildError, execute, execute_attention,
                                   execute_chain, execute_sddmm, plan)
from repro_torch.core.selector import default_thresholds
from repro_torch.runtime.faults import (FaultInjector, FaultSpec,
                                        InjectedFault, inject_faults)
from repro_torch.runtime.retry import RetryPolicy, TaskOutcome, run_with_retry
from repro_torch.train.step import TrainConfig, init_state, make_train_step


@pytest.fixture(autouse=True)
def _fresh_health():
    for h in (G.HEALTH, RG.HEALTH):
        h.reset()
        h.configure()
    yield
    for h in (G.HEALTH, RG.HEALTH):
        h.reset()
        h.configure()


def _port(csr):
    """The port's CSR of a reference CSR, defects included."""
    return interop.csr_from_arrays(np.asarray(csr.indptr),
                                   np.asarray(csr.indices),
                                   np.asarray(csr.data), csr.shape)


def _arrays(csr):
    return tuple(np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
                 for a in (csr.indptr, csr.indices, csr.data))


def _dense_semantics(csr):
    """The meaning a malformed CSR repairs to: duplicates summed,
    out-of-range columns dropped, non-finite values zeroed."""
    m, k = (int(s) for s in csr.shape)
    indptr, idx, dat = _arrays(csr)
    dat = dat.astype(np.float64)
    out = np.zeros((m, k), np.float64)
    for r in range(m):
        for j in range(int(indptr[r]), int(indptr[r + 1])):
            c = int(idx[j])
            if 0 <= c < k:
                out[r, c] += dat[j] if np.isfinite(dat[j]) else 0.0
    return out


def _shuffle_rows(csr, seed=1):
    """Permute indices and data within each row (clean → 'unsorted')."""
    indptr, idx, dat = (a.copy() for a in _arrays(csr))
    r = np.random.default_rng(seed)
    for i in range(int(csr.shape[0])):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        pm = r.permutation(hi - lo)
        idx[lo:hi] = idx[lo:hi][pm]
        dat[lo:hi] = dat[lo:hi][pm]
    return interop.csr_from_arrays(indptr, idx, dat, csr.shape)


def _mat(seed=2, m=32, k=24, n=8, density=0.3):
    rng = np.random.default_rng(seed)
    csr, _ = random_csr(rng, m, k, density)
    x = rng.standard_normal((k, n)).astype(np.float32)
    return csr, x


def _bits(a, b) -> bool:
    return torch.equal(a, b)


@pytest.fixture
def hopper_calls(monkeypatch):
    """Every call of a ``"hopper"`` registry entry, by logical kernel: on
    the CPU the entries' plain versions may give the "torch" backend's bits,
    so a rerouted call is also held to running none of them, forward and
    backward."""
    calls: list = []
    registry.available("hopper")
    for (logical, backend), entry in list(registry._REGISTRY.items()):
        if backend != "hopper":
            continue

        def spy(*args, _fn=entry.fn, _name=logical, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setitem(registry._REGISTRY, (logical, backend),
                            dataclasses.replace(entry, fn=spy))
    return calls


# ---------------------------------------------------------------------------
# pillar 1: pattern validation and repair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", MALFORMED_KINDS)
def test_repair_produces_canonical_clean(kind):
    for seed in range(4):
        csr = _port(malformed_csr(kind, seed))
        assert not G.inspect_csr(csr).ok
        fixed = G.repair_csr(csr)
        assert G.inspect_csr(fixed).ok, (kind, seed)
        np.testing.assert_allclose(_dense_semantics(fixed),
                                   _dense_semantics(csr), rtol=1e-6)


@pytest.mark.parametrize("kind", MALFORMED_KINDS)
def test_inspect_and_repair_match_the_reference(kind):
    """The same defects and the same repaired arrays, bit for bit, as
    ``repro.core.guardrails`` on the same triplet."""
    for seed in range(4):
        ref = malformed_csr(kind, seed)
        csr = _port(ref)
        assert G.inspect_csr(csr).issues == RG.inspect_csr(ref).issues
        got, want = G.repair_csr(csr), RG.repair_csr(ref)
        for g, w in zip(_arrays(got), _arrays(want)):
            assert g.dtype == w.dtype and np.array_equal(g, w), (kind, seed)
        assert got.shape == tuple(want.shape)


def test_interop_carries_malformed_triplets_as_they_are():
    """``csr_from_arrays`` neither sorts, coalesces nor clips: every defect
    of the reference's malformed cases and a broken indptr's values cross,
    so validation sees the reference's input; lengths that disagree and an
    index int32 cannot hold are refused, not hidden."""
    ref = malformed_csr("mixed", 2)
    csr = _port(ref)
    for g, w in zip(_arrays(csr), _arrays(ref)):
        assert np.array_equal(g, w, equal_nan=True)
    bad_ptr = np.asarray(ref.indptr).copy()
    bad_ptr[3] = -5
    broken = interop.csr_from_arrays(bad_ptr, np.asarray(ref.indices),
                                     np.asarray(ref.data), ref.shape)
    assert np.array_equal(broken.indptr.numpy(), bad_ptr)
    assert "indptr" in G.inspect_csr(broken).issues
    with pytest.raises(ValueError, match="shape"):
        interop.csr_from_arrays(np.asarray(ref.indptr)[:-1],
                                np.asarray(ref.indices),
                                np.asarray(ref.data), ref.shape)
    with pytest.raises(ValueError, match="int32"):
        interop.csr_from_arrays(np.array([0, 1]), np.array([2**40]),
                                np.ones(1, np.float32), (1, 4))


def test_repair_matches_presorted_reference(rng):
    csr, _ = random_csr(np.random.default_rng(0), 16, 12, 0.4)
    clean = _port(csr)
    fixed, report = G.validate_csr(_shuffle_rows(clean), "repair")
    for g, w in zip(_arrays(fixed), _arrays(clean)):
        assert np.array_equal(g, w)
    assert G.HEALTH.counter("pattern_repairs") == 1
    same, rep = G.validate_csr(clean, "repair")
    assert same is clean and rep.ok
    assert G.HEALTH.counter("pattern_repairs") == 1


def test_repair_handles_broken_indptr():
    csr, _ = random_csr(np.random.default_rng(3), 8, 6, 0.5)
    bad_ptr = np.asarray(csr.indptr).copy()
    bad_ptr[2] = csr.nnz + 7          # non-monotone and out of range
    ref_broken = RefCSR(jnp.asarray(bad_ptr), csr.indices, csr.data, csr.shape)
    broken = _port(ref_broken)
    issues = G.inspect_csr(broken).issues
    assert "indptr" in issues and issues == RG.inspect_csr(ref_broken).issues
    fixed = G.repair_csr(broken)
    assert G.inspect_csr(fixed).ok
    for g, w in zip(_arrays(fixed), _arrays(RG.repair_csr(ref_broken))):
        assert np.array_equal(g, w)


def test_validate_policies():
    bad = _port(malformed_csr("mixed", 0))
    with pytest.raises(G.PatternError) as ei:
        G.validate_csr(bad, "strict")
    assert "out_of_range" in ei.value.issues
    assert isinstance(ei.value, ValueError)
    with pytest.warns(UserWarning, match="pattern has issues"):
        same, rep = G.validate_csr(bad, "check")
    assert same is bad and not rep.ok
    same2, rep2 = G.validate_csr(bad, "off")
    assert same2 is bad and rep2.ok
    with pytest.raises(ValueError, match="unknown validate policy"):
        G.validate_csr(bad, "fixit")
    assert G.HEALTH.counter("pattern_issues") == 2


def test_sparse_validate_repair_executes():
    bad = _port(malformed_csr("mixed", 3))
    m = api.sparse(bad, validate="repair", device="cpu", cache=False)
    x = np.random.default_rng(0).standard_normal(
        (int(bad.shape[1]), 4)).astype(np.float32)
    y = m.matmul(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, _dense_semantics(bad) @ x.astype(np.float64),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(api.PatternError):
        api.sparse(bad, validate="strict", device="cpu", cache=False)


def test_plan_validate_and_sentinel_args():
    bad = _port(malformed_csr("unsorted", 1))
    p = plan(bad, backend="hopper", validate="repair")
    assert G.inspect_csr(p.csr).ok
    with pytest.raises(G.PatternError):
        plan(bad, backend="hopper", validate="strict")
    clean, _ = random_csr(np.random.default_rng(4), 8, 6, 0.5)
    with pytest.raises(ValueError, match="sentinel policy"):
        plan(_port(clean), backend="hopper", sentinel="bogus")


def test_cached_plan_repair_shares_clean_key():
    csr, _ = random_csr(np.random.default_rng(5), 12, 10, 0.4)
    clean = _port(csr)
    cache = PlanCache(8)
    p1 = cached_plan(clean, cache=cache, backend="hopper")
    p2 = cached_plan(_shuffle_rows(clean, seed=7), cache=cache,
                     backend="hopper", validate="repair")
    assert p2 is p1
    assert cache.stats()["hits"] == 1 and cache.stats()["builds"] == 1
    # the facade too: a repaired matrix hits the clean matrix's entry
    a = api.sparse(clean, device="cpu", cache=cache)
    b = api.sparse(_shuffle_rows(clean, seed=8), device="cpu", cache=cache,
                   validate="repair")
    assert b.plan is a.plan and cache.stats()["builds"] == 2


# ---------------------------------------------------------------------------
# pillar 3: the ladder, the breakers and the fault sites
# ---------------------------------------------------------------------------

def _mapped(snapshot: dict) -> dict:
    """A reference health snapshot under the port's backend names."""
    def name(s):
        return s.replace("pallas", "hopper").replace("xla", "torch")
    return {"counters": {name(k): v for k, v in snapshot["counters"].items()},
            "breakers": {name(k): v for k, v in snapshot["breakers"].items()}}


def test_fault_matrix_breaker_trip_reroute_recover():
    """threshold 2, cooldown 0, three injected Hopper failures: reroute,
    trip, failed half-open probe, then a probe that recovers — the
    reroutes bit for bit the "torch" backend, all in ``api.health()``."""
    csr, x = _mat()
    G.HEALTH.configure(threshold=2, cooldown_s=0.0)
    pc, tx = _port(csr), torch.from_numpy(x)
    p = plan(pc, backend="hopper")
    want = execute(plan(pc, backend="torch"), tx, impl="nb_pr")
    fi = FaultInjector({"kernel_execute:hopper": FaultSpec(fail=3)})
    with inject_faults(fi):
        outs = [execute(p, tx, impl="nb_pr") for _ in range(4)]
    for i in range(3):
        assert _bits(outs[i], want), f"call {i} not bit for bit torch"
    np.testing.assert_allclose(outs[3].numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    h = api.health()
    assert h["counters"]["kernel_reroute:hopper->torch:nb_pr"] == 3
    assert h["breakers"]["hopper:nb_pr"] == {
        "state": "closed", "failures": 0, "trips": 2, "recoveries": 1}
    assert fi.counts() == {"kernel_execute:hopper": 3}


@pytest.mark.parametrize("threshold,fail,calls", [(2, 3, 4), (1, 2, 5),
                                                  (3, 5, 6)])
def test_fault_matrix_matches_the_reference(threshold, fail, calls):
    """The same schedule on ``repro`` (Pallas in interpret mode) and on the
    port leaves the same breaker snapshots and counters, backend names
    mapped, after every call."""
    csr, x = _mat(seed=30 + fail)
    pc, tx = _port(csr), torch.from_numpy(x)
    for h in (G.HEALTH, RG.HEALTH):
        h.configure(threshold=threshold, cooldown_s=0.0)
    p = plan(pc, backend="hopper")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rp = ref_plan(csr, backend="pallas")
    rfi = ref_faults.FaultInjector(
        {"kernel_execute:pallas": ref_faults.FaultSpec(fail=fail)})
    fi = FaultInjector({"kernel_execute:hopper": FaultSpec(fail=fail)})
    for _ in range(calls):
        with ref_faults.inject_faults(rfi):
            want = np.asarray(ref_execute(rp, jnp.asarray(x), impl="nb_pr",
                                          interpret=True))
        with inject_faults(fi):
            got = execute(p, tx, impl="nb_pr")
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        assert api.health() == _mapped(ref_api.health())
    assert fi.counts() == {"kernel_execute:hopper": fail}
    assert rfi.counts() == {"kernel_execute:pallas": fail}


@pytest.mark.parametrize("impl,n", [("nb_pr", 1), ("nb_pr", 4), ("nb_sr", 8),
                                    ("rs_sr", 8), ("rs_pr", 3)])
def test_breaker_reroute_grads_bitwise(impl, n, hopper_calls):
    """A rerouted call's output and its grads, in ``x`` and in a live
    stream, are bit for bit the "torch" backend's: the backward is built on
    the rung the forward ran on."""
    csr, x = _mat(seed=6, n=n)
    G.HEALTH.configure(threshold=2, cooldown_s=0.0)
    pc = _port(csr)
    p, ref = plan(pc, backend="hopper"), plan(pc, backend="torch")
    xs = x[:, 0] if n == 1 else x

    def grads(target, **kw):
        v = pc.data.clone().requires_grad_()
        tx = torch.from_numpy(xs.copy()).requires_grad_()
        y = execute(target, tx, vals=v, impl=impl, **kw)
        return (y, *torch.autograd.grad((y * y).sum(), [v, tx]))

    want = grads(ref)
    with inject_faults(FaultInjector(
            {"kernel_execute:hopper": FaultSpec(fail=1)})):
        got = grads(p)
    for g, w in zip(got, want):
        assert _bits(g, w)
    assert hopper_calls == []
    assert G.HEALTH.counter(f"kernel_reroute:hopper->torch:{impl}") == 1


@pytest.mark.parametrize("n", [1, 8])
def test_artifact_reroute_bitwise_and_bsr_reraises(n, hopper_calls):
    """An artifact's rung below exists where the "torch" entry's substrate
    was finalized in: a "hopper" artifact reroutes (output and grads bit for
    bit the "torch" builder's), a "bsr" artifact re-raises."""
    csr, x = _mat(seed=40, n=n)
    pc = _port(csr)
    xs = torch.from_numpy(x[:, 0] if n == 1 else x)
    art = plan(pc, backend="hopper").finalize(n)
    name = art.select(n)
    hopper_calls.clear()
    ref = plan(pc, backend="torch")

    def grads(target, **kw):
        v = pc.data.clone().requires_grad_()
        tx = xs.clone().requires_grad_()
        y = execute(target, tx, vals=v, impl=name, **kw)
        return (y, *torch.autograd.grad((y * y).sum(), [v, tx]))

    want = grads(ref)
    with inject_faults(FaultInjector(
            {"kernel_execute:hopper": FaultSpec(fail=1)})):
        got = grads(art)
    for g, w in zip(got, want):
        assert _bits(g, w)
    assert hopper_calls == []
    assert G.HEALTH.counter(f"kernel_reroute:hopper->torch:{name}") == 1
    w = np.zeros((16, 256), np.float32)
    w[:8, :128] = np.random.default_rng(1).standard_normal((8, 128))
    b_art = plan(formats.csr_from_dense(w), backend="bsr").finalize(n)
    xb = torch.ones(256) if n == 1 else torch.ones(256, n)
    with inject_faults(FaultInjector({"kernel_execute:bsr": FaultSpec(fail=1)})):
        with pytest.raises(InjectedFault):
            execute(b_art, xb)


def test_bsr_builder_reroutes_to_torch():
    w = np.zeros((16, 256), np.float32)
    rng = np.random.default_rng(2)
    w[8:, 128:] = rng.standard_normal((8, 128))
    csr = formats.csr_from_dense(w)
    x = torch.from_numpy(rng.standard_normal((256, 4)).astype(np.float32))
    p = plan(csr, backend="bsr")
    name = p.select(4)
    want = execute(plan(csr, backend="torch"), x, impl=name)
    with inject_faults(FaultInjector({"kernel_execute:bsr": FaultSpec(fail=1)})):
        got = execute(p, x)
    assert _bits(got, want)
    assert G.HEALTH.counter(f"kernel_reroute:bsr->torch:{name}") == 1


def _chain_case(seed=50):
    rng = np.random.default_rng(seed)
    csr, _ = random_csr(rng, 12, 10, 0.4)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((12, 6), (10, 6)))
    x = torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(csr.nnz).astype(np.float32))
    return _port(csr), a, b, x, bias


@pytest.mark.parametrize("family", ["sddmm", "chain", "attn", "attn_bias"])
def test_chain_family_reroutes_bitwise(family, hopper_calls):
    """``execute_sddmm`` / ``execute_chain`` / ``execute_attention`` (both
    arms) reroute a failing Hopper call to "torch", output and grads bit for
    bit, under the logical kernel of the entry that ran."""
    pc, a, b, x, bias = _chain_case()
    p, ref = plan(pc, backend="hopper"), plan(pc, backend="torch")
    calls = {
        "sddmm": ("sddmm", lambda q, aa, bb, xx: execute_sddmm(q, aa, bb)),
        "chain": ("chain", lambda q, aa, bb, xx: execute_chain(
            q, aa, bb, xx, transform="softmax", alpha=0.5)),
        "attn": ("chain", lambda q, aa, bb, xx: execute_attention(q, aa, bb, xx)),
        "attn_bias": ("attn_chain", lambda q, aa, bb, xx: execute_attention(
            q, aa, bb, xx, bias=bias)),
    }
    logical, call = calls[family]

    def grads(target):
        ops = [t.clone().requires_grad_() for t in (a, b, x)]
        y = call(target, *ops)
        return (y, *torch.autograd.grad((y * y).sum(), ops,
                                        allow_unused=True))

    want = grads(ref)
    with inject_faults(FaultInjector(
            {"kernel_execute:hopper": FaultSpec(fail=1)})):
        got = grads(p)
    for g, w in zip(got, want):
        assert (g is None and w is None) or _bits(g, w)
    assert hopper_calls == []
    assert G.HEALTH.snapshot()["counters"] == {
        f"kernel_reroute:hopper->torch:{logical}": 1}


def test_open_breaker_skips_primary():
    csr, x = _mat(seed=7)
    G.HEALTH.configure(threshold=1, cooldown_s=3600.0)
    pc, tx = _port(csr), torch.from_numpy(x)
    p = plan(pc, backend="hopper")
    want = execute(plan(pc, backend="torch"), tx, impl="nb_pr")
    with inject_faults(FaultInjector(
            {"kernel_execute:hopper": FaultSpec(fail=1)})):
        y1 = execute(p, tx, impl="nb_pr")
    y2 = execute(p, tx, impl="nb_pr")
    assert _bits(y1, want) and _bits(y2, want)
    assert G.HEALTH.counter("breaker_skip:hopper:nb_pr") == 1
    assert G.HEALTH.snapshot()["breakers"]["hopper:nb_pr"]["state"] == "open"


def test_ladder_bottom_reraises():
    csr, x = _mat(seed=8)
    pc, tx = _port(csr), torch.from_numpy(x)
    p = plan(pc, backend="torch")
    with inject_faults(FaultInjector({"kernel_execute:torch": FaultSpec(fail=1)})):
        with pytest.raises(InjectedFault):
            execute(p, tx, impl="nb_pr")
    # usage errors are never swallowed by the ladder
    p2 = plan(pc, backend="hopper")
    with pytest.raises(ValueError, match="vals stream"):
        execute(p2, tx, vals=torch.zeros(3), impl="nb_pr")
    assert "hopper:nb_pr" not in G.HEALTH.snapshot()["breakers"] or \
        G.HEALTH.snapshot()["breakers"]["hopper:nb_pr"]["failures"] == 0


def test_card_has_no_rung_below():
    """On CUDA operands a kernel launches or raises: ``_rung`` offers no
    rung, and ``guarded_call(on_card=True)`` records each failure in the
    breaker, counts it as ``kernel_failure`` and re-raises; the open breaker
    skips nothing, and the next success closes it."""
    from repro_torch.core.plan import _rung

    class _OnCard:
        is_cuda = True
    assert _rung("hopper", _OnCard()) is None
    assert _rung("bsr", _OnCard()) is None
    assert _rung("hopper", torch.zeros(1)) == "torch"
    assert _rung("bsr", torch.zeros(1)) == "torch"
    G.HEALTH.configure(threshold=2, cooldown_s=3600.0)
    tries = []

    def launch_error():
        tries.append(1)
        raise RuntimeError("launch failed: cudaError_t 9")
    for _ in range(3):
        with pytest.raises(RuntimeError, match="cudaError_t 9"):
            G.guarded_call("nb_pr", "hopper", launch_error, on_card=True)
    assert len(tries) == 3
    snap = G.HEALTH.snapshot()
    assert snap["counters"] == {"kernel_failure:hopper:nb_pr": 3}
    assert snap["breakers"]["hopper:nb_pr"] == {
        "state": "open", "failures": 3, "trips": 1, "recoveries": 0}
    assert G.guarded_call("nb_pr", "hopper", lambda: 5, on_card=True) == 5
    assert G.HEALTH.snapshot()["breakers"]["hopper:nb_pr"] == {
        "state": "closed", "failures": 0, "trips": 1, "recoveries": 1}


def test_ladder_catches_kernel_failures_not_usage_errors(monkeypatch):
    """A real failure of the Hopper entry (a ``RuntimeError``, as a CUDA
    launch error or a failed build raises) reroutes; its ``ValueError`` and
    a ``NumericFault`` propagate."""
    csr, x = _mat(seed=9)
    pc, tx = _port(csr), torch.from_numpy(x)
    p = plan(pc, backend="hopper")
    entry = registry.resolve("nb_pr", "hopper")
    for exc, caught in ((RuntimeError("launch failed: cudaError_t 9"), True),
                        (ValueError("bad operand"), False),
                        (G.NumericFault("poisoned"), False)):
        def broken(*args, _e=exc, **kw):
            raise _e
        monkeypatch.setitem(registry._REGISTRY, ("nb_pr", "hopper"),
                            dataclasses.replace(entry, fn=broken))
        if caught:
            assert _bits(execute(p, tx, impl="nb_pr"),
                         execute(plan(pc, backend="torch"), tx, impl="nb_pr"))
        else:
            with pytest.raises(type(exc)):
                execute(p, tx, impl="nb_pr")
    assert G.HEALTH.counter("kernel_reroute:hopper->torch:nb_pr") == 1


def test_plan_build_and_substrate_prep_fault_sites(monkeypatch):
    csr, _ = _mat(seed=10)
    pc = _port(csr)
    p = plan(pc, backend="hopper")
    with inject_faults(FaultInjector({"plan_build": FaultSpec(fail=1)})):
        with pytest.raises(InjectedFault):
            p.substrate("balanced")
    p.substrate("balanced")
    p2 = plan(pc, backend="hopper")
    entry = p2.entry("nb_pr", "hopper")
    p2.substrate(entry.substrate)
    with inject_faults(FaultInjector({"substrate_prep": FaultSpec(fail=1)})):
        with pytest.raises(InjectedFault):
            p2.kernel_opts(entry)
    p2.kernel_opts(entry)
    # a build that fails for a reason of its own is wrapped, its cause kept
    import repro_torch.core.plan as plan_mod

    def boom(*a, **k):
        raise MemoryError("no room")
    monkeypatch.setattr(plan_mod, "csr_to_ell", boom)
    with pytest.raises(PlanBuildError, match="'ell'") as ei:
        plan(pc, backend="hopper").substrate("ell")
    assert isinstance(ei.value.__cause__, MemoryError)
    assert ei.value.kind == "ell" and ei.value.shape == tuple(pc.shape)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**20])
@pytest.mark.parametrize("site", ["kernel_execute:hopper", "plan_build",
                                  "topology_drift"])
def test_fault_schedule_matches_the_reference(seed, site):
    """One ``(seed, spec)``: the same 200 consultations fire in both
    packages (the per-site stream seeded by ``crc32``)."""
    for spec in ({"p_fail": 0.3}, {"fail": 3, "p_fail": 0.5}):
        ref = ref_faults.FaultInjector({site: ref_faults.FaultSpec(**spec)},
                                       seed=seed)
        got = FaultInjector({site: FaultSpec(**spec)}, seed=seed)
        assert [got.fire(site) for _ in range(200)] == \
            [ref.fire(site) for _ in range(200)]
        assert got.counts() == ref.counts()
    a = FaultInjector({"topology_drift": FaultSpec(fail=1)})
    assert a.perturb_topology((3, 0), 4) == (0, 1)
    assert a.perturb_topology((3, 0), 4) == (3, 0)


def test_retry_policy_and_outcome():
    """``run_with_retry`` as the reference's: bounded attempts, the backoff
    schedule through an injected ``sleep``, never raising."""
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise InjectedFault("again")
        return "done"

    pol = RetryPolicy(retries=3, backoff=0.1, factor=2.0, max_backoff=0.15)
    out = run_with_retry(flaky, pol, sleep=slept.append)
    assert out.ok and out.value == "done" and out.attempts == 3
    assert slept == [0.1, 0.15]
    bad = run_with_retry(lambda: 1 / 0, RetryPolicy(retries=1),
                         sleep=slept.append,
                         on_retry=lambda n, e: calls.append(n))
    assert bad.status == "failed" and bad.attempts == 2
    assert bad.error.startswith("ZeroDivisionError")
    aborted = run_with_retry(lambda: 1 / 0, RetryPolicy(retries=5),
                             should_abort=lambda: True, sleep=slept.append,
                             outcome=TaskOutcome())
    assert aborted.attempts == 1 and aborted.error.endswith("(aborted)")


# ---------------------------------------------------------------------------
# pillar 2: numeric sentinels
# ---------------------------------------------------------------------------

def _nan_kernel(bal, x, **opts):
    tail = tuple(x.shape[1:])
    dt = x.dtype if x.is_floating_point() else torch.float32
    return torch.full((int(bal.shape[0]),) + tail, float("nan"), dtype=dt)


@contextlib.contextmanager
def _poisoned_backend(backend):
    """Replace the (nb_pr, backend) kernel with a NaN producer for a
    while."""
    orig = registry.resolve("nb_pr", backend)
    registry.register("nb_pr", backend, "balanced", _nan_kernel)
    try:
        yield
    finally:
        registry._REGISTRY[("nb_pr", backend)] = orig


def test_sentinel_raise_and_sanitize():
    csr, x = _mat(seed=11)
    pc, tx = _port(csr), torch.from_numpy(x)
    with _poisoned_backend("torch"):
        p = plan(pc, backend="torch")
        with pytest.raises(G.NumericFault, match="execute:nb_pr"):
            execute(p, tx, impl="nb_pr", sentinel="raise")
        y = execute(p, tx, impl="nb_pr", sentinel="sanitize")
        assert bool((y == 0.0).all())
        y2 = execute(p, tx, impl="nb_pr")
        assert not bool(torch.isfinite(y2).any())    # opt-in: off by default
        with pytest.raises(ValueError, match="sentinel policy"):
            execute(p, tx, impl="nb_pr", sentinel="bogus")
    assert G.HEALTH.counter("sentinel:execute:nb_pr") == 2


def test_sentinel_plan_default_and_scope():
    csr, x = _mat(seed=12)
    pc, tx = _port(csr), torch.from_numpy(x)
    with _poisoned_backend("hopper"):
        p = plan(pc, backend="hopper", sentinel="sanitize")
        assert bool(torch.isfinite(execute(p, tx, impl="nb_pr")).all())
        p2 = plan(pc, backend="hopper")
        with api.sentinel_scope("sanitize"):
            assert bool(torch.isfinite(execute(p2, tx, impl="nb_pr")).all())
            assert bool(torch.isfinite(api.sparse(
                pc, device="cpu", backend="hopper", cache=False).matmul(
                    tx, impl="nb_pr")).all())
        with api.sentinel_scope("sanitize"):
            with pytest.raises(G.NumericFault):
                execute(p2, tx, impl="nb_pr", sentinel="raise")
        art = p2.finalize(kernels=("nb_pr",))
        with api.sentinel_scope("sanitize"):
            assert bool((execute(art, tx, impl="nb_pr") == 0).all())


def test_sentinel_under_capture_stays_in_graph(monkeypatch):
    """The counterpart of the reference's traced sentinel: under CUDA-graph
    capture "sanitize" is the in-graph pass, and so is "fallback" (a graph
    is captured on the card, where there is no rung below), "raise" is
    refused at capture time, and no counter moves."""
    csr, x = _mat(seed=13)
    pc, tx = _port(csr), torch.from_numpy(x)
    monkeypatch.setattr(G, "_capturing", lambda y: True)
    with _poisoned_backend("hopper"):
        p = plan(pc, backend="hopper")
        for policy in ("sanitize", "fallback"):
            assert bool((execute(p, tx, impl="nb_pr", sentinel=policy)
                         == 0.0).all())
        with pytest.raises(ValueError, match="eagerly"):
            execute(p, tx, impl="nb_pr", sentinel="raise")
    y = torch.tensor([1.0, float("inf"), -2.0])
    fb = G.apply_sentinel(y, "fallback", site="s",
                          fallback=lambda: torch.full_like(y, 7.0))
    assert fb.tolist() == [1.0, 0.0, -2.0]
    assert G.HEALTH.snapshot()["counters"] == {}


def test_sanitize_is_the_where_of_isfinite():
    y = torch.tensor([1.5, float("nan"), float("inf"), -float("inf"), -0.0,
                      3e38])
    got = G.apply_sentinel(y, "sanitize", site="s")
    want = torch.where(torch.isfinite(y), y, torch.zeros(()))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ints = torch.arange(4)
    assert G.apply_sentinel(ints, "raise", site="s") is ints


def test_sentinel_fallback_reexecutes_demoted():
    csr, x = _mat(seed=14)
    pc, tx = _port(csr), torch.from_numpy(x)
    with _poisoned_backend("hopper"):
        p = plan(pc, backend="hopper")
        want = execute(plan(pc, backend="torch"), tx, impl="nb_pr")
        assert _bits(execute(p, tx, impl="nb_pr", sentinel="fallback"), want)
    assert G.HEALTH.counter("sentinel_fallback:execute:nb_pr") == 1


@pytest.mark.parametrize("family", ["matmul", "chain"])
def test_grad_scope_sanitizes_cotangents(family):
    pc, a, b, x, _ = _chain_case(seed=15)
    p = plan(pc, backend="hopper")
    if family == "matmul":
        def fwd(xx):
            return execute(p, xx, impl="nb_pr")
    else:
        def fwd(xx):
            return execute_chain(p, a, b, xx, transform="softmax")
    xr = x.clone().requires_grad_()
    y = fwd(xr)
    ct = torch.full_like(y, float("nan"))
    (dx_plain,) = torch.autograd.grad(y, xr, ct)
    assert not bool(torch.isfinite(dx_plain).all())
    with G.grad_scope("sanitize"):
        y2 = fwd(xr)
        (dx,) = torch.autograd.grad(y2, xr, ct)
    assert bool(torch.isfinite(dx).all())
    # the scope of the forward reaches a backward run outside it
    with G.grad_scope("sanitize"):
        y3 = fwd(xr)
    (dx3,) = torch.autograd.grad(y3, xr, ct)
    assert torch.equal(dx3, dx)
    with pytest.raises(ValueError, match="skip-and-report"):
        with G.grad_scope("raise"):
            pass


def _skip_run(make_step, state, batches):
    out = []
    for b in batches:
        state, m = make_step(state, b)
        out.append((state, int(m["skipped_nonfinite"])))
    return out


def test_train_step_skips_nonfinite():
    """The reference's skip-and-report test in both packages: the poisoned
    step keeps params and optimizer state bit for bit, the next step moves
    them, and the two packages agree on every step."""
    def loss_fn(params, batch):
        poison = torch.where(batch["bad"] > 0, float("nan"), 0.0)
        return (params["w"] * batch["x"]).sum() + poison, {}

    def ref_loss(params, batch):
        poison = jnp.where(batch["bad"] > 0, jnp.nan, 0.0)
        return jnp.sum(params["w"] * batch["x"]) + poison, {}

    tcfg, rcfg = TrainConfig(skip_nonfinite=True), RefTrainConfig(
        skip_nonfinite=True)
    step = make_train_step(loss_fn, tcfg)
    rstep = jax.jit(ref_make_train_step(ref_loss, rcfg))
    flags = (0, 1, 0)
    port = _skip_run(step, init_state({"w": torch.ones(4)}, tcfg),
                     [{"x": torch.arange(4.0), "bad": torch.tensor(f)}
                      for f in flags])
    ref = _skip_run(rstep, ref_init_state({"w": jnp.ones((4,))}, rcfg),
                    [{"x": jnp.arange(4.0), "bad": jnp.array(f)}
                     for f in flags])
    assert [s for _, s in port] == [s for _, s in ref] == list(flags)
    (s1, _), (s2, _), (s3, _) = port
    for key in ("w",):
        assert torch.equal(s1["params"][key], s2["params"][key])
        assert torch.equal(s1["opt"]["m"][key], s2["opt"]["m"][key])
        assert torch.equal(s1["opt"]["v"][key], s2["opt"]["v"][key])
    assert torch.equal(s1["opt"]["step"], s2["opt"]["step"])
    assert not torch.equal(s3["params"]["w"], s2["params"]["w"])
    (r1, _), (r2, _), _ = ref
    for a, b in zip(jax.tree_util.tree_leaves(r1), jax.tree_util.tree_leaves(r2)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for (ps, _), (rs, _) in zip(port, ref):
        np.testing.assert_allclose(ps["params"]["w"].numpy(),
                                   np.asarray(rs["params"]["w"]), rtol=1e-6)
        assert int(ps["opt"]["step"]) == int(rs["opt"]["step"])


# ---------------------------------------------------------------------------
# named demotion counters
# ---------------------------------------------------------------------------

def test_quant_range_demotion_and_sentinel_raise():
    dense = np.full((8, 16), 1e-3, np.float32)
    dense[0, 0] = 1e6          # one tile, dynamic range ~1e9 past the bound
    csr = formats.csr_from_dense(dense)
    with pytest.warns(UserWarning, match="dynamic range"):
        p = plan(csr, backend="hopper", quant="int8")
        p.substrate("balanced")
    assert p.quant is None
    assert G.HEALTH.counter("quant_range_violations") == 1
    assert G.HEALTH.counter("demote:quant_range") == 1
    p2 = plan(csr, backend="hopper", quant="int8", sentinel="raise")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(G.NumericFault, match="quant"):
            p2.substrate("balanced")


def test_fp8_demotion_counter(monkeypatch):
    from repro_torch.core import quant as quant_mod
    monkeypatch.setattr(quant_mod, "supports", lambda mode: mode != "fp8")
    csr, _ = _mat(seed=26)
    with pytest.warns(UserWarning, match="demoting"):
        assert plan(_port(csr), backend="hopper", quant="fp8").quant == "int8"
    assert G.HEALTH.counter("demote:fp8_to_int8") == 1


def test_hopper_plan_keeps_backend_past_max_win():
    """The port's rule in place of the reference's max_win demotion: a
    "hopper" plan keeps its backend and counts no ``demote:max_win_*``."""
    csr, _ = _mat(seed=16, m=16, k=12, density=0.3)
    th = dataclasses.replace(default_thresholds(), max_win=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p = plan(_port(csr), backend="hopper", thresholds=th)
    assert p.backend == "hopper"
    assert not [k for k in G.HEALTH.snapshot()["counters"]
                if k.startswith("demote:max_win")]


def test_fuse_crossover_counters():
    rng = np.random.default_rng(17)
    csr, _ = random_csr(rng, 12, 10, 0.4)
    th = dataclasses.replace(default_thresholds(), chain_fuse_min_n=10**6,
                             attn_fuse_min_seq=10**6)
    p = plan(_port(csr), backend="hopper", thresholds=th)
    a = torch.from_numpy(rng.standard_normal((12, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((10, 6)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))
    execute_chain(p, a, b, x, transform="softmax")
    assert G.HEALTH.counter("demote:chain_fuse") == 1
    execute_attention(p, a, b, x)
    assert G.HEALTH.counter("demote:attn_fuse") == 1
    # the "torch" backend has no gate to shut
    execute_chain(plan(_port(csr), backend="torch", thresholds=th), a, b, x)
    assert G.HEALTH.counter("demote:chain_fuse") == 1


# ---------------------------------------------------------------------------
# pillar 4: plan integrity digests
# ---------------------------------------------------------------------------

def test_plan_digest_stability_and_sensitivity():
    csr, _ = _mat(seed=19)
    other, _ = _mat(seed=20)
    pc = _port(csr)
    p1, p2 = plan(pc, backend="torch"), plan(_port(csr), backend="torch")
    assert G.plan_digest(p1) == G.plan_digest(p2)
    assert G.plan_digest(p1) != G.plan_digest(plan(_port(other), backend="torch"))
    assert G.plan_digest(p1) != G.plan_digest(plan(pc, backend="hopper"))
    d = G.plan_digest(p1)
    p1.substrate("balanced")
    assert G.plan_digest(p1) == d
    a1 = plan(pc, backend="hopper").finalize(4)
    a2 = plan(pc, backend="hopper").finalize(4)
    assert G.plan_digest(a1) == G.plan_digest(a2)
    vals = pc.data.clone()
    vals[0] += 1.0
    a3 = plan(formats.CSR(pc.indptr, pc.indices, vals, pc.shape),
              backend="hopper").finalize(4)
    assert G.plan_digest(a3) != G.plan_digest(a1)


def test_cache_integrity_hit_rebuilds_corrupted():
    csr, _ = _mat(seed=21)
    other, _ = _mat(seed=22)
    cache = PlanCache(4, integrity="hit")
    builds = []

    def build():
        builds.append(1)
        return plan(_port(csr), backend="torch")

    key = ("k",)
    v1 = cache.get_or_build(key, build)
    assert cache.get(key) is v1 and len(builds) == 1
    corrupt = plan(_port(other), backend="torch")
    with cache._lock:
        _, dig = cache._entries[key]
        cache._entries[key] = (corrupt, dig)
    v2 = cache.get_or_build(key, build)
    assert v2 is not corrupt and len(builds) == 2
    assert cache.stats()["digest_mismatches"] == 1
    with cache._lock:
        _, dig = cache._entries[key]
        cache._entries[key] = (corrupt, dig)
    assert cache.get(key, None) is None
    assert cache.stats()["digest_mismatches"] == 2
    cache.reset_stats()
    assert cache.stats()["digest_mismatches"] == 0 == cache.stats()["builds"]


def test_put_built_replaces_corrupted_entry():
    csr, _ = _mat(seed=23)
    other, _ = _mat(seed=24)
    cache = PlanCache(4)
    key = ("k",)
    first, fresh = plan(_port(csr), backend="torch"), plan(_port(csr),
                                                           backend="torch")
    cache.put_built(key, first)
    cache.put_built(key, fresh)
    assert cache.get(key) is first
    assert cache.stats()["digest_mismatches"] == 0
    with cache._lock:
        _, dig = cache._entries[key]
        cache._entries[key] = (plan(_port(other), backend="torch"), dig)
    cache.put_built(key, fresh)
    assert cache.get(key) is fresh
    assert cache.stats()["digest_mismatches"] == 1


def test_cache_integrity_off_skips_digests():
    csr, _ = _mat(seed=25)
    cache = PlanCache(4, integrity="off")
    cache.put(("k",), plan(_port(csr), backend="torch"))
    with cache._lock:
        assert cache._entries[("k",)][1] is None
    with pytest.raises(ValueError, match="integrity"):
        PlanCache(4, integrity="paranoid")
    # the facade's default cache and a cache built by hand publish, as the
    # reference's do (the serve engine's plan prep reads a published digest)
    assert api.DEFAULT_CACHE.integrity == "publish"
    assert PlanCache(4).integrity == "publish"


# ---------------------------------------------------------------------------
# the observability surface
# ---------------------------------------------------------------------------

def test_health_api_surface():
    G.HEALTH.bump("pattern_issues")
    G.HEALTH.breaker("hopper", "nb_pr")
    h = repro_torch.health()
    assert h["counters"]["pattern_issues"] == 1
    assert h["breakers"]["hopper:nb_pr"]["state"] == "closed"
    repro_torch.configure_guardrails(threshold=1, cooldown_s=0.0)
    assert G.HEALTH.breaker("hopper", "nb_pr").threshold == 1
    repro_torch.reset_health()
    assert api.health() == {"counters": {}, "breakers": {}}
    ref_names = {"PatternError", "NumericFault", "validate_csr", "inspect_csr",
                 "repair_csr", "plan_digest", "sentinel_scope", "grad_scope",
                 "inject_faults", "health", "reset_health",
                 "configure_guardrails", "FaultInjector", "FaultSpec",
                 "InjectedFault", "RetryPolicy", "TaskOutcome",
                 "run_with_retry", "PlanBuildError"}
    assert ref_names <= set(ref_api.__all__)
    assert ref_names <= set(api.__all__)
    assert all(hasattr(api, n) for n in ref_names)


def test_circuit_breaker_state_machine():
    t = [0.0]
    br = G.CircuitBreaker(threshold=2, cooldown_s=10.0, clock=lambda: t[0])
    assert br.allow()
    br.record_failure()
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "open" and br.trips == 1
    assert not br.allow()
    t[0] = 11.0
    assert br.allow() and br.state == "half_open"
    br.record_failure()
    assert br.state == "open" and br.trips == 2
    t[0] = 22.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.recoveries == 1 and br.failures == 0
