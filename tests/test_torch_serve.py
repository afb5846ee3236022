"""The port's serving engine (``repro_torch.serve``) on the CPU, at the
``SMOKE`` configs of ``olmoe-1b-7b`` and ``llama3.2-1b`` (float32).

Every test of ``tests/test_serving_hardening.py`` runs here against the
port's engine, with the reference's weights carried across by
``interop.model_params_from_arrays``; beside them, the port's engine
against ``repro``'s on the same prompts: equal tokens, logits within 1e-4
(relative inf-norm error), the same ``plan_cache`` builds and the same
``metrics()`` keys, for plain, pinned and ``pin_topology=True`` runs.
The contract of ROADMAP §3: ``topologies_derived == 2`` with
``plan_cache.builds >= 1``, and with faults off the async engine decodes
tokens bit-identical to the synchronous one."""
import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke as ref_get_smoke
from repro.models import Model as RefModel
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.models import Model
from repro_torch.runtime.retry import RetryPolicy, run_with_retry
from repro_torch.serve import (FaultInjector, FaultSpec, InjectedFault, Request,
                               ServeEngine, percentile)
from repro_torch.serve.engine import _batch_axes, _slice_slot, _stack_slots

CPU = torch.device("cpu")
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair(name, **scaled):
    """(reference model, its params, port model, the same params)."""
    ref_cfg = ref_get_smoke(name).scaled(**scaled)
    cfg = get_smoke(name).scaled(**scaled)
    ref = RefModel(ref_cfg)
    ref_p = ref.init(jax.random.PRNGKey(0))
    model = Model(cfg)
    p = interop.model_params_from_arrays(
        cfg, jax.tree_util.tree_map(np.asarray, ref_p), device=CPU)
    return ref, ref_p, model, p


@pytest.fixture(scope="module")
def moe_model():
    _, _, model, p = _pair("olmoe-1b-7b")
    return model, p


@pytest.fixture(scope="module")
def llama_model():
    _, _, model, p = _pair("llama3.2-1b")
    return model, p


def _drain(eng, max_ticks=500):
    done = eng.run_until_done(max_ticks=max_ticks)
    eng.close()
    return done


def _greedy(model, params, prompt, n, max_len):
    """The single-request greedy oracle: ``prefill``, then ``decode_step``."""
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.tensor([prompt], dtype=torch.int32)},
            max_len)
        want = [int(torch.argmax(logits[0]))]
        while len(want) < n:
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[want[-1]]], dtype=torch.int32))
            want.append(int(torch.argmax(logits[0])))
    return want


# ---------------------------------------------------------------------------
# retry helper
# ---------------------------------------------------------------------------

def test_retry_policy_backoff_schedule():
    p = RetryPolicy(retries=4, backoff=0.1, factor=2.0, max_backoff=0.3)
    assert p.delay(1) == pytest.approx(0.1)
    assert p.delay(2) == pytest.approx(0.2)
    assert p.delay(3) == pytest.approx(0.3)      # capped
    assert p.delay(4) == pytest.approx(0.3)


def test_run_with_retry_recovers_and_reports():
    sleeps = []
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("transient")
        return "done"

    out = run_with_retry(flaky, RetryPolicy(retries=3, backoff=0.05),
                         sleep=sleeps.append)
    assert out.ok and out.value == "done" and out.attempts == 3
    assert sleeps == pytest.approx([0.05, 0.1])

    out = run_with_retry(lambda: 1 / 0, RetryPolicy(retries=1),
                         sleep=lambda _: None)
    assert out.status == "failed" and out.attempts == 2
    assert "ZeroDivisionError" in out.error


def test_run_with_retry_abort_stops_early():
    out = run_with_retry(lambda: 1 / 0, RetryPolicy(retries=50),
                         should_abort=lambda: True, sleep=lambda _: None)
    assert out.status == "failed" and out.attempts == 1
    assert "aborted" in out.error


# ---------------------------------------------------------------------------
# fault injector
# ---------------------------------------------------------------------------

def test_fault_injector_deterministic_schedule():
    spec = {"plan_build": FaultSpec(fail=2, p_fail=0.5)}
    a = FaultInjector(spec, seed=11)
    b = FaultInjector(spec, seed=11)
    sched_a = [a.fire("plan_build") for _ in range(32)]
    sched_b = [b.fire("plan_build") for _ in range(32)]
    assert sched_a == sched_b                      # replayable
    assert sched_a[:2] == [True, True]             # deterministic burst
    assert a.counts()["plan_build"] == sum(sched_a)
    assert not a.fire("nonexistent")
    with pytest.raises(InjectedFault):
        FaultInjector({"prefill": FaultSpec(fail=1)}).raise_if("prefill")


def test_fault_injector_perturbs_topology():
    fi = FaultInjector({"topology_drift": FaultSpec(fail=1)}, seed=0)
    assert fi.perturb_topology((0, 3), 8) == (1, 4)   # rotated, sorted
    assert fi.perturb_topology((0, 3), 8) == (0, 3)   # burst spent


# ---------------------------------------------------------------------------
# terminal request status (timeout / failed)
# ---------------------------------------------------------------------------

def test_run_until_done_marks_stragglers_timeout(llama_model):
    model, params = llama_model
    eng = ServeEngine(model, params, slots=1, max_len=32,
                      async_prefill=False, async_plans=False)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=2))    # finishes tick 1
    eng.submit(Request(rid=1, prompt=[3, 4], max_new=16))   # starves
    done = eng.run_until_done(max_ticks=3)
    by = {r.rid: r for r in done}
    assert by[0].done and by[0].status == "done"
    assert by[1].status == "timeout" and not by[1].done
    assert by[1].out
    m = eng.metrics()
    assert m["requests"] == {"done": 1, "timeout": 1}
    assert set(m["health"]) >= {"counters", "breaker_trips",
                                "breaker_recoveries", "open_breakers"}
    eng.close()


def test_oversized_prompt_rejected_others_served(llama_model):
    model, params = llama_model
    eng = ServeEngine(model, params, slots=2, max_len=16)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=3))
    eng.submit(Request(rid=1, prompt=list(range(40)), max_new=3))  # > max_len
    eng.submit(Request(rid=2, prompt=[], max_new=3))               # empty
    eng.submit(Request(rid=3, prompt=[4, 5], max_new=3))
    done = _drain(eng)
    by = {r.rid: r for r in done}
    assert by[1].status == "failed" and "exceeds max_len" in by[1].error
    assert by[2].status == "failed" and "empty" in by[2].error
    assert by[0].done and by[3].done


def test_prefill_fault_retries_then_succeeds(llama_model):
    model, params = llama_model
    fi = FaultInjector({"prefill": FaultSpec(fail=2)})
    eng = ServeEngine(model, params, slots=2, max_len=32, faults=fi,
                      prefill_retry=RetryPolicy(retries=3, backoff=0.01))
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new=3))
    done = _drain(eng)
    assert done[0].done and done[0].status == "done"
    m = eng.metrics()
    assert m["counters"]["prefill_retries"] == 2
    assert m["faults"]["prefill"] == 2
    assert done[0].metrics.prefill_attempts == 3


def test_prefill_fault_terminal_failure_keeps_serving(llama_model):
    model, params = llama_model
    fi = FaultInjector({"prefill": FaultSpec(fail=3)})
    eng = ServeEngine(model, params, slots=1, max_len=32, faults=fi,
                      prefill_retry=RetryPolicy(retries=2, backoff=0.01))
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=3))
    eng.submit(Request(rid=1, prompt=[3, 4], max_new=3))
    done = _drain(eng)
    by = {r.rid: r for r in done}
    assert by[0].status == "failed" and "InjectedFault" in by[0].error
    assert by[1].done
    m = eng.metrics()
    assert m["counters"]["prefill_failures"] == 1
    assert m["requests"] == {"failed": 1, "done": 1}


# ---------------------------------------------------------------------------
# async plan prep: fallback under failure, no resident stall, recovery
# ---------------------------------------------------------------------------

def _spin_until(eng, cond, ticks=300):
    for _ in range(ticks):
        if cond():
            return True
        eng.tick()
    return cond()


def test_plan_build_failure_degrades_newcomer_no_resident_stall(moe_model):
    model, params = moe_model
    fi = FaultInjector()                   # armed later, after warm-up
    eng = ServeEngine(model, params, slots=3, max_len=32, faults=fi,
                      plan_retry=RetryPolicy(retries=1, backoff=0.01))
    res = [Request(rid=i, prompt=[1 + i, 2, 3], max_new=30, topology=(0, 3))
           for i in range(2)]
    for r in res:
        eng.submit(r)
    assert _spin_until(eng, lambda: all(len(r.out) >= 2 for r in res))
    fi.specs["plan_build"] = FaultSpec(fail=10_000)
    newcomer = Request(rid=9, prompt=[7, 8], max_new=4, topology=(5, 7))
    eng.submit(newcomer)
    stalled = []
    for _ in range(400):
        if newcomer.done:
            break
        before = [len(r.out) for r in res]
        eng.tick()
        after = [len(r.out) for r in res]
        stalled += [1 for b, a, r in zip(before, after, res)
                    if not r.done and a != b + 1]
    assert not stalled, "a resident lane stalled during the failing build"
    assert newcomer.done and newcomer.status == "done"
    assert newcomer.metrics.fallback_ticks >= 1
    m = eng.metrics()
    assert m["counters"]["plan_build_failures"] >= 1
    assert m["counters"]["plan_retries"] >= 1
    assert m["counters"]["plan_fallback_lanes"] >= 1
    assert m["faults"]["plan_build"] >= 2
    assert m["plan_cache"]["builds"] >= 1
    _drain(eng)


def test_plan_build_retries_recover_within_budget(moe_model):
    model, params = moe_model
    fi = FaultInjector({"plan_build": FaultSpec(fail=2)})
    eng = ServeEngine(model, params, slots=2, max_len=32, faults=fi,
                      plan_retry=RetryPolicy(retries=3, backoff=0.01))
    reqs = [Request(rid=i, prompt=[2 + i, 3], max_new=4, topology=(1, 2))
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    done = _drain(eng)
    assert all(r.done for r in done)
    m = eng.metrics()
    assert m["counters"]["plan_retries"] == 2
    assert m["counters"].get("plan_build_failures", 0) == 0
    assert m["counters"].get("plan_fallback_lanes", 0) == 0
    assert m["plan_cache"]["builds"] == 1
    assert all(r.metrics.fallback_ticks == 0 for r in done)


def test_plan_build_delay_times_out_and_degrades(moe_model):
    model, params = moe_model
    fi = FaultInjector({"plan_build": FaultSpec(delay=1.0, delay_times=1)})
    eng = ServeEngine(model, params, slots=2, max_len=32, faults=fi,
                      plan_timeout=0.05,
                      plan_retry=RetryPolicy(retries=0))
    req = Request(rid=0, prompt=[1, 2, 3], max_new=4, topology=(0, 3))
    eng.submit(req)
    done = _drain(eng)
    assert done[0].done
    m = eng.metrics()
    assert m["counters"]["plan_timeouts"] == 1
    assert m["counters"]["plan_fallback_lanes"] == 1
    assert done[0].metrics.fallback_ticks >= 1
    assert m["plan_cache"]["builds"] == 0  # the late artifact was discarded


def test_plan_wait_blocks_on_the_build_in_flight(moe_model):
    """Three derived topologies on two slots: the first batch plan finishes
    while its group changes (a newcomer's topology joins), so a finished,
    unpolled build sits among the pending ones.  ``PlanPrep.wait`` must
    block on the build still in flight — counting the finished one returns
    at once and the holding tick loop spins through ``max_ticks`` while the
    build it waits for starves (the reference engine does, on this input)."""
    model, params = moe_model
    eng = ServeEngine(model, params, slots=2, max_len=32, pin_topology=True)
    for rid, prompt in enumerate([[1, 2, 3], [4, 5], [6, 7, 8]]):
        eng.submit(Request(rid=rid, prompt=prompt, max_new=5))
    done = _drain(eng, max_ticks=400)
    assert all(r.done for r in done), [(r.rid, r.status, r.out) for r in done]
    m = eng.metrics()
    assert m["counters"]["topologies_derived"] == 3
    assert m["plan_cache"]["builds"] >= 1


# ---------------------------------------------------------------------------
# bit-identity with faults off
# ---------------------------------------------------------------------------

def _serve(model, params, reqs, engine=ServeEngine, request=Request, **kw):
    eng = engine(model, params, slots=2, max_len=32, **kw)
    for rid, prompt, topo in reqs:
        eng.submit(request(rid=rid, prompt=list(prompt), max_new=5,
                           topology=topo))
    done = _drain(eng)
    assert all(r.done for r in done)
    return {r.rid: list(r.out) for r in done}


def test_async_engine_bit_identical_to_sync(moe_model, llama_model):
    for model, params, topo in [(*moe_model, (0, 3)), (*llama_model, None)]:
        reqs = [(0, [1, 2, 3], topo), (1, [4, 5], topo), (2, [6, 7, 8], topo)]
        sync = _serve(model, params, reqs,
                      async_prefill=False, async_plans=False)
        asyn = _serve(model, params, reqs)     # hardened defaults
        assert asyn == sync, (asyn, sync)


# ---------------------------------------------------------------------------
# mid-stream slot churn
# ---------------------------------------------------------------------------

def test_slot_churn_no_stale_kv(llama_model):
    model, params = llama_model
    eng = ServeEngine(model, params, slots=2, max_len=32,
                      async_prefill=False, async_plans=False)
    prompts = [[1, 2, 3, 4], [5, 6], [7, 8, 9], [1, 9, 8], [2, 2, 2, 2]]
    new = [3, 6, 4, 5, 3]                  # staggered finishes → churn
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(Request(rid=i, prompt=p, max_new=n))
    done = _drain(eng)
    assert all(r.done for r in done)
    for req, prompt in zip(done, prompts):
        want = _greedy(model, params, prompt, req.max_new, 32)
        assert req.out == want, (req.rid, req.out, want)


def test_slot_churn_pins_plan_and_step_counters(moe_model):
    model, params = moe_model
    eng = ServeEngine(model, params, slots=2, max_len=32,
                      async_prefill=False, async_plans=False)
    new = [3, 5, 4, 6]
    for i, n in enumerate(new):
        eng.submit(Request(rid=i, prompt=[1 + i, 2], max_new=n,
                           topology=(0, 3)))
    done = _drain(eng)
    assert all(r.done for r in done)
    s = eng.plan_cache.stats()
    assert s["builds"] == 1, s
    assert len(eng._decode_pinned) == 1    # one pinned step across churn
    assert s["hits"] == eng.ticks - 1      # every later tick reused the plan


# ---------------------------------------------------------------------------
# derived topology pinning + drift fallback
# ---------------------------------------------------------------------------

def test_prefill_routing_derives_pinned_topology(moe_model):
    model, params = moe_model
    eng = ServeEngine(model, params, slots=2, max_len=32, pin_topology=True)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=[1 + i, 2, 3, 4], max_new=4))
    done = _drain(eng)
    k = model.cfg.moe.top_k
    assert all(r.done for r in done)
    for r in done:
        assert r.topology is not None and len(r.topology) == k
        assert list(r.topology) == sorted(r.topology)
    m = eng.metrics()
    assert m["counters"]["topologies_derived"] == 2
    assert m["plan_cache"]["builds"] >= 1  # pinned decode actually planned


def test_injected_drift_unpins_back_to_router(moe_model):
    model, params = moe_model
    fi = FaultInjector({"topology_drift": FaultSpec(fail=99)}, seed=3)
    eng = ServeEngine(model, params, slots=2, max_len=32,
                      drift_patience=1, faults=fi)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=[5 + i, 6, 7], max_new=6,
                           topology=(0, 3)))
    done = _drain(eng)
    assert all(r.done for r in done)
    m = eng.metrics()
    assert m["counters"]["topologies_perturbed"] == 2
    assert m["counters"]["drift_unpins"] >= 1
    assert any(r.topology is None for r in done)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_percentile_nearest_rank():
    assert percentile([], 50) == 0.0
    assert percentile([3.0], 99) == 3.0
    xs = list(range(1, 101))
    assert percentile(xs, 50) == pytest.approx(50, abs=1)
    assert percentile(xs, 99) == pytest.approx(99, abs=1)


def test_engine_metrics_shape_and_slo_fields(llama_model):
    model, params = llama_model
    eng = ServeEngine(model, params, slots=2, max_len=32)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=[1 + i, 2], max_new=3))
    done = _drain(eng)
    m = eng.metrics()
    assert m["requests"]["done"] == 3
    assert m["ticks"]["count"] == eng.ticks
    assert m["ticks"]["p99_ms"] >= m["ticks"]["p50_ms"] >= 0
    for field in ("ttft_p50_ms", "ttft_p99_ms", "queue_p50_ms",
                  "decode_p50_ms", "total_p50_ms", "total_p99_ms"):
        assert m["latency"][field] >= 0.0
    assert m["latency"]["ttft_p50_ms"] > 0.0
    assert m["plan_cache"]["builds"] == 0  # no MoE, no attention plans
    assert m["faults"] == {}
    for r in done:
        rm = r.metrics
        assert rm.ttft_s is not None and rm.total_s is not None
        assert rm.total_s >= rm.ttft_s >= rm.queue_s >= 0.0
        assert rm.decode_ticks == len(r.out) - 1


def test_health_rides_the_metrics_with_hopper_breaker_keys(llama_model):
    """``metrics()["health"]`` is ``health_summary`` of the port's
    guardrails registry: its breaker keys name the port's backends."""
    from repro_torch.core.guardrails import HEALTH
    from repro_torch.serve import health_summary
    model, params = llama_model
    HEALTH.reset()
    try:
        HEALTH.breaker("hopper", "nb_pr").record_failure()
        eng = ServeEngine(model, params, slots=1, max_len=16)
        eng.submit(Request(rid=0, prompt=[1, 2], max_new=2))
        _drain(eng)
        h = eng.metrics()["health"]
        assert h == health_summary(HEALTH.snapshot())
        assert set(h["breakers"]) == {"hopper:nb_pr"}
        assert h["breakers"]["hopper:nb_pr"]["failures"] == 1
    finally:
        HEALTH.reset()


# ---------------------------------------------------------------------------
# parity with the reference engine
# ---------------------------------------------------------------------------

def _spied(engine_cls, model, params, reqs, **kw):
    """Serve ``reqs`` (rid, prompt, topology, max_new) on a synchronous
    engine of ``engine_cls``, recording every prefill's and decode's logits
    in call order.  Returns (tokens by rid, logits, metrics)."""
    request = Request if engine_cls is ServeEngine else RefRequest
    eng = engine_cls(model, params, slots=2, max_len=32,
                     async_prefill=False, async_plans=False, **kw)
    seen = []

    def record(fn):
        def call(*args):
            logits, cache = fn(*args)
            seen.append(np.asarray(logits if isinstance(logits, jax.Array)
                                   else logits.detach().numpy()))
            return logits, cache
        return call

    eng._prefill = record(eng._prefill)
    eng._decode = record(eng._decode)
    pinned = eng._pinned_decode
    eng._pinned_decode = lambda topo: record(pinned(topo))
    for rid, prompt, topo, n in reqs:
        eng.submit(request(rid=rid, prompt=list(prompt), max_new=n,
                           topology=topo))
    done = _drain(eng)
    assert all(r.done for r in done)
    return {r.rid: list(r.out) for r in done}, seen, eng.metrics()


def _keys(tree):
    """The nested key structure of a metrics dict (leaves dropped)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


PARITY_CASES = {
    "llama-plain": ("llama3.2-1b", None, {}),
    "olmoe-plain": ("olmoe-1b-7b", None, {}),
    "olmoe-pinned": ("olmoe-1b-7b", (0, 3), {}),
    "olmoe-pin_topology": ("olmoe-1b-7b", None, dict(pin_topology=True)),
    "olmoe-drift": ("olmoe-1b-7b", (0, 3), dict(drift_patience=2)),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_engine_matches_reference_engine(case):
    name, topo, kw = PARITY_CASES[case]
    ref, ref_p, model, p = _pair(name)
    reqs = [(0, [1, 2, 3, 4], topo, 5), (1, [5, 6], topo, 4),
            (2, [7, 8, 9], topo, 6)]
    ref_out, ref_logits, ref_m = _spied(RefServeEngine, ref, ref_p, reqs, **kw)
    out, logits, m = _spied(ServeEngine, model, p, reqs, **kw)
    assert out == ref_out
    assert len(logits) == len(ref_logits)
    for got, want in zip(logits, ref_logits):
        assert got.shape == want.shape
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < TOL, rel
    assert m["plan_cache"]["builds"] == ref_m["plan_cache"]["builds"]
    assert m["plan_cache"]["hits"] == ref_m["plan_cache"]["hits"]
    assert m["counters"] == ref_m["counters"]
    assert m["requests"] == ref_m["requests"]
    assert _keys({k: v for k, v in m.items() if k != "health"}) == \
        _keys({k: v for k, v in ref_m.items() if k != "health"})
    assert set(m["health"]) == set(ref_m["health"])


@pytest.mark.parametrize("case", ["olmoe-pinned", "olmoe-pin_topology",
                                  "llama-plain"])
def test_async_engine_matches_reference_engine(case):
    """The port's hardened defaults (async prefill and plans) decode the
    tokens of the reference's synchronous engine, and the reference's
    contract holds.  (The reference's own async engine is no oracle here:
    with a derived topology it can starve its plan build, see
    ``test_plan_wait_blocks_on_the_build_in_flight``.)"""
    name, topo, kw = PARITY_CASES[case]
    ref, ref_p, model, p = _pair(name)
    reqs = [(0, [1, 2, 3, 4], topo), (1, [2, 2, 3, 4], topo)]
    ref_out = _serve(ref, ref_p, reqs, engine=RefServeEngine,
                     request=RefRequest, async_prefill=False,
                     async_plans=False, **kw)
    eng = ServeEngine(model, p, slots=2, max_len=32, **kw)
    for rid, prompt, t in reqs:
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new=5,
                           topology=t))
    done = _drain(eng)
    assert {r.rid: list(r.out) for r in done} == ref_out
    if kw.get("pin_topology"):
        m = eng.metrics()
        assert m["counters"]["topologies_derived"] == 2
        assert m["plan_cache"]["builds"] >= 1


def test_long_context_engine_matches_reference_builds():
    """A ``block_sparse`` llama: the engine's cache holds one attention plan
    a prompt length in both packages; the tokens are equal.  The reference
    looks a plan up once a trace and the port once a layer call, so the
    port's hits are a lower bound."""
    kw = dict(attn_pattern="block_sparse", window=16, attn_block=8)
    ref, ref_p, model, p = _pair("llama3.2-1b", **kw)
    prompts = [[(7 * i + j) % 256 for j in range(24)] for i in range(3)]
    prompts.append([(3 * j + 1) % 256 for j in range(40)])
    reqs = [(i, pr, None) for i, pr in enumerate(prompts)]
    out, stats = {}, {}
    for label, (eng_cls, req_cls, m_, p_) in {
            "ref": (RefServeEngine, RefRequest, ref, ref_p),
            "port": (ServeEngine, Request, model, p)}.items():
        eng = eng_cls(m_, p_, slots=2, max_len=64)
        for rid, prompt, _ in reqs:
            eng.submit(req_cls(rid=rid, prompt=prompt, max_new=4))
        done = _drain(eng)
        assert all(r.done for r in done)
        out[label] = {r.rid: list(r.out) for r in done}
        stats[label] = eng.plan_cache.stats()
    assert out["port"] == out["ref"]
    assert stats["port"]["builds"] == stats["ref"]["builds"] == 2
    assert stats["port"]["hits"] >= stats["ref"]["hits"]
    assert stats["port"]["hits"] == len(prompts) * model.cfg.num_layers - 2


@pytest.mark.parametrize("scope", ["hopper", "torch"])
def test_prefill_worker_keeps_the_submitters_backend(scope, monkeypatch):
    """Thread-local scopes do not follow a call onto a pool thread: the
    async prefill re-enters the ``use_backend`` scope active at submit.  On
    the CPU the ``"hopper"`` wrappers run their plain versions, so the
    attention plans the prefills build on the worker name the backend that
    ran; under ``"torch"`` not one is ``"hopper"``."""
    import threading

    import repro_torch
    from repro_torch.core import registry
    _, _, model, p = _pair("llama3.2-1b", attn_pattern="block_sparse",
                           window=16, attn_block=8)
    seen = []
    prefill = model.prefill

    def spy(*args):
        seen.append((threading.current_thread().name,
                     registry.scoped_backend()))
        return prefill(*args)

    monkeypatch.setattr(model, "prefill", spy)
    eng = ServeEngine(model, p, slots=2, max_len=64)
    with repro_torch.use_backend(scope):
        for rid in range(2):
            eng.submit(Request(rid=rid, prompt=list(range(1 + rid, 11 + rid)),
                               max_new=3))
    done = _drain(eng)                     # the ticks run outside the scope
    assert all(r.done for r in done)
    assert len(seen) == 2
    assert all(name.startswith("prefill") and b == scope for name, b in seen)
    backends = {key[3] for key in eng.plan_cache._entries}
    assert backends == {scope}


# ---------------------------------------------------------------------------
# the engine's slot helpers
# ---------------------------------------------------------------------------

def test_slot_helpers_stack_and_slice_caches(llama_model):
    """Cache skeletons on the meta device give the reference's axes;
    stacking per-slot caches and slicing one back is the identity, with the
    0-d lengths stacked into a ``(slots,)`` vector."""
    model, params = llama_model
    axes = _batch_axes(model.init_cache(1, 16, device="meta"),
                       model.init_cache(2, 16, device="meta"))
    ref_model = _pair("llama3.2-1b")[0]
    ref_axes = _batch_axes(jax.eval_shape(lambda: ref_model.init_cache(1, 16)),
                           jax.eval_shape(lambda: ref_model.init_cache(2, 16)))
    assert axes == ref_axes == {"kv": {"k": 1, "v": 1}, "length": -1}
    caches = []
    for i in range(3):
        _, c = model.prefill(params, {"tokens": torch.tensor(
            [[1 + i] * (2 + i)], dtype=torch.int32)}, 16)
        caches.append(c)
    batched = _stack_slots(caches, axes)
    assert batched["length"].tolist() == [2, 3, 4]
    assert batched["kv"]["k"].shape[1] == 3
    for i, c in enumerate(caches):
        back = _slice_slot(batched, axes, i)
        assert back["length"].ndim == 0 and int(back["length"]) == 2 + i
        assert torch.equal(back["kv"]["k"], c["kv"]["k"])
        assert torch.equal(back["kv"]["v"], c["kv"]["v"])


def test_default_cache_publishes_as_the_reference():
    """The facade's default plan cache digests on publish, as ``repro``'s."""
    import repro.api as ref_api
    import repro_torch.api as api
    assert api.DEFAULT_CACHE.integrity == ref_api.DEFAULT_CACHE.integrity \
        == "publish"
