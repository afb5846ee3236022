"""Serving example: batched requests against a small MoE model whose expert
dispatch uses the paper's workload-balancing selection (sort-based row
binning vs one-hot, chosen by tokens-per-expert), plus topology-pinned
decoding: requests carrying a pinned expert topology decode through
dispatch plans cached per topology (``engine.plan_cache``) — repeated
routing patterns pay zero re-planning per tick; counterpart of the
reference's ``examples/serve_moe.py``.

The hardening half (DESIGN.md §11): the engine's SLO telemetry
(``engine.metrics()``) and fault tolerance — a deterministic injected
plan-build failure degrades the affected request to the prep-free fallback
path while resident lanes keep producing, visible in the counters.

    python -m repro_torch.examples.serve_moe                # on the card
    python -m repro_torch.examples.serve_moe --device cpu   # plain "torch"
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke
from repro_torch.core.registry import resolve_device
from repro_torch.models import Model
from repro_torch.serve import FaultInjector, FaultSpec, Request, ServeEngine

PROMPTS = [
    [1, 5, 9, 12],
    [3, 3, 7],
    [20, 21, 22, 23, 24],
    [11, 2],
    [8, 8, 8, 8],
]


def main(device=None) -> dict:
    """Serve the smoke OLMoE on ``device`` (``None``: the card, raising
    without one) three ways; returns the three engines' metrics."""
    dev = resolve_device(device)
    cfg = get_smoke("olmoe-1b-7b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServeEngine(model, params, slots=3, max_len=64)

    for i, p in enumerate(PROMPTS):
        engine.submit(Request(rid=i, prompt=p, max_new=8))
    done = engine.run_until_done()
    for r in done:
        print(f"req {r.rid}: prompt={r.prompt} → out={r.out} (done={r.done})")
    assert all(r.done for r in done)
    print(f"served {len(done)} requests in {engine.ticks} engine ticks "
          f"({len(PROMPTS)} reqs on 3 slots → continuous batching)")

    # --- topology-pinned decode: the offline-plan/online-execute split -----
    engine2 = ServeEngine(model, params, slots=3, max_len=64)
    for i, p in enumerate(PROMPTS):
        # pin each request to a (here: shared) expert pair; in production the
        # topology comes from prefill routing or a per-tenant profile
        engine2.submit(Request(rid=i, prompt=p, max_new=8, topology=(0, 3)))
    done2 = engine2.run_until_done()
    assert all(r.done for r in done2)
    s = engine2.plan_cache.stats()
    print(f"pinned decode: {engine2.ticks} ticks, dispatch plans built "
          f"{s['builds']}x, reused {s['hits']}x (topology-keyed PlanCache)")

    # --- SLO telemetry: what the engine measured about itself --------------
    m = engine2.metrics()
    t, lat = m["ticks"], m["latency"]
    print(f"telemetry: tick p50={t['p50_ms']:.2f}ms p99={t['p99_ms']:.2f}ms "
          f"occupancy={t['mean_occupancy']:.2f}  "
          f"ttft p50={lat['ttft_p50_ms']:.1f}ms "
          f"total p50={lat['total_p50_ms']:.1f}ms")
    engine.close()
    engine2.close()

    # --- fault tolerance: plan builds fail, serving does not ---------------
    faults = FaultInjector({"plan_build": FaultSpec(fail=10)}, seed=0)
    engine3 = ServeEngine(model, params, slots=3, max_len=64, faults=faults,
                          plan_timeout=0.5)
    for i, p in enumerate(PROMPTS):
        engine3.submit(Request(rid=i, prompt=p, max_new=8, topology=(0, 3)))
    done3 = engine3.run_until_done()
    assert all(r.done for r in done3)   # every request still completed
    m3 = engine3.metrics()
    c = m3["counters"]
    print(f"faulted run: all {len(done3)} requests done via fallback — "
          f"plan_build_failures={c.get('plan_build_failures', 0)} "
          f"plan_retries={c.get('plan_retries', 0)} "
          f"fallback_lanes={c.get('plan_fallback_lanes', 0)}")
    engine3.close()
    return {"plain": engine.metrics(), "pinned": m, "faulted": m3}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card)")
    main(ap.parse_args().device)
