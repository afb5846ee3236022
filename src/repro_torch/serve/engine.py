"""Hardened serving engine: continuous batching, async plan prep with
retry/fallback, deterministic fault injection, and SLO telemetry;
counterpart of ``repro.serve.engine``.

Scheduling model (DESIGN.md §11): a fixed pool of ``slots`` decode lanes
share one KV cache.  **Continuous batching** — a free slot is reserved the
moment a queued request starts prefilling, prefill runs on a bounded
background worker pool (``async_prefill``), and completed prefills install
into their slot at the top of any tick, so a long prompt never freezes
resident decode lanes and an evicted slot refills mid-stream.  Every tick
runs batched decode at the *fixed* shape of ``slots`` lanes: live lanes pad
to ``slots`` by cycling, and a ``(slots,)`` ``length`` vector masks each
lane to its own request, so admit/evict churn never changes a shape.

MoE plan prep (the offline/online split applied to serving): a request may
carry — or, with ``pin_topology=True``, derive from its own prefill routing
— a pinned expert ``topology`` (its top-k expert ids).  Pinned lanes decode
through pre-planned dispatch/combine ``PlanArtifact``s (K1 on the card)
fetched from a topology-keyed ``PlanCache``.  With ``async_plans`` the
artifacts for a new batch topology build on a background executor (bounded
retry with exponential backoff, per-build timeout, ``serve/faults.py``
injection points) and publish via ``PlanCache.put_built`` — the
double-buffered swap: lanes already *promoted* into a planned group keep
decoding under their cached batch plan while the expanded plan builds;
newly pinned lanes hold (``wait_ticks``) until their plan is ready, and
**degrade permanently to the prep-free router-driven fallback path** if the
build fails its retries or exceeds ``plan_timeout``.  A tick may therefore
issue two decode calls: one for the promoted pinned group and one for the
fallback group (each padded to ``slots``).

Topology drift (``drift_patience > 0``): the pinned decode step reports a
pinned-vs-router match fraction per lane (``models.moe.drift_scope``);
``drift_patience`` consecutive mismatched ticks unpin the lane back to
router-driven decode.

Where the reference compiles, the port runs eagerly under
``torch.no_grad()``: the prefill, the decode step and each pinned step (the
LRU table of 32 closures over a batch topology's artifacts) are plain
calls, and the router hands its observations to the ``RoutingSink`` as host
copies when it makes them, so no effects barrier is needed.  Every tensor
the engine makes lies on the device of ``params``.  Thread-local scopes do
not follow a call onto a worker: a prefill re-enters the ``use_backend``
and sentinel scopes that were active when its request was submitted, and
opens the attention plan-cache scope and the routing capture inside the
body that runs on the worker.

Telemetry: ``engine.metrics()`` reports per-request queue/prefill/decode/
total latency and TTFT percentiles, retry/fallback/hold counters, tick
latency and occupancy, the ``plan_cache`` counters, fault-injection fire
counts and the guardrails' health (``serve/metrics.py``).

``async_prefill=False, async_plans=False`` is the tick-synchronous engine:
with faults off the async engine decodes the same token sequences, merely
shifted in time.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import guardrails, registry
from ..core.cache import PlanCache
from ..runtime.retry import RetryPolicy, TaskOutcome, run_with_retry
from .faults import FaultInjector
from .metrics import EngineMetrics, RequestMetrics


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    eos: int = -1
    #: pinned expert topology (top-k expert ids) for MoE decode; lanes with a
    #: topology decode through cached dispatch plans, packed by key.  With
    #: ``pin_topology=True`` the engine fills this from prefill routing.
    topology: Optional[tuple] = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: lifecycle: queued → prefill → active → one of done / failed / timeout.
    #: ``done`` (the bool) stays the "completed normally" flag; ``status``
    #: makes starved (timeout) and rejected/errored (failed) requests
    #: distinguishable from finished ones.
    status: str = "queued"
    error: Optional[str] = None
    metrics: RequestMetrics = dataclasses.field(default_factory=RequestMetrics)


def _batch_axes(c1, c2):
    """Structural diff of two cache skeletons (batch=1 vs batch=2): the axis
    whose extent tracks the prefill batch is where slots stack; extent-
    invariant leaves (the ``length`` scalar) are per-slot values that stack
    into a leading vector (marked -1)."""
    if isinstance(c1, dict):
        return {k: _batch_axes(c1[k], c2[k]) for k in c1}
    for i, (a, b) in enumerate(zip(c1.shape, c2.shape)):
        if a != b:
            return i
    return -1


def _stack_slots(caches, axes):
    if isinstance(axes, dict):
        # keys absent from the skeleton (e.g. audio "memory", added by
        # prefill) batch on their leading axis
        return {k: _stack_slots([c[k] for c in caches], axes.get(k, 0))
                for k in caches[0]}
    if axes < 0:
        return torch.stack([torch.as_tensor(c) for c in caches])
    return torch.cat(caches, dim=axes)


def _slice_slot(cache, axes, i):
    if isinstance(axes, dict):
        return {k: _slice_slot(v, axes.get(k, 0), i) for k, v in cache.items()}
    if axes < 0:
        return cache[i]
    return cache.narrow(axes, i, 1)


def _params_device(params) -> torch.device:
    """The device of the first tensor of ``params``."""
    for leaf in pytree.tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("params hold no tensor")


class PlanPrep:
    """Background dispatch-plan builder: bounded executor, bounded retry
    with backoff, tick-side timeout, publish-on-poll into the ``PlanCache``.

    The tick thread calls ``request(key, kwargs)`` to schedule and
    ``poll(key)`` to learn ``ready | building | failed``.  Workers build
    *outside* the cache lock (``get_or_build`` holds it for the build's
    duration) and the poller swaps the finished artifact in atomically via
    ``put_built`` — the double-buffer.  A build that exceeds ``timeout`` is
    abandoned (threads can't be killed: the abort flag stops its remaining
    retries and its late result is discarded) and the key marked failed;
    failed keys stay failed — the engine degrades their lanes to the
    fallback path, and recovery-within-a-build is what the retry loop is
    for.  The build kwargs carry the backend and device resolved on the
    tick thread, so a worker needs none of its scopes."""

    def __init__(self, cache: PlanCache, *, workers: int = 2,
                 policy: RetryPolicy | None = None,
                 timeout: float | None = 5.0,
                 faults: FaultInjector | None = None,
                 metrics: EngineMetrics | None = None):
        self._cache = cache
        self._workers = workers
        self._policy = policy if policy is not None else RetryPolicy()
        self._timeout = timeout
        self._faults = faults
        self._metrics = metrics
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        #: key -> (future, outcome, t0, abort flag)
        self._pending: dict = {}
        self._failed: dict = {}

    def request(self, key, build_kwargs) -> None:
        if key in self._cache or key in self._pending or key in self._failed:
            return
        self._cache.get(key)        # count the miss that scheduled this build
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                self._workers, thread_name_prefix="plan-prep")
        outcome = TaskOutcome()
        abort = threading.Event()
        faults, metrics = self._faults, self._metrics

        def attempt():
            if faults is not None:
                faults.raise_if("plan_build")
            from ..models import moe as moe_mod
            return moe_mod.build_dispatch_plans(**build_kwargs)

        def on_retry(_n, _e):
            if metrics is not None:
                metrics.bump("plan_retries")

        fut = self._pool.submit(run_with_retry, attempt, self._policy,
                                outcome=outcome, should_abort=abort.is_set,
                                on_retry=on_retry)
        self._pending[key] = (fut, outcome, time.monotonic(), abort)

    def poll(self, key) -> str:
        """``ready`` | ``building`` | ``failed`` | ``absent`` (never asked)."""
        if key in self._cache:
            return "ready"
        ent = self._pending.get(key)
        if ent is None:
            return "failed" if key in self._failed else "absent"
        fut, outcome, t0, abort = ent
        if fut.done():
            del self._pending[key]
            if outcome.ok:
                self._cache.put_built(key, outcome.value)
                return "ready"
            self._failed[key] = outcome.error
            if self._metrics is not None:
                self._metrics.bump("plan_build_failures")
            return "failed"
        if self._timeout is not None and time.monotonic() - t0 > self._timeout:
            abort.set()
            del self._pending[key]
            self._failed[key] = f"plan build exceeded {self._timeout}s"
            if self._metrics is not None:
                self._metrics.bump("plan_timeouts")
            return "failed"
        return "building"

    def error(self, key) -> Optional[str]:
        return self._failed.get(key)

    def wait(self, timeout: float = 0.05) -> None:
        """Block briefly on any in-flight build (the engine calls this when a
        tick decoded nothing — spinning would burn ``max_ticks`` in
        microseconds while a build runs).  A finished build whose key no
        tick polls any more (the group it was asked for changed) is not in
        flight: counting it, as the reference does, returns at once, and
        the tick loop spins with the GIL while the build it waits for
        starves."""
        futs = [f for f, _, _, _ in self._pending.values() if not f.done()]
        if futs:
            concurrent.futures.wait(
                futs, timeout=timeout,
                return_when=concurrent.futures.FIRST_COMPLETED)

    def close(self) -> None:
        for _, _, _, abort in self._pending.values():
            abort.set()
        if self._pool is not None:
            self._pool.shutdown(wait=False)


class ServeEngine:
    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 plan_cache: Optional[PlanCache] = None,
                 async_prefill: bool = True, async_plans: bool = True,
                 prefill_workers: int = 2, plan_workers: int = 2,
                 prefill_retry: RetryPolicy | None = None,
                 plan_retry: RetryPolicy | None = None,
                 plan_timeout: float | None = 5.0,
                 pin_topology: bool = False, drift_patience: int = 0,
                 faults: FaultInjector | None = None):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.async_prefill = async_prefill
        self.async_plans = async_plans
        self.faults = faults
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * slots
        self.metrics_agg = EngineMetrics()
        self._device = _params_device(params)
        self._moe_cfg = getattr(getattr(model, "cfg", None), "moe", None)
        self._pin = bool(pin_topology) and self._moe_cfg is not None
        self.drift_patience = int(drift_patience)
        self._drift_on = self.drift_patience > 0 and self._moe_cfg is not None
        self._sink = None
        if self._pin or self._drift_on:
            from ..models import moe as moe_mod
            self._sink = moe_mod.RoutingSink()

        if getattr(getattr(model, "cfg", None), "attn_pattern", "") == "block_sparse":
            # long-context prefill runs block-sparse attention (DESIGN.md
            # §10): scope the attention plan builds into THIS engine's cache
            # so mask reuse across layers/requests shows up in its counters
            from ..attention import scoped_plan_cache
            attn_scope = lambda: scoped_plan_cache(self.plan_cache)
        else:
            attn_scope = contextlib.nullcontext
        if self._pin:
            from ..models import moe as moe_mod

            # the routing capture sits inside the body that runs on the
            # prefill worker: its scope is thread-local
            def routing(tag):
                return moe_mod.record_routing(self._sink, tag)
        else:
            def routing(tag):
                return contextlib.nullcontext()

        def _prefill(p, b, tag, scopes=(None, None)):
            backend, sentinel = scopes
            with torch.no_grad(), registry.backend_scope(backend), \
                    guardrails.sentinel_scope(sentinel), attn_scope(), \
                    routing(tag):
                return model.prefill(p, b, max_len)
        self._prefill = _prefill

        def _decode(p, caches, toks):
            with torch.no_grad():
                return model.decode_step(p, caches, toks)
        self._decode = _decode
        self._caches: list = [None] * slots
        # cache skeletons on the meta device: shapes only, no memory
        self._axes = _batch_axes(model.init_cache(1, max_len, device="meta"),
                                 model.init_cache(2, max_len, device="meta"))
        self.ticks = 0
        self._all: list[Request] = []
        #: the (backend, sentinel) scopes active at each submit, by request
        #: identity, re-entered by its prefill on the worker
        self._scopes: dict = {}
        #: topology-keyed store of MoE dispatch plans (and anything else the
        #: engine pre-plans); counters expose reuse per decode tick
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache(64)
        self._decode_pinned: OrderedDict = OrderedDict()
        self._prefill_policy = (prefill_retry if prefill_retry is not None
                                else RetryPolicy())
        self._prefill_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._prefill_workers = prefill_workers
        #: slot -> (future, request, outcome) for in-flight prefills
        self._prefills: dict = {}
        self.prep = PlanPrep(self.plan_cache, workers=plan_workers,
                             policy=plan_retry, timeout=plan_timeout,
                             faults=faults, metrics=self.metrics_agg)
        #: rids currently decodable as one planned pinned group (their padded
        #: batch topology has a cached plan — the promotion invariant)
        self._promoted: set[int] = set()
        #: rids permanently degraded to the fallback path (terminal plan
        #: build failure or timeout)
        self._degraded: set[int] = set()
        self._strikes: dict[int, int] = {}

    # -------------------------------------------------- MoE topology packing
    def _lane_topo(self, req: Request) -> tuple:
        return tuple(int(i) for i in req.topology)

    def _batch_topo(self, lanes) -> tuple:
        padded = [lanes[i % len(lanes)] for i in range(self.slots)]
        return tuple(self._lane_topo(r) for _, r in padded)

    def _plan_spec(self, batch_topo: tuple):
        from ..models import moe as moe_mod
        return moe_mod.dispatch_plan_spec(
            batch_topo, self._moe_cfg,
            n_hint=getattr(self.model.cfg, "d_model", None),
            device=self._device)

    def _pinned_decode(self, batch_topo: tuple):
        """The decode step for one batch topology: fetch the cached
        dispatch plans (every tick — reuse is what the counters measure) and
        make at most one closure per distinct topology over the artifacts."""
        from ..models import moe as moe_mod

        plans = moe_mod.dispatch_plans(
            batch_topo, self._moe_cfg, cache=self.plan_cache,
            n_hint=getattr(self.model.cfg, "d_model", None),
            device=self._device)
        fn = self._decode_pinned.get(batch_topo)
        if fn is None:
            # a fresh scope a call: a context manager enters once
            drift = ((lambda: moe_mod.drift_scope(self._sink))
                     if self._drift_on else contextlib.nullcontext)

            def step(params, caches, toks, _plans=plans, _drift=drift):
                with torch.no_grad(), moe_mod.pinned_dispatch(_plans), \
                        _drift():
                    return self.model.decode_step(params, caches, toks)

            fn = step
            self._decode_pinned[batch_topo] = fn
            while len(self._decode_pinned) > 32:   # LRU-bound the table:
                self._decode_pinned.popitem(last=False)   # drop coldest only
        else:
            self._decode_pinned.move_to_end(batch_topo)
        return fn

    # ------------------------------------------------------------- admission
    def submit(self, req: Request):
        req.metrics.submitted = time.monotonic()
        self._scopes[id(req)] = (registry.scoped_backend(),
                                 guardrails.active_sentinel())
        self.queue.append(req)
        self._all.append(req)

    def _finish(self, req: Request, status: str):
        req.status = status
        req.done = status == "done"
        self._scopes.pop(id(req), None)
        self.metrics_agg.finish_request(status, req.metrics)

    def _reject(self, req: Request, why: str):
        req.error = why
        self.metrics_agg.bump("rejected")
        self._finish(req, "failed")

    def _prefill_attempt(self, req: Request):
        rm = req.metrics
        if rm.prefill_start is None:
            rm.prefill_start = time.monotonic()
        rm.prefill_attempts += 1
        if self.faults is not None:
            self.faults.raise_if("prefill")
        batch = {"tokens": torch.tensor([req.prompt], dtype=torch.int32,
                                        device=self._device)}
        logits, cache = self._prefill(self.params, batch, req.rid,
                                      self._scopes.get(id(req), (None, None)))
        tok = int(torch.argmax(logits[0]))
        captured = self._sink.drain_routing(req.rid) if self._pin else None
        return tok, cache, captured

    def _launch(self, slot: int, req: Request):
        req.status = "prefill"
        if self.async_prefill:
            if self._prefill_pool is None:
                self._prefill_pool = concurrent.futures.ThreadPoolExecutor(
                    self._prefill_workers, thread_name_prefix="prefill")
            outcome = TaskOutcome()
            fut = self._prefill_pool.submit(
                run_with_retry, lambda: self._prefill_attempt(req),
                self._prefill_policy, outcome=outcome)
            self._prefills[slot] = (fut, req, outcome)
        else:
            outcome = run_with_retry(lambda: self._prefill_attempt(req),
                                     self._prefill_policy)
            self._install(slot, req, outcome)

    def _install(self, slot: int, req: Request, outcome: TaskOutcome):
        self.metrics_agg.bump("prefill_retries", outcome.attempts - 1)
        if not outcome.ok:
            # a failed prefill rejects the one request and frees the slot —
            # the rest of the batch keeps serving
            req.error = outcome.error
            self.metrics_agg.bump("prefill_failures")
            self._finish(req, "failed")
            return
        tok, cache, captured = outcome.value
        req.out.append(tok)
        req.metrics.first_token = time.monotonic()
        if self._moe_cfg is not None:
            if req.topology is None and captured:
                from ..models import moe as moe_mod
                req.topology = moe_mod.dominant_topology(
                    captured, self._moe_cfg.num_experts, self._moe_cfg.top_k)
                if req.topology is not None:
                    self.metrics_agg.bump("topologies_derived")
            if self.faults is not None and req.topology is not None:
                drifted = self.faults.perturb_topology(
                    req.topology, self._moe_cfg.num_experts)
                if drifted != tuple(req.topology):
                    self.metrics_agg.bump("topologies_perturbed")
                req.topology = drifted
        req.status = "active"
        self.active[slot] = req
        self._caches[slot] = cache

    def _poll_prefills(self):
        for slot in list(self._prefills):
            fut, req, outcome = self._prefills[slot]
            if fut.done():
                del self._prefills[slot]
                self._install(slot, req, outcome)

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is not None or slot in self._prefills:
                continue
            while self.queue:
                req = self.queue.pop(0)
                if not req.prompt:
                    self._reject(req, "empty prompt")
                    continue
                if len(req.prompt) > self.max_len:
                    self._reject(req, f"prompt length {len(req.prompt)} "
                                      f"exceeds max_len {self.max_len}")
                    continue
                self._launch(slot, req)
                break

    def _evict(self, slot: int):
        req = self.active[slot]
        self.active[slot] = None
        self._caches[slot] = None
        if req is not None:
            self._promoted.discard(req.rid)
            self._degraded.discard(req.rid)
            self._strikes.pop(req.rid, None)

    # ---------------------------------------------------------------- decode
    def _plan_group(self, pinned_live):
        """Split the pinned lanes into (decodable now, holding): the target
        is every pinned lane as one planned group; while its batch plan
        builds in the background, the previously promoted subset keeps
        decoding under its own cached plan (no resident ever stalls) and
        newcomers hold.  Terminal build failure degrades the newcomers to
        the fallback path and retries the shrunken group."""
        if not self.async_plans:
            return pinned_live, []       # sync: _pinned_decode builds inline
        group = list(pinned_live)
        while group:
            key, kwargs = self._plan_spec(self._batch_topo(group))
            state = self.prep.poll(key)
            if state == "absent":
                self.prep.request(key, kwargs)
                state = self.prep.poll(key)   # publishes if already raced in
            if state == "ready":
                self._promoted = {r.rid for _, r in group}
                return group, [ln for ln in pinned_live if ln not in group]
            if state == "failed":
                # blame the lanes that changed the batch topology: everyone
                # not already promoted degrades; the promoted core retries
                newcomers = [ln for ln in group
                             if ln[1].rid not in self._promoted]
                if not newcomers:
                    newcomers = group
                for _, r in newcomers:
                    self._degraded.add(r.rid)
                    r.error = self.prep.error(key)
                    self.metrics_agg.bump("plan_fallback_lanes")
                group = [ln for ln in group if ln not in newcomers]
                continue
            # building: fall back to the promoted core for this tick
            core = [ln for ln in group if ln[1].rid in self._promoted]
            if core and core != group:
                ck, _ = self._plan_spec(self._batch_topo(core))
                if self.prep.poll(ck) == "ready":
                    return core, [ln for ln in pinned_live if ln not in core]
            return [], list(pinned_live)
        # every lane degraded this round: they join the fallback group from
        # the next tick on (this tick they sit out — the residents, if any,
        # were all degraded too, so there is nobody left to stall)
        return [], []

    def _decode_group(self, lanes, *, pinned: bool):
        """One batched decode call over ``lanes`` (padded to the fixed slot
        count by cycling); the tick's tokens come to the host in one copy."""
        lanes_padded = [lanes[i % len(lanes)] for i in range(self.slots)]
        batched = _stack_slots([self._caches[s] for s, _ in lanes_padded],
                               self._axes)
        toks = torch.tensor([[r.out[-1]] for _, r in lanes_padded],
                            dtype=torch.int32, device=self._device)
        if pinned:
            decode = self._pinned_decode(self._batch_topo(lanes))
        else:
            decode = self._decode
        logits, new_cache = decode(self.params, batched, toks)
        nxt_all = torch.argmax(logits[:len(lanes)], dim=-1).tolist()
        for i, (slot, req) in enumerate(lanes):
            self._caches[slot] = _slice_slot(new_cache, self._axes, i)
            nxt = int(nxt_all[i])
            req.out.append(nxt)
            req.metrics.decode_ticks += 1
            if not pinned and req.rid in self._degraded:
                req.metrics.fallback_ticks += 1
                self.metrics_agg.bump("fallback_ticks")
            if nxt == req.eos or len(req.out) >= req.max_new:
                self._finish(req, "done")
                self._evict(slot)
        if pinned and self._drift_on:
            self._check_drift(lanes)

    def _check_drift(self, lanes):
        arrs = self._sink.drain_drift()
        if not arrs:
            return
        match = np.minimum.reduce([np.asarray(a) for a in arrs])  # per lane,
        for i, (slot, req) in enumerate(lanes):                   # worst layer
            if req.done or i >= match.shape[0]:
                continue
            if match[i] < 0.999:
                self._strikes[req.rid] = self._strikes.get(req.rid, 0) + 1
                if self._strikes[req.rid] >= self.drift_patience:
                    # the pin no longer reflects the router: unpin the lane
                    # back to router-driven decode
                    req.topology = None
                    self._promoted.discard(req.rid)
                    self._strikes.pop(req.rid, None)
                    self.metrics_agg.bump("drift_unpins")
            else:
                self._strikes.pop(req.rid, None)

    # ------------------------------------------------------------------ tick
    def tick(self):
        """One engine iteration: install finished prefills, launch new ones,
        one batched decode step per (pinned, fallback) group, evict."""
        t0 = time.monotonic()
        self._poll_prefills()
        self._admit()
        self.ticks += 1
        live = [(s, r) for s, r in enumerate(self.active) if r is not None]
        if not live and self._prefills:
            # nothing to decode yet: block briefly on the in-flight prefills
            # instead of spinning max_ticks away
            concurrent.futures.wait([f for f, _, _ in self._prefills.values()],
                                    timeout=0.25,
                                    return_when=concurrent.futures.FIRST_COMPLETED)
            self._poll_prefills()
            self._admit()
            live = [(s, r) for s, r in enumerate(self.active) if r is not None]
        if not live:
            self.metrics_agg.record_tick(time.monotonic() - t0, 0)
            return
        pinned_live = [(s, r) for s, r in live
                       if self._moe_cfg is not None and r.topology is not None
                       and r.rid not in self._degraded]
        decoded = False
        if pinned_live:
            # pack lanes by topology key: same-topology requests sit adjacent
            # and recurring batch topologies hit the same cached plans and
            # pinned step across ticks
            pinned_live.sort(key=lambda sr: (self._lane_topo(sr[1]), sr[0]))
            group, holding = self._plan_group(pinned_live)
            if group:
                self._decode_group(group, pinned=True)
                decoded = True
            for _, r in holding:
                r.metrics.wait_ticks += 1
                self.metrics_agg.bump("held_ticks")
        in_pinned = {r.rid for _, r in pinned_live}
        fallback = [(s, r) for s, r in live if r.rid not in in_pinned]
        if fallback:
            self._decode_group(fallback, pinned=False)
            decoded = True
        if not decoded:
            self.prep.wait()       # every lane is holding on a plan build
        self.metrics_agg.record_tick(time.monotonic() - t0, len(live))

    def pending(self) -> bool:
        """True while any request is queued, prefilling, or resident."""
        return (bool(self.queue) or bool(self._prefills)
                or any(a is not None for a in self.active))

    def run_until_done(self, max_ticks: int = 1000) -> list[Request]:
        while self.pending() and self.ticks < max_ticks:
            self.tick()
        if self.pending():
            # starved requests must not masquerade as completed: mark every
            # straggler terminal so callers can tell
            stragglers = (self.queue
                          + [req for _, req, _ in self._prefills.values()]
                          + [r for r in self.active if r is not None])
            for req in stragglers:
                self._finish(req, "timeout")
        return self._all

    # ------------------------------------------------------------- telemetry
    def metrics(self) -> dict:
        from .metrics import health_summary
        out = self.metrics_agg.snapshot()
        out["plan_cache"] = self.plan_cache.stats()
        out["faults"] = self.faults.counts() if self.faults is not None else {}
        # core-kernel guardrail state (breakers, reroutes, sentinels) rides
        # the same scrape: serving SLO breaches usually *start* as kernel
        # degradation one layer down (DESIGN.md §12)
        out["health"] = health_summary(guardrails.HEALTH.snapshot())
        return out

    def close(self) -> None:
        """Shut down the background pools (idempotent; engines used briefly
        in tests may skip this — idle pool threads are cheap)."""
        self.prep.close()
        if self._prefill_pool is not None:
            self._prefill_pool.shutdown(wait=False)
