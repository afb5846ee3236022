"""SLO telemetry for the serving engine; counterpart of
``repro.serve.metrics``, pure Python.

Two layers: ``RequestMetrics`` rides on each ``Request`` and records the
wall-clock lifecycle edges (submit → prefill start → first token → last
token), from which the queue / prefill / decode / total latencies and TTFT
derive; ``EngineMetrics`` aggregates across requests and ticks — terminal
status counts, fallback / retry / stall counters bumped by the engine's
hardening paths, and a bounded ring of per-tick (duration, occupancy)
samples for p50/p99 tick latency.  ``snapshot()`` renders everything into
one plain dict, which ``engine.metrics()`` returns next to the PlanCache
counters and ``health_summary`` of the guardrails' registry."""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) without numpy."""
    if not values:
        return 0.0
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[k])


@dataclasses.dataclass
class RequestMetrics:
    """Lifecycle timestamps (time.monotonic) and per-request counters."""

    submitted: float = 0.0
    prefill_start: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None
    prefill_attempts: int = 0
    decode_ticks: int = 0       # ticks this request produced a token in
    wait_ticks: int = 0         # ticks held while its plan was building
    fallback_ticks: int = 0     # ticks decoded on the prep-free fallback path

    @property
    def queue_s(self) -> Optional[float]:
        if self.prefill_start is None:
            return None
        return self.prefill_start - self.submitted

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.submitted

    @property
    def prefill_s(self) -> Optional[float]:
        if self.prefill_start is None or self.first_token is None:
            return None
        return self.first_token - self.prefill_start

    @property
    def decode_s(self) -> Optional[float]:
        if self.first_token is None or self.finished is None:
            return None
        return self.finished - self.first_token

    @property
    def total_s(self) -> Optional[float]:
        if self.finished is None:
            return None
        return self.finished - self.submitted


class EngineMetrics:
    """Cross-request aggregation; thread-safe counters (workers bump retry
    counts while the tick thread bumps occupancy)."""

    def __init__(self, tick_window: int = 2048):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self._ticks: deque = deque(maxlen=tick_window)   # (seconds, occupancy)
        self._requests: List[RequestMetrics] = []
        self._status: Dict[str, int] = {}

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def record_tick(self, seconds: float, occupancy: int) -> None:
        with self._lock:
            self._ticks.append((seconds, occupancy))

    def finish_request(self, status: str, rm: RequestMetrics) -> None:
        rm.finished = time.monotonic()
        with self._lock:
            self._status[status] = self._status.get(status, 0) + 1
            self._requests.append(rm)

    def snapshot(self) -> dict:
        with self._lock:
            ticks = list(self._ticks)
            reqs = list(self._requests)
            counters = dict(self.counters)
            status = dict(self._status)
        tick_s = [t for t, _ in ticks]
        occ = [o for _, o in ticks]
        ttft = [r.ttft_s for r in reqs if r.ttft_s is not None]
        total = [r.total_s for r in reqs if r.total_s is not None]
        queue = [r.queue_s for r in reqs if r.queue_s is not None]
        decode = [r.decode_s for r in reqs if r.decode_s is not None]
        return {
            "requests": status,
            "counters": counters,
            "ticks": {
                "count": len(ticks),
                "p50_ms": percentile(tick_s, 50) * 1e3,
                "p99_ms": percentile(tick_s, 99) * 1e3,
                "mean_occupancy": (sum(occ) / len(occ)) if occ else 0.0,
            },
            "latency": {
                "ttft_p50_ms": percentile(ttft, 50) * 1e3,
                "ttft_p99_ms": percentile(ttft, 99) * 1e3,
                "queue_p50_ms": percentile(queue, 50) * 1e3,
                "decode_p50_ms": percentile(decode, 50) * 1e3,
                "total_p50_ms": percentile(total, 50) * 1e3,
                "total_p99_ms": percentile(total, 99) * 1e3,
            },
        }


def health_summary(snapshot: dict) -> dict:
    """Condense a ``core.guardrails.HEALTH.snapshot()`` into the serving
    dashboard shape: total trips/recoveries, the set of currently-open (or
    half-open) breakers (keys ``"hopper:<kernel>"`` / ``"bsr:<kernel>"``),
    and the raw counters.  ``engine.metrics()`` attaches this under
    ``"health"`` so one scrape covers serving *and* core-kernel
    degradation (DESIGN.md §12)."""
    breakers = snapshot.get("breakers", {})
    return {
        "counters": dict(snapshot.get("counters", {})),
        "breaker_trips": sum(b["trips"] for b in breakers.values()),
        "breaker_recoveries": sum(b["recoveries"] for b in breakers.values()),
        "open_breakers": sorted(k for k, b in breakers.items()
                                if b["state"] != "closed"),
        "breakers": {k: dict(b) for k, b in breakers.items()},
    }
