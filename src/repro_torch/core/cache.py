"""Topology-keyed plan caching; counterpart of ``repro.core.cache``.

Workloads re-present the same sparsity topology far more often than a new
one, so a plan is a reusable artifact: ``PlanCache`` is a bounded LRU from
(pattern fingerprint, shape, backend, device, thresholds, ...) to the plan,
with hit / miss / eviction / build counters that make reuse observable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable

import numpy as np

from .formats import CSR, host
from .selector import SelectorThresholds


def pattern_fingerprint(csr: CSR) -> str:
    """Digest of a CSR's pattern and shape, values excluded — byte for byte
    the reference's (int32 indptr and indices bytes, then the repr of the
    shape as a tuple of Python ints), so one thresholds file's geometry
    entries serve both packages."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(host(csr.indptr), np.int32).tobytes())
    h.update(np.ascontiguousarray(host(csr.indices), np.int32).tobytes())
    h.update(repr(tuple(int(s) for s in csr.shape)).encode())
    return h.hexdigest()


def thresholds_version(th: SelectorThresholds | None) -> tuple:
    """The thresholds' part of the key: every field, so a recalibration
    invalidates the plans whose selector decisions it changes."""
    return () if th is None else dataclasses.astuple(th)


def plan_key(csr: CSR, *, backend: str, device,
             thresholds: SelectorThresholds | None = None,
             tile: int | None = None, bsr_block: tuple = (8, 128),
             extra: tuple = ()) -> tuple:
    """The cache key of a ``plan()`` call.  ``tile=None`` keys as 512 (its
    resolution) when the thresholds carry no geometry table, else as
    ``"auto"`` (then the thresholds in the key fix the resolution)."""
    if tile is None and not (thresholds is not None and thresholds.geometries):
        tile = 512
    return ("plan", pattern_fingerprint(csr), tuple(csr.shape), backend,
            str(device), thresholds_version(thresholds),
            "auto" if tile is None else int(tile),
            tuple(int(b) for b in bsr_block), extra)


class PlanCache:
    """Bounded-LRU store of plans with observable counters.  ``get_or_build``
    is the one entry point: a miss runs ``build`` (counted in ``builds``)
    and evicts the least recently used entry past ``capacity``.
    Thread-safe."""

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.builds = 0

    def get_or_build(self, key, build: Callable[[], Any]):
        """The cached value for ``key``, built (and counted) on a miss."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            self.misses += 1
            value = build()
            self.builds += 1
            self._entries[key] = value
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
            return value

    def clear(self) -> None:
        """Drop entries; counters survive (they describe lifetime traffic)."""
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "builds": self.builds,
                    "size": len(self._entries), "capacity": self.capacity}

    def __repr__(self) -> str:
        s = self.stats()
        return (f"PlanCache(size={s['size']}/{s['capacity']}, "
                f"hits={s['hits']}, misses={s['misses']}, "
                f"evictions={s['evictions']}, builds={s['builds']})")


#: process-default cache of the ``repro_torch.api`` facade
DEFAULT_CACHE = PlanCache()


def cached_plan(csr: CSR, *, cache: PlanCache | None = None,
                backend: str | None = None,
                thresholds: SelectorThresholds | None = None,
                tile: int | None = None, bsr_block: tuple = (8, 128),
                **plan_kwargs):
    """``plan()`` through a ``PlanCache``: the same topology, shape, backend,
    device and thresholds give the same ``PlanBuilder`` (and so share its
    lazily built substrates).  Values are not in the key: a hit may return a
    plan baked with other values, which callers stream at execute time."""
    from . import registry
    from .plan import plan as build_plan
    from .selector import default_thresholds

    cache = cache if cache is not None else DEFAULT_CACHE
    th = thresholds if thresholds is not None else default_thresholds()
    resolved = backend or registry.default_backend(csr.device)
    # None kwargs are plan() defaults: explicit-default and omitted
    # spellings share a key
    plan_kwargs = {k: v for k, v in plan_kwargs.items() if v is not None}
    key = plan_key(csr, backend=resolved, device=csr.device, thresholds=th,
                   tile=tile, bsr_block=bsr_block,
                   extra=tuple(sorted(plan_kwargs.items())))
    return cache.get_or_build(
        key, lambda: build_plan(csr, thresholds=th, backend=resolved,
                                tile=tile, bsr_block=bsr_block, **plan_kwargs))
