"""Topology-keyed plan caching; counterpart of ``repro.core.cache``.

Workloads re-present the same sparsity topology far more often than a new
one, so a plan is a reusable artifact: ``PlanCache`` is a bounded LRU from
(pattern fingerprint, shape, backend, device, thresholds, ...) to the plan,
with hit / miss / eviction / build counters that make reuse observable,
and a content digest beside each entry (``integrity=``) so a corrupted
cached plan is rebuilt, never executed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable

import numpy as np

from .formats import CSR, host
from .guardrails import plan_digest, validate_csr
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


def mesh_signature(mesh) -> tuple | None:
    """Hashable identity of a device mesh: its axis names, their extents
    and the device string of each position (``"cuda:0"``, ``"cpu"``), so
    a mesh on the card and one on the CPU key apart; None without one."""
    return None if mesh is None else mesh.signature()


def thresholds_version(th: SelectorThresholds | None) -> tuple:
    """The thresholds' part of the key: every field, so a recalibration
    invalidates the plans whose selector decisions it changes."""
    return () if th is None else dataclasses.astuple(th)


def plan_key(csr: CSR, *, backend: str, device,
             thresholds: SelectorThresholds | None = None,
             tile: int | None = None, bsr_block: tuple = (8, 128),
             extra: tuple = (), mesh=None) -> tuple:
    """The cache key of a ``plan()`` call.  ``tile=None`` keys as 512 (its
    resolution) when the thresholds carry no geometry table, else as
    ``"auto"`` (then the thresholds in the key fix the resolution).  A
    sharded plan's key ends with its ``mesh_signature``; a key without a
    mesh is the tuple it was before the sharded backend."""
    if tile is None and not (thresholds is not None and thresholds.geometries):
        tile = 512
    key = ("plan", pattern_fingerprint(csr), tuple(csr.shape), backend,
           str(device), thresholds_version(thresholds),
           "auto" if tile is None else int(tile),
           tuple(int(b) for b in bsr_block), extra)
    return key if mesh is None else key + (("mesh", mesh_signature(mesh)),)


class PlanCache:
    """Bounded-LRU store of plans with observable counters.  ``get_or_build``
    is the one entry point: a miss runs ``build`` (counted in ``builds``)
    and evicts the least recently used entry past ``capacity``.
    Thread-safe.

    Integrity (DESIGN.md §12): each entry is stored with its content digest
    (``guardrails.plan_digest``).  ``integrity="publish"`` (the default)
    checks an existing entry when ``put_built`` publishes its key again, so
    a corrupted first copy is replaced instead of kept; ``"hit"`` also
    checks on every hit of ``get`` / ``get_or_build``, so a stale or
    mutated cached plan is dropped and rebuilt, never executed; ``"off"``
    digests nothing.  Mismatches count in ``digest_mismatches``."""

    def __init__(self, capacity: int = 128, *, integrity: str = "publish"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if integrity not in ("off", "publish", "hit"):
            raise ValueError(f"unknown integrity policy {integrity!r}; "
                             "expected 'off', 'publish' or 'hit'")
        self.capacity = capacity
        self.integrity = integrity
        self._entries: OrderedDict = OrderedDict()   # key -> (value, digest)
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.builds = 0
        self.digest_mismatches = 0

    def _digest(self, value):
        return None if self.integrity == "off" else plan_digest(value)

    def _verify_hit(self, key) -> bool:
        """Under ``integrity="hit"``: drop a corrupted entry and count it.
        The caller holds the lock.  Whether the entry survived."""
        if self.integrity != "hit":
            return True
        value, digest = self._entries[key]
        if plan_digest(value) == digest:
            return True
        self.digest_mismatches += 1
        del self._entries[key]
        return False

    def _insert(self, key, value) -> None:
        self._entries[key] = (value, self._digest(value))
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key, default=None):
        """Look up and LRU-touch without building; counts a hit or a miss (a
        corrupted entry under ``integrity="hit"`` is dropped and missed)."""
        with self._lock:
            if key in self._entries and self._verify_hit(key):
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key][0]
            self.misses += 1
            return default

    def get_or_build(self, key, build: Callable[[], Any]):
        """The cached value for ``key``, built (and counted) on a miss;
        under ``integrity="hit"`` a corrupted entry is rebuilt."""
        with self._lock:
            if key in self._entries and self._verify_hit(key):
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key][0]
            self.misses += 1
            value = build()
            self.builds += 1
            self._insert(key, value)
            return value

    def put(self, key, value) -> None:
        with self._lock:
            self._insert(key, value)

    def put_built(self, key, value) -> None:
        """Publish a value built outside the lock.  Counts as a build; a
        duplicate keeps the first copy, unless that copy fails its digest
        check (``integrity`` not "off"), which the fresh build replaces."""
        with self._lock:
            self.builds += 1
            if key in self._entries:
                old, digest = self._entries[key]
                if self.integrity == "off" or plan_digest(old) == digest:
                    self._entries.move_to_end(key)
                    return
                self.digest_mismatches += 1
            self._insert(key, value)

    def clear(self) -> None:
        """Drop entries; counters survive (they describe lifetime traffic)."""
        with self._lock:
            self._entries.clear()

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = self.misses = self.evictions = self.builds = 0
            self.digest_mismatches = 0

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "builds": self.builds,
                    "digest_mismatches": self.digest_mismatches,
                    "size": len(self._entries), "capacity": self.capacity}

    def __repr__(self) -> str:
        s = self.stats()
        return (f"PlanCache(size={s['size']}/{s['capacity']}, "
                f"hits={s['hits']}, misses={s['misses']}, "
                f"evictions={s['evictions']}, builds={s['builds']})")


#: process-default cache of the ``repro_torch.api`` facade; as the
#: reference's, it digests each entry on insert (``integrity="publish"``),
#: which ``put_built`` (the serve engine's plan prep) checks when a key is
#: published again.  A miss pays the digest: a copy of the CSR to the host.
DEFAULT_CACHE = PlanCache()


def cached_plan(csr: CSR, *, cache: PlanCache | None = None,
                backend: str | None = None,
                thresholds: SelectorThresholds | None = None,
                tile: int | None = None, bsr_block: tuple = (8, 128),
                validate: str | None = None, **plan_kwargs):
    """``plan()`` through a ``PlanCache``: the same topology, shape, backend,
    device and thresholds give the same ``PlanBuilder`` (and so share its
    lazily built substrates).  Values are not in the key: a hit may return a
    plan baked with other values, which callers stream at execute time.

    ``validate`` runs the pattern policy before the key is computed, so a
    repaired matrix keys under its clean fingerprint: the entry a clean
    input hits."""
    if validate is not None and validate != "off":
        csr, _ = validate_csr(csr, validate)
    from . import registry
    from .plan import plan as build_plan
    from .selector import default_thresholds

    cache = cache if cache is not None else DEFAULT_CACHE
    th = thresholds if thresholds is not None else default_thresholds()
    # None kwargs are plan() defaults: explicit-default and omitted
    # spellings share a key
    plan_kwargs = {k: v for k, v in plan_kwargs.items() if v is not None}
    mesh = plan_kwargs.get("mesh")
    resolved = backend or ("sharded" if mesh is not None
                           else registry.default_backend(csr.device))
    key = plan_key(csr, backend=resolved, device=csr.device, thresholds=th,
                   tile=tile, bsr_block=bsr_block, mesh=mesh,
                   extra=tuple(sorted((k, v) for k, v in plan_kwargs.items()
                                      if k != "mesh")))
    return cache.get_or_build(
        key, lambda: build_plan(csr, thresholds=th, backend=resolved,
                                tile=tile, bsr_block=bsr_block, **plan_kwargs))
