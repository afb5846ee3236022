"""Deterministic fault injection; counterpart of ``repro.runtime.faults``.

``FaultInjector`` is a seeded, per-site fault source consulted at
well-known hook points ("sites").  The port's core sites, consulted through
the ``inject_faults`` scope:

    ``plan_build``               raise inside ``PlanBuilder.substrate``
                                 before a substrate is built
    ``substrate_prep``           raise inside ``PlanBuilder.kernel_opts``
                                 before a registry ``prep`` hook runs
    ``kernel_execute``           raise before any kernel dispatch in
                                 ``execute`` / ``execute_sddmm`` /
                                 ``execute_chain`` / ``execute_attention``
                                 (every backend)
    ``kernel_execute:<backend>`` the same, only when the call's backend
                                 matches (``kernel_execute:hopper`` trips
                                 the Hopper rung of the ladder while the
                                 ``"torch"`` rung stays healthy)

The reference's serving sites (``prefill``, ``topology_drift``) belong to
its serve engine, which the port does not have yet; ``perturb_topology``,
the ``topology_drift`` site's action, is here all the same.

Each site gets its own ``random.Random`` stream seeded exactly as the
reference seeds it, ``(seed << 32) ^ zlib.crc32(site)`` (not Python's
randomized ``hash``), so one ``(seed, spec)`` pair fires on the same
consultations in both packages and on every run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
import zlib
from typing import Dict, Optional


class InjectedFault(RuntimeError):
    """Raised by ``FaultInjector.raise_if`` at a firing site."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What one site does when consulted.

    ``fail``        the first ``fail`` consultations raise
    ``p_fail``      after the burst, each consultation raises with this
                    probability on the site's seeded stream
    ``delay``       seconds to sleep before returning or raising
    ``delay_times`` only the first ``delay_times`` consultations sleep
                    (None: every one)
    """

    fail: int = 0
    p_fail: float = 0.0
    delay: float = 0.0
    delay_times: Optional[int] = None


class FaultInjector:
    """Seeded per-site fault source; thread-safe."""

    def __init__(self, specs: Optional[Dict[str, FaultSpec]] = None, *,
                 seed: int = 0):
        self.seed = seed
        self.specs: Dict[str, FaultSpec] = dict(specs or {})
        self._lock = threading.Lock()
        self._rng: Dict[str, random.Random] = {}
        self._count: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    def _site_rng(self, site: str) -> random.Random:
        rng = self._rng.get(site)
        if rng is None:
            # zlib.crc32 is stable across processes, unlike hash()
            rng = random.Random((self.seed << 32) ^ zlib.crc32(site.encode()))
            self._rng[site] = rng
        return rng

    def fire(self, site: str) -> bool:
        """Consult ``site``: apply its delay (if any) and report whether the
        site fails this time."""
        spec = self.specs.get(site)
        if spec is None:
            return False
        with self._lock:
            n = self._count.get(site, 0)
            self._count[site] = n + 1
            fails = n < spec.fail
            if not fails and spec.p_fail > 0.0:
                fails = self._site_rng(site).random() < spec.p_fail
            delay = spec.delay if (spec.delay_times is None
                                   or n < spec.delay_times) else 0.0
            if fails:
                self.fired[site] = self.fired.get(site, 0) + 1
        if delay > 0.0:
            time.sleep(delay)
        return fails

    def raise_if(self, site: str) -> None:
        if self.fire(site):
            raise InjectedFault(f"injected fault at {site!r}")

    def perturb_topology(self, topology: tuple, num_experts: int) -> tuple:
        """Drift a pinned top-k expert set: if ``topology_drift`` fires,
        rotate every expert id by one (mod E), a sorted top-k set that
        cannot match the router's choice."""
        if not self.fire("topology_drift"):
            return topology
        return tuple(sorted((int(e) + 1) % num_experts for e in topology))

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.fired)


# ---------------------------------------------------------------------------
# the core-site scope: how plan/execute find the injector
# ---------------------------------------------------------------------------

_SCOPE = threading.local()


@contextlib.contextmanager
def inject_faults(injector: FaultInjector | None):
    """Make ``injector`` the active core-site fault source for the dynamic
    extent of this thread.  ``None`` is a no-op scope.  Nests; the
    innermost scope wins."""
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    if injector is not None:
        stack.append(injector)
    try:
        yield injector
    finally:
        if injector is not None:
            stack.pop()


def active_injector() -> FaultInjector | None:
    """Innermost ``inject_faults`` scope, or None (the production path)."""
    stack = getattr(_SCOPE, "stack", None)
    return stack[-1] if stack else None


def consult(site: str) -> None:
    """Fire ``site`` on the scoped injector, if any."""
    inj = active_injector()
    if inj is not None:
        inj.raise_if(site)
