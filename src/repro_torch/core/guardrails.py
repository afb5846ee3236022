"""Execution guardrails (DESIGN.md §12); counterpart of
``repro.core.guardrails``, in four pillars.

1. **Pattern validation and repair** (``validate_csr``): a CSR from user
   code may be unsorted within rows, carry duplicate or out-of-range column
   indices, non-finite values or an inconsistent indptr.  The ``validate=``
   policy of ``api.sparse()`` / ``plan()`` / ``cached_plan()`` decides
   before any substrate is built: ``"check"`` warns, ``"repair"`` rebuilds
   the matrix through ``formats.csr_from_coo`` on the input's device (bit
   for bit the reference's repair), ``"strict"`` raises ``PatternError``.
   ``inspect_csr`` and ``repair_csr`` work in numpy on host copies: a copy
   of the CSR to the host, paid only under ``validate != "off"``.

2. **Numeric sentinels** (``apply_sentinel``): opt-in non-finite detection
   on an ``execute`` output.  On an eager output the check is one device
   reduction (``aminmax``) and one host read; a non-finite lane bumps
   ``sentinel:<site>``, then ``"raise"`` raises ``NumericFault``,
   ``"sanitize"`` zeroes the poisoned lanes (one ``torch.nan_to_num`` pass,
   the same bits as ``where(isfinite(y), y, 0)``) and ``"fallback"``
   re-executes one rung down the ladder where there is one: on CPU
   operands; on the card there is none, and ``"fallback"`` sanitizes.
   Under CUDA-graph capture (``torch.cuda.is_current_stream_capturing()``,
   the counterpart of the reference's traced branch) the check cannot read
   the host: ``"sanitize"`` and ``"fallback"`` are the same in-graph pass,
   and ``"raise"`` is refused with a ``ValueError`` at capture time (a
   graph cannot raise; call eagerly).
   No counter moves under capture, as none moves under the reference's
   trace.  ``grad_scope`` / ``sanitize_grads`` extend "sanitize" to the
   backward of every ``torch.autograd.Function`` of ``core/vjp.py``.

3. **The degradation ladder** (``guarded_call`` + ``CircuitBreaker``): a
   breaker per (backend, logical kernel).  On CPU operands, where the
   ``"hopper"`` and ``"bsr"`` wrappers run their kernels' plain versions, a
   kernel failure, real or injected at the ``kernel_execute`` fault sites,
   reroutes the call one rung down ``registry.DEMOTION`` (``"hopper"`` →
   ``"torch"``, ``"bsr"`` → ``"torch"``; a ``"sharded"`` call keeps its
   shards and runs them on the ``"torch"`` inner, ``"sharded/torch-inner"``,
   where the reference's rung is ``"sharded/xla-inner"``) and bumps
   ``kernel_reroute:<from>-><to>:<logical>``.  ``threshold`` failures in a
   row trip the breaker open (``breaker_skip:<backend>:<logical>`` counts
   each call it skips); after ``cooldown_s`` it half-opens and probes the
   primary once, closing on success.  A rerouted call builds its backward
   on the rung it ran on, so its grads are bit for bit the ``"torch"``
   backend's.  On the card a kernel launches or raises: the ladder has no
   rung below CUDA operands, so a failure is recorded in the breaker (its
   trips and recoveries as on the CPU), counted as
   ``kernel_failure:<backend>:<logical>`` and re-raised, and an open
   breaker skips nothing (there is nothing to skip to).  The failures
   caught are ``FAILURE_TYPES``: the CUDA errors torch raises and the
   port's ``kernels._build.check`` are ``RuntimeError``s, as are a kernel
   that fails to build (no ``nvcc``, a compile error) and ``InjectedFault``.
   Usage errors (``ValueError``, ``TypeError``, ``KeyError``) and
   ``NumericFault`` propagate.

   Two limits of an in-process ladder on a CUDA card.  An illegal memory
   access is a sticky error: it poisons the process's CUDA context, so no
   call after it succeeds on the card, the ``"torch"`` rung included, and
   only a new process recovers.  And a fault that happens while a kernel
   runs (not at its launch) surfaces only at a later synchronisation,
   outside ``guarded_call``: the ladder counts launch and build errors,
   which ``cudaGetLastError`` reports at the launch.

4. **Plan integrity digests** (``plan_digest``): a content digest of a plan
   stored next to each ``PlanCache`` entry and checked on publication (and,
   under ``integrity="hit"``, on every hit): a stale or corrupted cached
   plan is rebuilt, never executed.

Everything lands in the process ``HEALTH`` registry (``api.health()``):
breaker state, trips and recoveries, reroutes, skips, failures on the
card, sentinel firings,
pattern repairs, and the named demotions (``demote:quant_range``,
``demote:fp8_to_int8``, ``demote:chain_fuse``, ``demote:attn_fuse``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..runtime.faults import active_injector


class PatternError(ValueError):
    """A sparsity pattern failed validation under ``validate="strict"``.
    ``issues`` carries the defects' names."""

    def __init__(self, message: str, issues: tuple = ()):
        super().__init__(message)
        self.issues = tuple(issues)


class NumericFault(ArithmeticError):
    """A numeric sentinel fired under the ``"raise"`` policy: a kernel
    output (or a quantized value stream) left the representable range."""


#: the ``validate=`` policies ``api.sparse()`` / ``plan()`` accept
VALIDATE_POLICIES = ("off", "check", "repair", "strict")

#: the ``sentinel=`` policies ``execute()`` accepts ("off" / None disables)
SENTINEL_POLICIES = ("off", "raise", "sanitize", "fallback")


# ---------------------------------------------------------------------------
# pillar 1: pattern validation and repair
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    """A host numpy copy of a tensor (types numpy lacks, bfloat16 and fp8,
    widened to float32) or of an array."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.is_floating_point() and t.dtype not in (torch.float16, torch.float32,
                                                 torch.float64):
        t = t.float()
    return t.numpy()


@dataclasses.dataclass(frozen=True)
class PatternReport:
    """What ``inspect_csr`` found: ``issues`` drawn from ``{"indptr",
    "length_mismatch", "out_of_range", "unsorted", "duplicates",
    "nonfinite"}``; empty means well-formed."""

    issues: tuple = ()

    @property
    def ok(self) -> bool:
        return not self.issues


def inspect_csr(csr) -> PatternReport:
    """Detect, without repairing: an inconsistent indptr, an indices / data
    length mismatch, out-of-range columns, unsorted rows, duplicates within
    a row and non-finite values.  Numpy on host copies."""
    from .formats import row_ids_from_indptr
    indptr = _np(csr.indptr)
    indices = _np(csr.indices)
    data = _np(csr.data)
    m, k = (int(s) for s in csr.shape)
    issues: list[str] = []
    if indices.shape[0] != data.shape[0]:
        issues.append("length_mismatch")
    nnz = int(min(indices.shape[0], data.shape[0]))
    indptr_ok = (indptr.ndim == 1 and indptr.shape[0] == m + 1
                 and (m == 0 or int(indptr[0]) == 0)
                 and bool(np.all(np.diff(indptr) >= 0))
                 and int(indptr[-1]) == indices.shape[0])
    if not indptr_ok:
        issues.append("indptr")
    if nnz and bool(np.any((indices[:nnz] < 0) | (indices[:nnz] >= k))):
        issues.append("out_of_range")
    if indptr_ok and nnz > 1:
        rows = row_ids_from_indptr(indptr, nnz)
        same_row = rows[1:] == rows[:-1]
        step = indices[1:nnz].astype(np.int64) - indices[:nnz - 1]
        if bool(np.any(same_row & (step < 0))):
            issues.append("unsorted")
        if bool(np.any(same_row & (step == 0))):
            issues.append("duplicates")
        elif "unsorted" in issues:
            # duplicates hidden by an unsorted order: per-row multisets
            key = rows.astype(np.int64) * max(k, 1) + indices[:nnz]
            if len(np.unique(key)) != nnz:
                issues.append("duplicates")
    if nnz and not bool(np.all(np.isfinite(data[:nnz].astype(np.float64)))):
        issues.append("nonfinite")
    return PatternReport(tuple(issues))


def repair_csr(csr):
    """Rebuild a malformed CSR as the reference does: make the indptr
    monotone and clip it, cut indices and data to their common length, drop
    out-of-range columns, zero non-finite values, then
    ``formats.csr_from_coo`` (sort by (row, col), sum duplicates) on the
    input's device — bit for bit what a sorted, coalesced input gives."""
    from .formats import csr_from_coo, row_ids_from_indptr
    indptr = _np(csr.indptr).astype(np.int64).reshape(-1)
    indices = _np(csr.indices).reshape(-1)
    data = _np(csr.data).reshape(-1)
    m, k = (int(s) for s in csr.shape)
    n = int(min(indices.shape[0], data.shape[0]))
    indices, data = indices[:n], data[:n]
    if indptr.shape[0] < m + 1:
        tail = indptr[-1] if indptr.shape[0] else 0
        indptr = np.concatenate(
            [indptr, np.full(m + 1 - indptr.shape[0], tail, np.int64)])
    indptr = np.maximum.accumulate(np.clip(indptr[:m + 1], 0, n))
    indptr[0], indptr[m] = 0, n   # orphan trailing entries join the last row
    indptr = np.maximum.accumulate(indptr)
    rows = row_ids_from_indptr(indptr, n)
    good = (indices >= 0) & (indices < k)
    vals = np.where(np.isfinite(data.astype(np.float64)), data, 0)
    dtype = data.dtype if np.issubdtype(data.dtype, np.floating) else np.float32
    fixed = csr_from_coo(rows[good], indices[good], vals[good], (m, k),
                         dtype=dtype, device=csr.data.device)
    if csr.data.is_floating_point() and fixed.data.dtype != csr.data.dtype:
        # bfloat16 / fp8 values were repaired in float32
        fixed = dataclasses.replace(fixed, data=fixed.data.to(csr.data.dtype))
    return fixed


def validate_csr(csr, policy: str = "check"):
    """Apply one ``validate=`` policy to a CSR; returns ``(csr, report)``.
    ``"off"`` detects nothing; ``"check"`` warns and returns the input;
    ``"repair"`` returns ``repair_csr``'s matrix; ``"strict"`` raises
    ``PatternError``.  A clean pattern passes through untouched under every
    policy."""
    if policy not in VALIDATE_POLICIES:
        raise ValueError(f"unknown validate policy {policy!r}; expected one "
                         f"of {VALIDATE_POLICIES}")
    if policy == "off":
        return csr, PatternReport()
    report = inspect_csr(csr)
    if report.ok:
        return csr, report
    HEALTH.bump("pattern_issues")
    detail = ", ".join(report.issues)
    if policy == "strict":
        raise PatternError(
            f"pattern failed validation ({detail}); pass validate='repair' "
            "to sort/coalesce/clip/zero it, or fix the CSR upstream",
            issues=report.issues)
    if policy == "check":
        warnings.warn(f"pattern has issues ({detail}); executing it as-is — "
                      "pass validate='repair' to fix, 'strict' to reject",
                      stacklevel=3)
        return csr, report
    HEALTH.bump("pattern_repairs")
    return repair_csr(csr), report


# ---------------------------------------------------------------------------
# pillar 3: circuit breakers and the health registry
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Closed → (``threshold`` failures in a row) → open → (after
    ``cooldown_s``) → half-open probe → closed on success, open on failure.
    ``clock`` is injectable; ``cooldown_s=0`` makes every call after a trip
    a probe.  A closed breaker with no failure answers without its lock
    (a read of one attribute), so the healthy path stays cheap."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.state = "closed"
        self.failures = 0            # in a row
        self.trips = 0
        self.recoveries = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """Whether the caller should try the primary backend now.  An open
        breaker half-opens (one probe) once the cooldown has passed."""
        if self.state == "closed":
            return True
        with self._lock:
            if self.state == "open":
                if self.clock() - self._opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    return True
                return False
            return True

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == "half_open" or self.failures >= self.threshold:
                if self.state != "open":
                    self.trips += 1
                self.state = "open"
                self._opened_at = self.clock()

    def record_success(self) -> None:
        if self.state == "closed" and not self.failures:
            return
        with self._lock:
            if self.state in ("open", "half_open"):
                self.recoveries += 1
            self.state = "closed"
            self.failures = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "trips": self.trips, "recoveries": self.recoveries}


class HealthRegistry:
    """Process-wide guardrail observability: named counters and the
    per-(backend, logical kernel) breakers.  ``api.health()`` is a snapshot
    of this object."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._breakers: dict[tuple, CircuitBreaker] = {}
        self._threshold = 3
        self._cooldown_s = 30.0

    def configure(self, *, threshold: int = 3, cooldown_s: float = 30.0) -> None:
        """Set the breaker parameters for breakers made from now on and
        re-arm the existing ones (``reset()`` + ``configure()`` restores the
        defaults)."""
        with self._lock:
            self._threshold = int(threshold)
            self._cooldown_s = float(cooldown_s)
            for br in self._breakers.values():
                br.threshold = int(threshold)
                br.cooldown_s = float(cooldown_s)

    def breaker(self, backend: str, logical: str) -> CircuitBreaker:
        key = (backend, logical)
        br = self._breakers.get(key)
        if br is None:
            with self._lock:
                br = self._breakers.get(key)
                if br is None:
                    br = CircuitBreaker(self._threshold, self._cooldown_s)
                    self._breakers[key] = br
        return br

    def bump(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + n

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "breakers": {f"{b}:{lg}": br.snapshot()
                             for (b, lg), br in self._breakers.items()},
            }

    def reset(self) -> None:
        """Drop counters and breakers."""
        with self._lock:
            self._counters.clear()
            self._breakers.clear()


#: the process default every hook writes to
HEALTH = HealthRegistry()

#: kernel-failure types the ladder catches and reroutes; usage errors
#: (ValueError / TypeError / KeyError) propagate, and a sentinel's
#: ``NumericFault`` is re-raised (the caller asked for it)
FAILURE_TYPES = (RuntimeError, NotImplementedError, ArithmeticError)


def guarded_call(logical: str, backend: str, primary: Callable[[], Any], *,
                 fallback: Callable[[], Any] | None = None,
                 fallback_name: str | None = None, on_card: bool = False):
    """One rung of the ladder around a kernel dispatch: consult the scoped
    injector at ``kernel_execute`` and ``kernel_execute:<backend>``, run
    ``primary`` under the (backend, logical) breaker, and on a caught
    failure record it and reroute through ``fallback`` (the rung below), or
    re-raise where there is none.  An open breaker skips the primary until
    its cooldown has passed, then probes it half-open.  ``on_card`` (the
    operands are CUDA tensors; the caller passes no ``fallback``) counts
    each failure as ``kernel_failure:<backend>:<logical>`` before it is
    re-raised."""
    br = HEALTH.breaker(backend, logical)
    if not br.allow():
        if fallback is not None:
            HEALTH.bump(f"breaker_skip:{backend}:{logical}")
            return fallback()
        # the bottom of the ladder: nothing to skip to, so try anyway
    inj = active_injector()
    try:
        if inj is not None:
            inj.raise_if("kernel_execute")
            inj.raise_if(f"kernel_execute:{backend}")
        y = primary()
    except NumericFault:
        raise
    except FAILURE_TYPES:
        br.record_failure()
        if fallback is None:
            if on_card:
                HEALTH.bump(f"kernel_failure:{backend}:{logical}")
            raise
        HEALTH.bump(f"kernel_reroute:{backend}->{fallback_name or 'torch'}"
                 f":{logical}")
        return fallback()
    br.record_success()
    return y


# ---------------------------------------------------------------------------
# pillar 2: numeric sentinels
# ---------------------------------------------------------------------------

_SENTINEL = threading.local()


@contextlib.contextmanager
def sentinel_scope(policy: str | None):
    """Make ``policy`` the default ``sentinel=`` of every ``execute`` in the
    dynamic extent of this thread (explicit arguments win).  ``None`` is a
    no-op."""
    if policy is not None and policy not in SENTINEL_POLICIES:
        raise ValueError(f"unknown sentinel policy {policy!r}; expected one "
                         f"of {SENTINEL_POLICIES}")
    stack = getattr(_SENTINEL, "stack", None)
    if stack is None:
        stack = _SENTINEL.stack = []
    if policy is not None:
        stack.append(policy)
    try:
        yield
    finally:
        if policy is not None:
            stack.pop()


def active_sentinel() -> str | None:
    stack = getattr(_SENTINEL, "stack", None)
    return stack[-1] if stack else None


def _zero_nonfinite(y: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)


def all_finite(y: torch.Tensor) -> torch.Tensor:
    """A 0-d bool tensor on ``y``'s device: every element finite.  One
    reduction pass (``aminmax`` propagates NaN, and the extremes show an
    infinity), not ``isfinite(y).all()``, which writes and reads a mask as
    large as ``y``."""
    if y.numel() == 0:
        return torch.ones((), dtype=torch.bool, device=y.device)
    lo, hi = torch.aminmax(y)
    return torch.isfinite(lo) & torch.isfinite(hi)


def _capturing(y: torch.Tensor) -> bool:
    """Whether ``y`` is an output recorded into a CUDA graph being
    captured (the counterpart of the reference's tracer check)."""
    return y.is_cuda and torch.cuda.is_current_stream_capturing()


def apply_sentinel(y, policy: str | None, *, site: str,
                   fallback: Callable[[], Any] | None = None):
    """The non-finite guard on a kernel output (see the module docstring):
    eager outputs are checked by one reduction and one host read, outputs
    under CUDA-graph capture stay in the graph, and counters move only on
    eager calls.  ``"fallback"`` with no rung below (every call on the
    card) degrades to ``"sanitize"``."""
    if policy in (None, "off"):
        return y
    if policy not in SENTINEL_POLICIES:
        raise ValueError(f"unknown sentinel policy {policy!r}; expected one "
                         f"of {SENTINEL_POLICIES}")
    if not y.is_floating_point():
        return y
    if _capturing(y):
        if policy == "raise":
            raise ValueError(
                f"sentinel='raise' at {site} cannot be captured in a CUDA "
                "graph (a graph cannot raise); call execute eagerly, or use "
                "'sanitize' or 'fallback' under capture")
        return _zero_nonfinite(y)
    if bool(all_finite(y)):
        return y
    HEALTH.bump(f"sentinel:{site}")
    if policy == "raise":
        raise NumericFault(f"non-finite kernel output at {site}")
    if policy == "fallback" and fallback is not None:
        HEALTH.bump(f"sentinel_fallback:{site}")
        return fallback()
    return _zero_nonfinite(y)


# -- the backward's hook -----------------------------------------------------

_GRAD = threading.local()


@contextlib.contextmanager
def grad_scope(policy: str | None):
    """Extend the sentinel to backward passes: the backward of a call made
    or differentiated inside the scope passes its gradients through
    ``sanitize_grads``.  Only ``"sanitize"`` acts (``"raise"`` and
    ``"fallback"`` have no backward counterpart; use
    ``train.step.TrainConfig(skip_nonfinite=True)`` to skip and report)."""
    if policy is not None and policy not in ("off", "sanitize"):
        raise ValueError("grad_scope supports 'sanitize' (or None/'off'); "
                         "use TrainConfig(skip_nonfinite=True) for "
                         "skip-and-report semantics")
    stack = getattr(_GRAD, "stack", None)
    if stack is None:
        stack = _GRAD.stack = []
    if policy is not None:
        stack.append(policy)
    try:
        yield
    finally:
        if policy is not None:
            stack.pop()


def active_grad_sentinel() -> str | None:
    stack = getattr(_GRAD, "stack", None)
    return stack[-1] if stack else None


def sanitize_grads(*grads, policy: str | None = None):
    """Zero the non-finite lanes of ``grads`` (None entries pass) when
    ``policy`` — the grad sentinel active at the forward, which a
    ``torch.autograd.Function`` records — or the one active now is
    ``"sanitize"``; else return them as they are.  Autograd runs a CUDA
    backward on a thread of its own, where the caller's thread-local scope
    is not visible: the forward's record carries it there."""
    if "sanitize" not in (policy, active_grad_sentinel()):
        return grads if len(grads) != 1 else grads[0]
    out = tuple(_zero_nonfinite(g) if g is not None and g.is_floating_point()
                else g for g in grads)
    return out if len(out) != 1 else out[0]


# ---------------------------------------------------------------------------
# pillar 4: plan integrity digests
# ---------------------------------------------------------------------------

def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).cpu() \
        .numpy().tobytes()


def _dtype_name(t: torch.Tensor) -> bytes:
    return str(t.dtype).replace("torch.", "").encode()


def _fold(h, v) -> None:
    """Fold a leaf or a tuple of identity fields into the hash: a tensor by
    type, shape and bytes (a copy to the host), a scalar or an opaque leaf
    by its repr."""
    if isinstance(v, torch.Tensor):
        h.update(_dtype_name(v) + repr(tuple(v.shape)).encode())
        h.update(_tensor_bytes(v))
    elif isinstance(v, tuple):
        h.update(b"(")
        for item in v:
            _fold(h, item)
        h.update(b")")
    else:
        h.update(repr(v).encode())


def plan_digest(value) -> str:
    """Content digest of a cacheable plan value, as the reference takes it.

    A ``PlanBuilder`` hashes its identity fixed at plan time: the CSR
    triplet's bytes (a copy to the host), then ``(shape, backend, tile,
    bsr_block, chain_op, inner_backend=None)``.  Lazily built substrates,
    the quant mode the range check may demote and memoised fingerprints are
    left out: they change legitimately after caching.  A ``PlanArtifact``
    hashes its ``torch.utils._pytree`` leaves, then ``(meta.topology,
    meta.backend)``.  Anything else hashes its leaves.  Never raises."""
    h = hashlib.sha1()
    if hasattr(value, "csr") and hasattr(value, "backend") \
            and hasattr(value, "thresholds"):
        csr = value.csr
        for t in (csr.indptr, csr.indices, csr.data):
            h.update(_dtype_name(t))
            h.update(_tensor_bytes(t))
        _fold(h, (tuple(int(s) for s in csr.shape), value.backend,
                  int(value.tile), tuple(value.bsr_block), value.chain_op,
                  None))
        return h.hexdigest()
    for leaf in pytree.tree_leaves(value):
        _fold(h, leaf)
    if hasattr(value, "substrates") and hasattr(value, "meta"):
        _fold(h, (value.meta.topology, value.meta.backend))
    return h.hexdigest()
