"""The attention front door: spec → cached plan → execute; counterpart of
``repro.attention.module``.

``sparse_attention`` is the functional entry (Q/K/V with any number of
leading dims), ``SparseAttention`` the layer-style handle that holds one
spec.  Both route every mask through ``cached_plan``, so one
``PlanBuilder`` (substrates, prep) is shared by every layer, head and call
that presents the same (spec, thresholds, backend, device); the
``PlanCache`` counters make that sharing observable (DESIGN.md §10).

The plan lives on the operands' device.  With no operands (``attention_plan``,
``SparseAttention.plan``) the device defaults to CUDA and raises without
one, as ``sparse()`` does; ``device="cpu"`` is the explicit way to the CPU.

``scoped_plan_cache`` redirects attention plan builds into a caller's cache
for the dynamic extent of a call, without threading a cache argument
through the model code.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.cache import DEFAULT_CACHE, PlanCache, cached_plan
from ..core.formats import CSR
from ..core.plan import execute_attention, plan
from ..core.registry import resolve_device
from ..core.selector import SelectorThresholds

from .patterns import AttentionMask, AttentionSpec, build_mask

_SCOPED = threading.local()


@contextlib.contextmanager
def scoped_plan_cache(cache: PlanCache):
    """Make ``cache`` the default attention plan cache in the dynamic extent
    (thread-local; nestable — innermost wins)."""
    stack = getattr(_SCOPED, "stack", None)
    if stack is None:
        stack = _SCOPED.stack = []
    stack.append(cache)
    try:
        yield cache
    finally:
        stack.pop()


def _resolve_cache(cache) -> PlanCache | None:
    """Explicit cache > scoped cache > process default; ``False`` disables."""
    if cache is False:
        return None
    if isinstance(cache, PlanCache):
        return cache
    stack = getattr(_SCOPED, "stack", None)
    if stack:
        return stack[-1]
    return DEFAULT_CACHE


# masks are deterministic functions of their frozen, hashable specs:
# memoize the numpy compilation, and each mask's CSR per device
_MASKS: dict[AttentionSpec, AttentionMask] = {}
_DEVICE_CSRS: dict[tuple, CSR] = {}
_MASKS_LOCK = threading.Lock()


def spec_mask(spec: AttentionSpec) -> AttentionMask:
    """The compiled mask of ``spec`` (its CSR on the CPU), built once."""
    with _MASKS_LOCK:
        mask = _MASKS.get(spec)
        if mask is None:
            mask = _MASKS[spec] = build_mask(spec)
    return mask


def _spec_csr(spec: AttentionSpec, device: torch.device) -> CSR:
    mask = spec_mask(spec)
    with _MASKS_LOCK:
        csr = _DEVICE_CSRS.get((spec, device))
        if csr is None:
            csr = _DEVICE_CSRS[(spec, device)] = mask.csr.to(device)
    return csr


def attention_plan(spec: AttentionSpec, *,
                   thresholds: SelectorThresholds | None = None,
                   backend: str | None = None, device=None, cache=True,
                   mesh=None):
    """The ``PlanBuilder`` for a spec's token-level mask on ``device``
    (CUDA for ``None``), via the resolved PlanCache (``cache=False`` builds
    uncached).  ``chain_op="attn"`` segments attention plans from
    same-pattern chain and SpMM plans.  ``mesh`` plans it on the sharded
    backend (its partition by the mask's statistics)."""
    csr = _spec_csr(spec, resolve_device(device))
    resolved = _resolve_cache(cache)
    if resolved is None:
        return plan(csr, thresholds=thresholds, backend=backend,
                    chain_op="attn", mesh=mesh)
    return cached_plan(csr, cache=resolved, backend=backend,
                       thresholds=thresholds, chain_op="attn", mesh=mesh)


def sparse_attention(spec: AttentionSpec, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, *, scale: float | None = None,
                     bias: torch.Tensor | None = None,
                     thresholds: SelectorThresholds | None = None,
                     backend: str | None = None,
                     cache=True, mesh=None) -> torch.Tensor:
    """Block-sparse attention ``softmax_mask(scale * Q Kᵀ + bias) @ V``.

    ``q``/``k``/``v`` are ``(..., seq, head_dim)`` with matching leading
    dims (batch, heads, ...) on one device; each leading slice runs through
    the *same* plan, so the mask's substrate is built once.  ``bias`` is an
    optional flat ``(nnz,)`` per-edge additive stream in CSR order, shared
    across leading dims.  Rows the mask leaves fully masked give exact-zero
    outputs.  ``mesh`` runs it on the sharded backend (each shard's block
    layout its own; no bias: a bias raises ``ShardedBiasError``)."""
    if q.shape != k.shape or q.shape[:-1] != v.shape[:-1]:
        raise ValueError(f"q/k/v leading shapes must match; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.ndim < 2 or q.shape[-2] != spec.seq:
        raise ValueError(f"spec.seq={spec.seq} but operands have shape "
                         f"{tuple(q.shape)}")
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
    p = attention_plan(spec, thresholds=thresholds, backend=backend,
                       device=q.device, cache=cache, mesh=mesh)
    if q.ndim == 2:
        return execute_attention(p, q, k, v, scale=scale, bias=bias)
    lead = q.shape[:-2]
    qf = q.reshape((-1,) + q.shape[-2:])
    kf = k.reshape((-1,) + k.shape[-2:])
    vf = v.reshape((-1,) + v.shape[-2:])
    outs = [execute_attention(p, qf[i], kf[i], vf[i], scale=scale, bias=bias)
            for i in range(qf.shape[0])]
    return torch.stack(outs).reshape(lead + (spec.seq, v.shape[-1]))


class SparseAttention:
    """One spec, one (lazily built, cached) plan, many calls.

    The layer-style handle transformer code holds per attention module:
    construction is free; the mask is built on first use and shared
    through the PlanCache with every other module of the same spec."""

    def __init__(self, spec: AttentionSpec, *,
                 thresholds: SelectorThresholds | None = None,
                 backend: str | None = None, device=None, cache=True,
                 mesh=None):
        self.spec = spec
        self.mesh = mesh
        self.thresholds = thresholds
        self.backend = backend
        self.device = device
        self.cache = cache

    @property
    def mask(self) -> AttentionMask:
        return spec_mask(self.spec)

    @property
    def plan(self):
        """The plan on this handle's device (CUDA when none was given)."""
        return attention_plan(self.spec, thresholds=self.thresholds,
                              backend=self.backend, device=self.device,
                              cache=self.cache, mesh=self.mesh)

    def __call__(self, q, k, v, *, scale=None, bias=None):
        if self.device is not None and q.device != resolve_device(self.device):
            raise ValueError(f"operands lie on {q.device}, the layer on "
                             f"{resolve_device(self.device)}")
        return sparse_attention(self.spec, q, k, v, scale=scale, bias=bias,
                                thresholds=self.thresholds,
                                backend=self.backend, cache=self.cache,
                                mesh=self.mesh)

    def __repr__(self) -> str:
        s = self.spec
        return (f"SparseAttention({s.kind}, seq={s.seq}, block={s.block}, "
                f"window={s.window}, causal={s.causal})")
