"""Mixture-of-Experts with the paper's workload-balancing principle applied
to token→expert dispatch; counterpart of ``repro.models.moe`` on one device.

The dispatch problem is the paper's problem: tokens (nonzeros) distribute
unevenly over experts (rows).  The paths mirror the paper's 2x2:

* ``onehot`` (parallel-reduction analogue): dispatch/combine as dense
  one-hot einsums — efficient only when tokens-per-expert is small;
* ``sort`` (sequential/merge analogue): tokens ranked within their expert
  into capacity-bounded slots, overflow dropped.  On one device (one group)
  it is ``moe_spmm``: dispatch ``D @ X`` and combine ``G @ H`` as SpMMs over
  balanced patterns through ``pattern_matmul``, so K1 runs them on the card;
  with several groups it is the grouped scatter, in plain PyTorch;
* the pinned half (serving): a topology fixed ahead of time, its dispatch
  and combine frozen into ``PlanArtifact``s, executed with the gates as a
  live value stream (``moe_spmm_pinned``).

``dispatch="auto"`` applies the selection rule with the shape of the
paper's Fig. 4: small total work → one-hot, large → sort.

The K1 kernels need a slab's rows non-decreasing (a run that no other tile
adds to is written with a plain store), so ``moe_spmm`` builds its dispatch
pattern in slot order (padding row last), where the reference keeps token
order; the sum is the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.plan import execute, execute_pattern
from .config import MoEConfig
from .sharding_ctx import moe_groups

#: MoE layer calls by the dispatch path that ran since process start:
#: ``"onehot"``, ``"sort"`` (the grouped scatter), ``"spmm"``, ``"pinned"``
DISPATCH_PATHS = dict.fromkeys(("onehot", "sort", "spmm", "pinned"), 0)


def select_dispatch(tokens: int, cfg: MoEConfig) -> str:
    if cfg.dispatch != "auto":
        return cfg.dispatch
    # paper Insight 3 analogue: total work per expert large → occupancy is
    # already high → the cheap (sort) path; tiny expert batches → one-hot
    tokens_per_expert = tokens * cfg.top_k / cfg.num_experts
    return "onehot" if tokens_per_expert <= 8 else "sort"


def capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(np.ceil(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts))
    return max(8, -(-c // 8) * 8)


def router(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: (T, d) → (gates (T, k), experts (T, k) int32, aux_loss).  Inside
    ``record_routing`` the top-k ids go to the sink as a host copy."""
    logits = x.float() @ p["w_router"].float()
    gates_all = torch.softmax(logits, dim=-1)
    gate, idx = _topk_rows(gates_all, cfg.top_k)
    ctx = getattr(_ROUTING, "ctx", None)
    if ctx is not None:
        sink, tag = ctx
        sink.record_routing(tag, idx.detach().cpu().numpy())
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balancing aux loss (Switch-style): E * <f, p>
    me = gates_all.mean(0)
    ce = F.one_hot(idx.long(), cfg.num_experts).float().sum((0, 1))
    ce = ce / ce.sum().clamp_min(1.0)
    aux = cfg.num_experts * torch.sum(me * ce)
    return gate, idx, aux


def _topk_rows(x: torch.Tensor, k: int):
    """Row-wise top-k by k iterative argmaxes, the first index winning a
    tie, as the reference (``torch.topk`` orders ties otherwise)."""
    vals, idxs = [], []
    cur = x
    for _ in range(k):
        i = torch.argmax(cur, dim=-1)
        vals.append(cur.gather(-1, i[..., None])[..., 0])
        idxs.append(i.to(torch.int32))
        cur = cur.masked_fill(F.one_hot(i, x.shape[-1]).bool(), float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _expert_ffn(p: dict, h: torch.Tensor) -> torch.Tensor:
    """h: (E, C, d) → (E, C, d), SwiGLU per expert, batched on the E axis;
    the up and gate products taken to f32 before the activation."""
    w = lambda name: p[name].to(h.dtype)
    up = torch.bmm(h, w("w_up")).float()
    gate = torch.bmm(h, w("w_gate")).float()
    act = (F.silu(gate) * up).to(h.dtype)
    return torch.bmm(act, w("w_down")).to(h.dtype)


def _expert_ffn_grouped(p: dict, h: torch.Tensor) -> torch.Tensor:
    """h: (G, E, C, d) → (G, E, C, d)."""
    g, e, c, d = h.shape
    flat = h.transpose(0, 1).reshape(e, g * c, d)
    return _expert_ffn(p, flat).reshape(e, g, c, d).transpose(0, 1)


def _slots(idx: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """Each (token, choice)'s slot ``expert·cap + rank`` in token order
    (``(..., T·k)`` int64 for ``idx`` ``(..., T·k)``), ``e·cap`` past the
    capacity: a stable sort by expert, the rank within the expert."""
    flat_e = idx.long()
    sj = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, sj)
    experts = torch.arange(e, device=idx.device).expand(
        se.shape[:-1] + (e,)).contiguous()
    first = torch.searchsorted(se, experts)
    pos = torch.arange(se.shape[-1], device=idx.device) - first.gather(-1, se)
    slot_s = torch.where(pos < cap, se * cap + pos, e * cap)
    return torch.empty_like(slot_s).scatter_(-1, sj, slot_s)


def _as_tiles(a: torch.Tensor, tile: int, fill) -> torch.Tensor:
    """A flat stream as ``(n_tiles, tile)`` slabs, the tail ``fill``."""
    pad = -(-a.numel() // tile) * tile - a.numel()
    return F.pad(a, (0, pad), value=fill).reshape(-1, tile)


def dispatch_pattern(slot_u: torch.Tensor, k: int, e: int, cap: int,
                     tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch matrix D (E·C, T)'s ``(rows, cols)`` slabs, int32: one
    slot a (token, choice), in slot order (a stable argsort of ``slot_u``),
    so the rows are non-decreasing and the dropped entries (row ``e·cap``,
    the padding row) come last."""
    order = torch.argsort(slot_u, stable=True)
    tok = order // k
    return (_as_tiles(slot_u[order].to(torch.int32), tile, e * cap),
            _as_tiles(tok.to(torch.int32), tile, 0))


def combine_pattern(slot_u: torch.Tensor, t: int, k: int,
                    tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The combine matrix G (T, E·C+1)'s ``(rows, cols)`` slabs, int32:
    rows the tokens (non-decreasing already), columns the slots (a dropped
    entry reads the zero row ``e·cap``); padding row ``t``."""
    tok = torch.arange(t * k, device=slot_u.device) // k
    return (_as_tiles(tok.to(torch.int32), tile, t),
            _as_tiles(slot_u.to(torch.int32), tile, 0))


def moe_spmm(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """Dispatch/combine as SpMM through ``pattern_matmul``.

    The token→expert dispatch matrix is the paper's skewed short-row regime
    (rows = expert·capacity slots, at most one nonzero each; hot experts =
    long row runs): dispatch is ``D @ X`` with ``D (E·C, T)``, combine is
    ``G @ H`` with ``G (T, E·C+1)`` carrying the gates, both balanced
    patterns of ``min(512, T·k)`` slots a tile, differentiable in X, H and
    the gates.  On the card each is one K1 launch (its ``nb_sr`` design at
    N = d > 4).  Slotting and capacity are ``moe_sort``'s."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(t, cfg)
    gate, idx, aux = router(p, x, cfg)                         # (T, k) each
    slot_u = _slots(idx.reshape(t * k), e, cap)                # token order
    tile = max(1, min(512, t * k))
    ones = torch.ones(t * k, dtype=torch.float32, device=x.device)

    DISPATCH_PATHS["spmm"] += 1
    rows, cols = dispatch_pattern(slot_u, k, e, cap, tile)
    ein = execute_pattern(rows, cols, _as_tiles(ones, tile, 0.0),
                          (e * cap, t), x)                     # (E·C, d)
    h = _expert_ffn(p, ein.reshape(e, cap, d).to(x.dtype))
    # combine: rows = token, cols = slot (dropped → the zero row), vals = gate
    hpad = torch.cat([h.reshape(e * cap, d), h.new_zeros((1, d))])
    rows, cols = combine_pattern(slot_u, t, k, tile)
    y = execute_pattern(rows, cols,
                        _as_tiles(gate.reshape(t * k).float(), tile, 0.0),
                        (t, e * cap + 1), hpad)                # (T, d)
    return y.to(x.dtype), aux


def moe_sort(p: dict, x: torch.Tensor, cfg: MoEConfig,
             groups: int | None = None):
    """Sort-based (workload-balanced row-binning) dispatch in the GShard
    grouped formulation: tokens split into G groups, each group slots its
    own tokens with a group-local capacity.  One group (one device:
    ``moe_groups()`` is 1) routes to ``moe_spmm`` — same slotting, same
    output; several (``groups=``) run the grouped scatter in plain
    PyTorch.  x: (T, d)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g = groups if groups is not None else moe_groups()
    g = max(1, min(g, t))
    while t % g:
        g //= 2
    if g <= 1:
        return moe_spmm(p, x, cfg)
    DISPATCH_PATHS["sort"] += 1
    tg = t // g
    cap = capacity(tg, cfg)
    gate, idx, aux = router(p, x, cfg)                         # (T, k) each
    tgk = tg * k
    slot_u = _slots(idx.reshape(g, tgk), e, cap)               # (G, tg·k)
    flat_g = gate.reshape(g, tgk)
    xrep = x.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(g, tgk, d)
    buf = x.new_zeros((g, e * cap + 1, d)).scatter(
        1, slot_u[..., None].expand(g, tgk, d), xrep)          # overflow → last row
    h = _expert_ffn_grouped(p, buf[:, :-1].reshape(g, e, cap, d))
    h = h.reshape(g, e * cap, d)
    # scatter expert outputs straight back to token-order stream positions
    u_of_slot = torch.full((g, e * cap + 1), tgk, dtype=torch.long,
                           device=x.device).scatter(
        1, slot_u, torch.arange(tgk, device=x.device).expand(g, tgk))
    out_u = x.new_zeros((g, tgk + 1, d)).scatter(
        1, u_of_slot[:, :-1, None].expand(g, e * cap, d), h)[:, :-1]
    # dropped tokens were never written → rows stay zero; gates weight the rest
    contrib = out_u * flat_g[..., None].to(x.dtype)
    return contrib.reshape(g, tg, k, d).sum(dim=2).reshape(t, d), aux


def moe_onehot(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """One-hot-einsum (parallel-reduction) dispatch — the GShard form.
    Only sane for small T (the selector guards this)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(t, cfg)
    DISPATCH_PATHS["onehot"] += 1
    gate, idx, aux = router(p, x, cfg)
    onehot = F.one_hot(idx.long(), e)                          # (T, k, E)
    pos = torch.cumsum(onehot.reshape(t * k, e), dim=0).reshape(t, k, e) - 1
    pos = torch.sum(pos * onehot, dim=-1)                      # (T, k)
    keep = pos < cap
    disp = (onehot.to(x.dtype)[..., None]
            * F.one_hot(torch.where(keep, pos, cap), cap + 1)
            .to(x.dtype)[..., None, :])[..., :cap]             # (T, k, E, C)
    expert_in = torch.einsum("td,tkec->ecd", x, disp)
    h = _expert_ffn(p, expert_in)
    comb = disp * gate[..., None, None].to(x.dtype)
    y = torch.einsum("ecd,tkec->td", h, comb)
    return y, aux


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: (..., d) → (..., d), aux.  Flattens leading dims into tokens.
    Inside a ``pinned_dispatch`` scope whose topology has this many tokens
    the pinned path runs instead of the router-driven dispatch."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    pinned = current_pinned()
    if pinned is not None and flat.shape[0] == pinned.t:
        y, aux = moe_spmm_pinned(p, flat, cfg, pinned)
        return y.reshape(*lead, x.shape[-1]), aux
    path = select_dispatch(flat.shape[0], cfg)
    fn = {"onehot": moe_onehot, "spmm": moe_spmm}.get(path, moe_sort)
    y, aux = fn(p, flat, cfg)
    return y.reshape(*lead, x.shape[-1]), aux


# ---------------------------------------------------------------------------
# topology-pinned dispatch: the offline-plan / online-execute half of MoE
# serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class PinnedDispatch:
    """Frozen MoE dispatch bundle for one concrete token→expert topology.

    ``dispatch`` / ``combine`` are ``PlanArtifact``s over the slotting
    patterns (values: 1.0 baked / gates streamed live); ``idx`` re-reads
    the router's logits at the pinned experts, ``perm`` reorders the flat
    (T, k) gates into the combine pattern's CSR nonzero order."""

    dispatch: Any            # PlanArtifact, (E·C, T), values baked at 1.0
    combine: Any             # PlanArtifact, (T, E·C), values = live gates
    idx: torch.Tensor        # (T, k) pinned expert ids
    perm: torch.Tensor       # (combine_nnz,) flat t·k+j per CSR slot
    e: int
    cap: int
    t: int
    k: int


_PINNED = threading.local()


@contextlib.contextmanager
def pinned_dispatch(plans: PinnedDispatch):
    """Route ``moe_apply`` through the pre-planned dispatch in this scope."""
    prev = getattr(_PINNED, "plans", None)
    _PINNED.plans = plans
    try:
        yield
    finally:
        _PINNED.plans = prev


def current_pinned() -> Optional[PinnedDispatch]:
    return getattr(_PINNED, "plans", None)


class RoutingSink:
    """Host-side collector of routing observations: per-request prefill
    top-k ids (keyed by an integer tag) and per-call pinned-vs-router match
    fractions from ``moe_spmm_pinned``.  The port runs eagerly, so the
    router hands each observation over as a host copy when it is made
    (the reference ships it out of a compiled step by
    ``jax.debug.callback``).  Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._routing: dict = {}            # tag -> [(T, k) int arrays]
        self._drift: list = []              # [(T,) match fractions]

    def record_routing(self, tag, idx) -> None:
        with self._lock:
            self._routing.setdefault(int(tag), []).append(
                np.asarray(idx, np.int32))

    def record_drift(self, match) -> None:
        with self._lock:
            self._drift.append(np.asarray(match, np.float32))

    def drain_routing(self, tag) -> list:
        with self._lock:
            return self._routing.pop(int(tag), [])

    def drain_drift(self) -> list:
        with self._lock:
            out, self._drift = self._drift, []
            return out


_ROUTING = threading.local()


@contextlib.contextmanager
def record_routing(sink: RoutingSink, tag):
    """Send every ``router()`` call's top-k ids in this scope to ``sink``
    under ``tag``."""
    prev = getattr(_ROUTING, "ctx", None)
    _ROUTING.ctx = (sink, tag)
    try:
        yield
    finally:
        _ROUTING.ctx = prev


@contextlib.contextmanager
def drift_scope(sink: RoutingSink):
    """Send ``moe_spmm_pinned``'s pinned-vs-router match fractions in this
    scope to ``sink``."""
    prev = getattr(_ROUTING, "drift", None)
    _ROUTING.drift = sink
    try:
        yield
    finally:
        _ROUTING.drift = prev


def dominant_topology(idx_arrays, num_experts: int, k: int) -> Optional[tuple]:
    """Collapse captured prefill routing (a list of (T, k) expert-id arrays,
    one per MoE layer) into the request's dominant top-k expert set: the k
    most-frequently-chosen experts, ties broken by expert id.  Returns a
    sorted id tuple."""
    if not idx_arrays:
        return None
    counts = np.zeros(num_experts, np.int64)
    for a in idx_arrays:
        counts += np.bincount(np.asarray(a).reshape(-1),
                              minlength=num_experts)[:num_experts]
    order = np.lexsort((np.arange(num_experts), -counts))
    return tuple(sorted(int(i) for i in order[:k]))


def dispatch_plan_spec(topology, cfg: MoEConfig, *,
                       n_hint: int | None = None,
                       backend: str | None = None, device=None):
    """Resolve a topology into its cache key and build kwargs without
    building.  The backend (scope or device), the device and the selector
    thresholds are resolved here, on the caller's thread, and keyed: the
    artifacts freeze them, so a recalibration (``thresholds_version``)
    rebuilds.  ``device=None`` is the card."""
    from ..core import registry
    from ..core.cache import thresholds_version
    from ..core.selector import default_thresholds

    topo = tuple(tuple(int(i) for i in row) for row in topology)
    dev = registry.resolve_device(device)
    backend = backend or registry.default_backend(dev)
    th = default_thresholds()
    key = ("moe_pinned", topo, cfg.num_experts, cfg.top_k,
           float(cfg.capacity_factor), backend, str(dev), n_hint,
           thresholds_version(th))
    build_kwargs = dict(topo=topo, cfg=cfg, n_hint=n_hint, backend=backend,
                        thresholds=th, device=dev)
    return key, build_kwargs


def build_dispatch_plans(*, topo, cfg, n_hint, backend, thresholds=None,
                         device=None) -> PinnedDispatch:
    """The cache-free build half of ``dispatch_plan_spec``."""
    return _build_pinned(topo, cfg, n_hint=n_hint, backend=backend,
                         thresholds=thresholds, device=device)


def dispatch_plans(topology, cfg: MoEConfig, *, cache=None,
                   n_hint: int | None = None, backend: str | None = None,
                   device=None) -> PinnedDispatch:
    """Build (or fetch) the ``PinnedDispatch`` for a concrete topology:
    per-token tuples of distinct expert ids, e.g. ``((0, 3), (3, 5))``.
    Slotting replicates ``moe_spmm``, so pinning the router's own top-k
    reproduces its output.  Cached in ``cache`` (the process default when
    None) under ``dispatch_plan_spec``'s key."""
    from ..core.cache import DEFAULT_CACHE

    key, kw = dispatch_plan_spec(topology, cfg, n_hint=n_hint,
                                 backend=backend, device=device)
    cache = cache if cache is not None else DEFAULT_CACHE
    return cache.get_or_build(key, lambda: build_dispatch_plans(**kw))


def _build_pinned(topo: tuple, cfg: MoEConfig, *, n_hint, backend,
                  thresholds=None, device=None) -> PinnedDispatch:
    from ..api import sparse
    from ..core.formats import csr_from_coo

    idx = np.asarray(topo, np.int32)                           # (T, k)
    t, k = idx.shape
    e = cfg.num_experts
    cap = capacity(t, cfg)
    tk = t * k
    # slotting, exactly as moe_spmm: stable sort by expert, rank-in-expert,
    # overflow past the capacity drops
    flat_e = idx.reshape(tk)
    order = np.argsort(flat_e, kind="stable")
    se = flat_e[order]
    first = np.searchsorted(se, np.arange(e))
    pos = np.arange(tk) - first[se]
    slot_s = np.where(pos < cap, se.astype(np.int64) * cap + pos, e * cap)
    slot_u = np.empty(tk, np.int64)
    slot_u[order] = slot_s
    tok = np.arange(tk) // k
    keep = slot_u < e * cap

    ones = np.ones(keep.sum(), np.float32)
    d_csr = csr_from_coo(slot_u[keep], tok[keep], ones, (e * cap, t),
                         device=device)
    c_csr = csr_from_coo(tok[keep], slot_u[keep], ones, (t, e * cap),
                         device=device)
    # gate stream position per combine-CSR slot: csr_from_coo sorts kept
    # entries by (token, slot)
    flat_keep = np.flatnonzero(keep)
    perm = flat_keep[np.lexsort((slot_u[keep], tok[keep]))]
    fin = dict(n=n_hint) if n_hint is not None else {}
    kw = dict(device=device, backend=backend, thresholds=thresholds,
              cache=False)
    dev = d_csr.device
    return PinnedDispatch(
        dispatch=sparse(d_csr, **kw).finalize(**fin),
        combine=sparse(c_csr, **kw).finalize(**fin),
        idx=torch.from_numpy(idx).to(dev),
        perm=torch.from_numpy(perm.astype(np.int64)).to(dev),
        e=e, cap=cap, t=t, k=k)


def moe_spmm_pinned(p: dict, x: torch.Tensor, cfg: MoEConfig,
                    pinned: PinnedDispatch):
    """Online half of the pinned dispatch: two planned SpMMs, no sorting.
    The router scores only the pinned experts — the softmax over their
    logits is the full softmax renormalised to that set, so with the
    router's own top-k pinned this matches ``moe_spmm``.  The gates ride
    the combine artifact as a live value stream."""
    t, d = x.shape
    if t != pinned.t:
        raise ValueError(f"pinned dispatch was planned for T={pinned.t} "
                         f"tokens; got {t}")
    DISPATCH_PATHS["pinned"] += 1
    logits = x.float() @ p["w_router"].float()
    sink = getattr(_ROUTING, "drift", None)
    if sink is not None:
        # drift check: per-token overlap of the router's true top-k with
        # the pinned set, handed to the host
        _, true_idx = _topk_rows(logits, cfg.top_k)
        pin_oh = F.one_hot(pinned.idx.long(), cfg.num_experts).float().sum(1)
        true_oh = F.one_hot(true_idx.long(), cfg.num_experts).float().sum(1)
        match = (pin_oh * true_oh).sum(-1) / cfg.top_k          # (T,)
        sink.record_drift(match.detach().cpu().numpy())
    gate = torch.softmax(logits.gather(1, pinned.idx.long()), dim=-1)
    ein = execute(pinned.dispatch, x.contiguous())             # (E·C, d)
    h = _expert_ffn(p, ein.reshape(pinned.e, pinned.cap, d).to(x.dtype))
    y = execute(pinned.combine, h.reshape(pinned.e * pinned.cap, d),
                vals=gate.reshape(-1).index_select(0, pinned.perm))
    return y.to(x.dtype), torch.zeros((), dtype=torch.float32,
                                      device=x.device)
