"""The port's public facade; counterpart of ``repro.api`` (forward path).

    from repro_torch import api

    A = api.sparse(csr)              # plan once, on the card, cached by topology
    y = A @ x                        # adaptive SpMV / SpMM through the Hopper kernels
    y = A.with_values(stream) @ x    # same plan, live value stream;
                                     # differentiable in stream and x
    y = api.pattern_matmul(rows, cols, vals, shape, x)
                                     # bare balanced pattern, live values:
                                     # the sparse-weight training entry

    A = api.sparse(csr, device="cpu")    # plain "torch" backend on the CPU
    W = api.sparse(w_csr, backend="bsr", bsr_block=(8, 128))
                                         # block-sparse weight: K11 on BSR
    Q = api.sparse(csr, quant="int8")    # int8 (or "fp8") value codes, one
                                         # f32 scale a tile, decoded in the
                                         # NB kernels' registers
    with api.use_backend("torch"):       # scoped backend, no kwarg threading
        y = api.sparse(csr) @ x

    e = A.sddmm(q, k)                    # (q @ k.T) at the edges, CSR order
    y = api.sparse_chain(adj, q, k, v, alpha=0.125)   # graph attention:
                                         # softmax_rows(mask(α·q kᵀ)) @ v

    spec = api.sliding_window(8192, 16, block=64, causal=True)
    y = api.sparse_attention(spec, q, k, v, bias=b)   # (..., seq, d) heads:
                                         # softmax_mask(q kᵀ/√d + b) @ v

    th, report = api.calibrate_backend("th.json")    # time the 2x2 space on
                                         # this card, grid-search Fig. 4's
                                         # thresholds (paper §2.2)
    th = api.autotune_geometry(csr, ns=(4, 128), impl="nb_sr")
                                         # the nnz quota per N-bucket,
                                         # timed from CUDA graphs
    art = A.finalize(n=x.shape[1])       # frozen PlanArtifact, no host work
    y = api.execute(art, x)              # left at call time: CUDA-graph safe

    mesh = make_local_mesh(4, 1, devices=["cuda:0"] * 4)
    S = api.sparse(csr, mesh=mesh)       # sharded: a row or nnz split by the
    y = S @ x                            # statistics, K1-K8 a shard, concat
                                         # or psum (core/shard.py)
    with api.use_mesh(mesh):             # scoped mesh, like use_backend
        y = api.sparse(csr) @ x

    A = api.sparse(dirty, validate="repair")  # sort / coalesce / clip / zero
    y = A.matmul(x, sentinel="sanitize")     # non-finite lanes zeroed
    api.health()                         # failures, breakers, demotions

``sparse()`` runs on the card unless the caller passes ``device="cpu"``: by
default the data go to CUDA and the ``"hopper"`` backend runs, and without a
CUDA device the call raises instead of carrying on on the CPU.  A kernel
that fails to build or launch on the card raises, and the guardrails count
it: ``health()`` shows every failure
(``kernel_failure:hopper:<kernel>``).  Only on CPU operands does the
ladder reroute a failing call to the ``"torch"`` entry.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .attention import (AttentionMask, AttentionSpec, SparseAttention,
                        attention_plan, bigbird, build_mask, dense_attention,
                        from_block_mask, scoped_plan_cache, sliding_window,
                        sparse_attention)
from .core.cache import (DEFAULT_CACHE, PlanCache, cached_plan,
                                    pattern_fingerprint)
from .core.formats import CSR, csr_from_dense
from .core.guardrails import (HEALTH, NumericFault, PatternError, grad_scope,
                              inspect_csr, plan_digest, repair_csr,
                              sentinel_scope, validate_csr)
from .core.plan import (PlanArtifact, PlanBuildError, PlanBuilder, execute,
                        execute_chain, execute_pattern, execute_sddmm, plan)
from .core.registry import backend_scope, default_backend, resolve_device
from .core.shard import default_shard_axis
from .core.selector import (SelectorThresholds, TileGeometry,
                            default_thresholds, load_thresholds,
                            save_thresholds)
from .core.selector import calibrate as calibrate  # noqa: F401 (re-export)
from .core.stats import MatrixStats
from .runtime.faults import (FaultInjector, FaultSpec, InjectedFault,
                             inject_faults)
from .runtime.retry import RetryPolicy, TaskOutcome, run_with_retry

__all__ = ["SparseMatrix", "sparse", "sddmm", "sparse_chain", "pattern_matmul",
           "use_backend", "use_mesh", "scoped_mesh", "calibrate",
           "calibrate_backend",
           "autotune_geometry", "autotune_overlap", "autotune_quant",
           "autotune_chain", "autotune_attention",
           "cache_stats", "clear_cache", "PlanArtifact", "PlanBuilder",
           "PlanCache", "SelectorThresholds", "TileGeometry", "execute",
           "save_thresholds", "load_thresholds",
           # block-sparse attention (DESIGN.md §10)
           "AttentionMask", "AttentionSpec", "SparseAttention",
           "attention_plan", "bigbird", "build_mask", "dense_attention",
           "from_block_mask", "scoped_plan_cache", "sliding_window",
           "sparse_attention",
           # fault injection and retry (the reference's serving hardening
           # exports but Request and ServeEngine, DESIGN.md §11)
           "FaultInjector", "FaultSpec", "InjectedFault", "RetryPolicy",
           "TaskOutcome", "run_with_retry", "PlanBuildError",
           # execution guardrails (DESIGN.md §12)
           "PatternError", "NumericFault", "validate_csr", "inspect_csr",
           "repair_csr", "plan_digest", "sentinel_scope", "grad_scope",
           "inject_faults", "health", "reset_health", "configure_guardrails"]

use_backend = backend_scope

_MESH = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, axis: str | None = None):
    """Make ``mesh`` the default of every ``sparse()`` in the dynamic extent
    of this thread: matrices plan onto the sharded backend without a
    ``mesh=`` at each call site.  ``axis`` pins the shard axis."""
    stack = getattr(_MESH, "stack", None)
    if stack is None:
        stack = _MESH.stack = []
    stack.append((mesh, axis))
    try:
        yield
    finally:
        stack.pop()


def scoped_mesh() -> tuple:
    """``(mesh, axis)`` of the innermost ``use_mesh``, or ``(None, None)``."""
    stack = getattr(_MESH, "stack", None)
    return stack[-1] if stack else (None, None)

#: the training entry of the facade: differentiable SpMM over a bare
#: balanced pattern with live values (no CSR, no plan object)
pattern_matmul = execute_pattern


class SparseMatrix:
    """A sparse operand: a (possibly cache-shared) plan plus this matrix's
    value stream.  Immutable; ``with_values`` returns a new handle."""

    def __init__(self, plan_obj: PlanBuilder,
                 values: torch.Tensor | None = None,
                 cache: PlanCache | None = None):
        self._plan = plan_obj
        self._values = values
        self._cache = cache

    @property
    def plan(self) -> PlanBuilder:
        return self._plan

    @property
    def shape(self) -> tuple:
        return tuple(self._plan.csr.shape)

    @property
    def nnz(self) -> int:
        return self._plan.csr.nnz

    @property
    def stats(self) -> MatrixStats:
        return self._plan.stats

    @property
    def backend(self) -> str:
        return self._plan.backend

    @property
    def device(self) -> torch.device:
        return self._plan.device

    @property
    def values(self) -> torch.Tensor:
        """The effective CSR-ordered nonzero value stream."""
        return self._values if self._values is not None else self._plan.csr.data

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def topology_key(self) -> str:
        return self._plan.topology_key()

    def __repr__(self) -> str:
        m, k = self.shape
        live = "live" if self._values is not None else "baked"
        return (f"SparseMatrix({m}x{k}, nnz={self.nnz}, backend="
                f"{self.backend!r}, device={self.device}, values={live})")

    def _on_device(self, **operands: torch.Tensor) -> None:
        for name, t in operands.items():
            if t.device != self.device:
                raise ValueError(f"{name} lies on {t.device}, the matrix on "
                                 f"{self.device}")

    def matmul(self, x: torch.Tensor, *, impl: str | None = None,
               backend: str | None = None,
               sentinel: str | None = None) -> torch.Tensor:
        """``A @ x`` with per-call overrides: ``impl`` forces a logical
        kernel, ``backend`` another backend for this call, ``sentinel`` a
        non-finite check of the output (``"raise"`` / ``"sanitize"`` /
        ``"fallback"``, DESIGN.md §12).  ``x`` must lie on the matrix's
        device."""
        self._on_device(x=x)
        return execute(self._plan, x, vals=self._values, impl=impl,
                       backend=backend, sentinel=sentinel)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmul(x)

    def sddmm(self, a: torch.Tensor, b: torch.Tensor, *,
              backend: str | None = None) -> torch.Tensor:
        """Sample ``a @ b.T`` at this operand's nonzero positions: the
        ``(nnz,)`` CSR-ordered f32 score stream (feed it to ``with_values``
        for an attention-weighted operand).  Only the pattern is read."""
        self._on_device(a=a, b=b)
        return execute_sddmm(self._plan, a, b, backend=backend)

    def chain(self, a: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
              transform: str = "softmax", alpha: float | None = None,
              backend: str | None = None) -> torch.Tensor:
        """The SDDMM→SpMM chain: score ``a @ b.T`` at the nonzero positions,
        transform per row (``identity`` / ``scale`` / masked ``softmax``
        of ``alpha`` times the scores) and aggregate ``x``.  On the card the
        edge scores stay on chip (kernels K7 and K8).  Only the pattern is
        read."""
        self._on_device(a=a, b=b, x=x)
        return execute_chain(self._plan, a, b, x, transform=transform,
                             alpha=alpha, backend=backend)

    def with_values(self, stream: torch.Tensor) -> "SparseMatrix":
        """Same pattern and plan, new CSR-ordered nonzero values.  The
        stream keeps its autograd graph: ``A.with_values(v) @ x`` is
        differentiable in ``v``.  On a quantized plan the stream is
        quantized at each call (the gradient passes straight through)."""
        stream = torch.as_tensor(stream, device=self.device)
        if stream.numel() != self.nnz:
            raise ValueError(f"value stream has {stream.numel()} entries but "
                             f"the pattern has {self.nnz} nonzeros")
        return SparseMatrix(self._plan, values=stream.reshape(-1),
                            cache=self._cache)

    def with_thresholds(self, th: SelectorThresholds) -> "SparseMatrix":
        """The same plan (its partition spec and mesh kept) under ``th``."""
        return SparseMatrix(self._plan.with_thresholds(th),
                            values=self._values, cache=self._cache)

    def shard(self, mesh=None, *, axis: str | None = None,
              kind: str | None = None, inner_backend: str | None = None,
              geometry: TileGeometry | None = None) -> "SparseMatrix":
        """Re-plan this operand onto the sharded backend
        (``core/shard.py``): the statistics pick a row or nnz split unless
        ``kind`` forces one.  ``mesh`` defaults to the ``use_mesh`` scope.
        This plan's geometry carries over only when the inner backend is
        the one it was resolved for (``geometry=`` always wins)."""
        if mesh is None:
            mesh, scoped_axis = scoped_mesh()
            axis = axis or scoped_axis
        if mesh is None:
            raise ValueError("shard() needs a mesh (argument or use_mesh scope)")
        from .core.shard import default_inner_backend, shard_devices
        old = self._plan
        if geometry is None:
            had = old.inner_backend if old.backend == "sharded" else old.backend
            lookup = inner_backend or default_inner_backend(
                shard_devices(mesh, axis or default_shard_axis(mesh))[0])
            geometry = old.geometry if lookup == had else None
        kw = dict(backend="sharded", mesh=mesh, thresholds=old.thresholds,
                  tile=old.tile, bsr_block=old.bsr_block, geometry=geometry,
                  shard_axis=axis, shard_kind=kind,
                  inner_backend=inner_backend, quant=old.quant,
                  chain_op=old.chain_op)
        p = (plan(old.csr, **kw) if self._cache is None
             else cached_plan(old.csr, cache=self._cache, **kw))
        return SparseMatrix(p, values=self._values, cache=self._cache)

    def finalize(self, n: int | None = None, *, impl: str | None = None,
                 kernels: tuple | None = None) -> PlanArtifact:
        """Freeze into a ``PlanArtifact`` (``PlanBuilder.finalize``) that
        bakes this handle's values: a live stream (a cache hit, a
        ``with_values`` handle) is baked by re-planning, detached, off the
        shared builder, so ``execute(art, x)`` needs no ``vals=``."""
        p = self._plan
        if self._values is not None:
            csr = CSR(p.csr.indptr, p.csr.indices,
                      self._values.detach().reshape(-1), p.csr.shape)
            spec = p.shard_spec
            p = plan(csr, thresholds=p.thresholds, backend=p.backend,
                     tile=p.tile, bsr_block=p.bsr_block, geometry=p.geometry,
                     chain_op=p.chain_op, quant=p.quant, mesh=p.mesh,
                     shard_axis=None if spec is None else spec.axis,
                     shard_kind=None if spec is None else spec.kind,
                     inner_backend=p.inner_backend)
        return p.finalize(n, impl=impl, kernels=kernels)


def _as_csr(a, device: torch.device) -> tuple[CSR, "torch.Tensor | None"]:
    """Normalise ``sparse()`` input to (CSR on ``device``, live values or
    None); a SparseMatrix input keeps its live values."""
    if isinstance(a, CSR):
        return a.to(device), None
    if isinstance(a, SparseMatrix):
        live = None if a._values is None else a._values.to(device)
        return a.plan.csr.to(device), live
    if isinstance(a, torch.Tensor) or isinstance(a, np.ndarray):
        if a.ndim != 2:
            raise ValueError(f"sparse() takes a CSR or a dense 2-D array; "
                             f"got shape {tuple(a.shape)}")
        return csr_from_dense(a, device=device), None
    raise TypeError(f"sparse() takes a CSR, a SparseMatrix or a dense 2-D "
                    f"array, got {type(a).__name__}")


def sparse(a, *, device=None, backend: str | None = None,
           thresholds: SelectorThresholds | None = None,
           tile: int | None = None, n_hint: int | None = None,
           geometry: TileGeometry | None = None,
           chain_op: str | None = None, bsr_block: tuple = (8, 128),
           quant: str | None = None, validate: str | None = None,
           cache: "PlanCache | bool | None" = True, mesh=None,
           shard_axis: str | None = None,
           shard_kind: str | None = None) -> SparseMatrix:
    """Build a sparse operand from a CSR, a SparseMatrix or a dense 2-D
    array.

    ``device=None`` means CUDA (raising without one); ``backend=None`` takes
    the ``use_backend`` scope, else ``"hopper"`` on CUDA and ``"torch"`` on
    the CPU.  Planning goes through the topology-keyed ``PlanCache`` (the
    process default for ``cache=True``, a given instance, or ``cache=False``
    to re-plan): a hit whose baked values differ from ``a``'s returns a
    handle that streams its own values, so reuse is always value-correct.
    ``geometry=None`` resolves the thresholds' geometry table here, with
    ``n_hint``, so the cache keys on the resolved geometry.  ``chain_op``
    tags the plan with the chain transform it serves, so chained and plain
    plans over one pattern are distinct cache entries.  ``bsr_block`` is the
    (bm, bk) block of the ``"bsr"`` backend's substrate, also in the cache
    key.

    ``quant`` (``"int8"`` or ``"fp8"``) stores the value stream as per-tile
    codes with f32 scales, which the nnz-balanced kernels decode in
    registers (the selector is pinned to them).  An ``n_hint`` below the
    thresholds' ``quant_min_n`` drops it (checked here, before the cache);
    a per-tile dynamic range that breaks the error bound falls back to the
    float plan with a warning.  Quantized and float plans are distinct
    cache entries.

    ``validate`` (DESIGN.md §12) runs the pattern policy before anything —
    the fingerprint, the geometry lookup, the cache — reads the CSR:
    ``"check"`` warns of unsorted, duplicate, out-of-range or non-finite
    entries and a broken indptr, ``"repair"`` rebuilds the matrix (so it
    caches under its clean fingerprint), ``"strict"`` raises
    ``PatternError``.

    ``mesh`` (default: the ``use_mesh`` scope) plans onto the sharded
    backend (``core/shard.py``): ``shard_kind`` forces the row or nnz split
    the statistics would pick, ``shard_axis`` names the mesh axis.
    ``device=None`` is then the first shard's device, and ``backend`` the
    inner backend (None: that device's)."""
    if mesh is None:
        mesh, scoped_axis = scoped_mesh()
        shard_axis = shard_axis or scoped_axis
    inner_backend = None
    if mesh is not None:
        from .core.shard import shard_devices
        if device is None:
            device = shard_devices(
                mesh, shard_axis or default_shard_axis(mesh))[0]
        inner_backend, backend = backend, "sharded"
    device = resolve_device(device)
    csr, values = _as_csr(a, device)
    if validate is not None and validate != "off":
        csr, _ = validate_csr(csr, validate)
    resolved_backend = backend or default_backend(device)
    th = thresholds if thresholds is not None else default_thresholds()
    if quant is not None and n_hint is not None and n_hint < th.quant_min_n:
        quant = None     # cached_plan never sees n_hint: gate here
    if geometry is None and th.geometries:
        geometry = th.geometry_for(
            pattern_fingerprint(csr), n_hint,
            inner_backend or (default_backend(device) if mesh is not None
                              else resolved_backend))
    if cache is True:
        cache_obj = DEFAULT_CACHE
    elif cache is False:
        cache_obj = None
    else:
        cache_obj = cache
    kw = dict(backend=resolved_backend, thresholds=th, tile=tile,
              geometry=geometry, chain_op=chain_op, bsr_block=bsr_block,
              quant=quant, mesh=mesh, shard_axis=shard_axis,
              shard_kind=shard_kind, inner_backend=inner_backend)
    p = (plan(csr, **kw) if cache_obj is None
         else cached_plan(csr, cache=cache_obj, **kw))
    if values is None and p.csr is not csr and not torch.equal(p.csr.data, csr.data):
        # a cache hit from a pattern-equal matrix: stream OUR values
        values = csr.data.reshape(-1)
    if n_hint is not None:
        p.kernel_opts(p.entry(p.select(n_hint)))
    return SparseMatrix(p, values=values, cache=cache_obj)


def sddmm(pattern, a: torch.Tensor, b: torch.Tensor, *,
          backend: str | None = None, **sparse_kw) -> torch.Tensor:
    """``(a @ b.T)`` at ``pattern``'s nonzero positions, as the ``(nnz,)``
    CSR-ordered stream.  ``pattern`` is anything ``sparse()`` takes (its
    keywords pass through, ``device=`` among them) or a SparseMatrix."""
    A = pattern if isinstance(pattern, SparseMatrix) else (
        sparse(pattern, backend=backend, **sparse_kw))
    return A.sddmm(a, b, backend=backend)


def sparse_chain(pattern, a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 *, transform: str = "softmax", alpha: float | None = None,
                 backend: str | None = None, **sparse_kw) -> torch.Tensor:
    """The SDDMM→(transform)→SpMM chain over ``pattern``'s nonzeros:

        ``y[i] = sum_j t(a[i] · b[j]) * x[j]``   for (i, j) in the pattern

    with ``t`` = ``identity``, ``scale`` (times ``alpha``) or the masked row
    ``softmax`` of ``alpha`` times the scores (graph attention).  Plans are
    cached per (topology, transform): the ``chain_op`` key segment."""
    if isinstance(pattern, SparseMatrix):
        A = pattern
    else:
        A = sparse(pattern, backend=backend, chain_op=transform, **sparse_kw)
    return A.chain(a, b, x, transform=transform, alpha=alpha, backend=backend)


def cache_stats(cache: PlanCache | None = None) -> dict:
    return (cache or DEFAULT_CACHE).stats()


def clear_cache(cache: PlanCache | None = None) -> None:
    (cache or DEFAULT_CACHE).clear()


def health() -> dict:
    """A snapshot of the guardrails' ``HEALTH`` registry (DESIGN.md §12):
    ``{"counters": {...}, "breakers": {"backend:logical": {...}}}``.

    Counters: the named demotions (``demote:quant_range``,
    ``demote:fp8_to_int8``, ``demote:chain_fuse``, ``demote:attn_fuse``),
    ``quant_range_violations``, sentinel firings (``sentinel:<site>``,
    ``sentinel_fallback:<site>``), kernel failures on the card
    (``kernel_failure:<backend>:<logical>``, each re-raised), reroutes
    down the ladder on CPU operands
    (``kernel_reroute:<from>-><to>:<logical>``, e.g.
    ``kernel_reroute:hopper->torch:nb_pr``), calls an open breaker skipped
    (``breaker_skip:<backend>:<logical>``) and ``pattern_issues`` /
    ``pattern_repairs``.  Breakers: state, consecutive failures, trips and
    recoveries per (backend, logical kernel)."""
    return HEALTH.snapshot()


def reset_health() -> None:
    """Drop every guardrail counter and breaker."""
    HEALTH.reset()


def configure_guardrails(*, threshold: int = 3, cooldown_s: float = 30.0) -> None:
    """The circuit breakers' parameters: ``threshold`` kernel failures in a
    row trip a breaker open; after ``cooldown_s`` seconds it half-opens and
    probes the primary backend once."""
    HEALTH.configure(threshold=threshold, cooldown_s=cooldown_s)


# ---------------------------------------------------------------------------
# calibration against this backend (paper §2.2) and the tuners
# ---------------------------------------------------------------------------

def _pattern_csr(csr_or_matrix) -> CSR:
    return (csr_or_matrix.plan.csr if isinstance(csr_or_matrix, SparseMatrix)
            else csr_or_matrix)


def autotune_geometry(csr_or_matrix, **kwargs) -> SelectorThresholds:
    """Timed sweep over tile geometries for one sparsity pattern (a CSR or a
    SparseMatrix); returns thresholds whose ``geometries`` table carries
    the winner per N-bucket (``repro_torch.kernels.tune`` for the
    keywords).  Persist with ``save_thresholds``: later ``sparse()`` calls
    on the pattern take the tuned tile, and the cache keys on it."""
    from .kernels.tune import autotune_geometry as _tune
    return _tune(_pattern_csr(csr_or_matrix), **kwargs)


def autotune_overlap(csr_or_matrix, mesh, **kwargs) -> SelectorThresholds:
    """The sharded backend's overlap crossover on ``mesh``: thresholds whose
    ``overlap_min_n`` is the smallest dense width at which the chunked ring
    beats the blocking psum (``OVERLAP_NEVER`` when it never does;
    ``repro_torch.kernels.tune.autotune_overlap``)."""
    from .kernels.tune import autotune_overlap as _tune
    return _tune(_pattern_csr(csr_or_matrix), mesh, **kwargs)


def autotune_quant(csr_or_matrix, **kwargs) -> SelectorThresholds:
    """The quantization crossover of one pattern: thresholds whose
    ``quant_min_n`` is the smallest dense width at which the int8 / fp8
    plan beats the f32 one (``QUANT_NEVER`` when it never does;
    ``repro_torch.kernels.tune.autotune_quant``)."""
    from .kernels.tune import autotune_quant as _tune
    return _tune(_pattern_csr(csr_or_matrix), **kwargs)


def autotune_chain(csr_or_matrix, **kwargs) -> SelectorThresholds:
    """The chain-fusion crossover of one pattern: thresholds whose
    ``chain_fuse_min_n`` is the smallest dense width at which the fused
    SDDMM→SpMM chain beats the unfused pair (``CHAIN_NEVER`` when it never
    does; ``repro_torch.kernels.tune.autotune_chain``)."""
    from .kernels.tune import autotune_chain as _tune
    return _tune(_pattern_csr(csr_or_matrix), **kwargs)


def autotune_attention(specs, **kwargs) -> SelectorThresholds:
    """The fused-attention crossover over ``AttentionSpec``s: thresholds
    whose ``attn_fuse_min_seq`` is the smallest sequence length at which
    the fused attention chain beats the unfused one (``ATTN_NEVER`` when it
    never does; ``repro_torch.kernels.tune.autotune_attention``)."""
    from .kernels.tune import autotune_attention as _tune
    return _tune(specs, **kwargs)


def calibrate_backend(save_to: str | None = None, *,
                      matrices: dict | None = None,
                      ns: tuple = (1, 8), repeats: int = 2,
                      backend: str | None = None, device=None,
                      n_grid: tuple = (2, 4, 8, 1 << 30),
                      avg_grid: tuple = (8.0, 16.0, 32.0, 64.0),
                      cv_grid: tuple = (0.25, 0.5, 1.0, 2.0),
                      tune_geometry: bool = False,
                      geometry_candidates: tuple | None = None,
                      overlap_mesh=None,
                      overlap_ns: tuple = (256, 512, 1024),
                      tune_quant: bool = False,
                      quant_ns: tuple = (8, 32, 128)):
    """Time the 2x2 kernel space on this backend and grid-search the
    selector's thresholds against the times (paper §2.2/§3.2,
    ``calibrate``), persisting the winner to ``save_to`` for
    ``$REPRO_THRESHOLDS``.  Returns ``(thresholds, report)``.

    ``matrices`` (name -> CSR) default to the reference's two R-MAT
    matrices of scale 8, one uniform and one skewed; ``rmat_suite()`` is the
    paper's 27.  They are moved to ``device`` (``None``: the card, raising
    without one) and planned on ``backend`` (``None``: the device's).  Each
    time is the mean of ``repeats`` after a warm-up call, taken by
    ``kernels.tune.Timer``: replays of a CUDA graph on the card (calls that
    sync or build: back-to-back calls), the host clock on the CPU; the
    report's ``"timing"`` maps each entry to its mode.

    ``tune_geometry=True`` also runs ``autotune_geometry`` on each matrix at
    the ``ns`` above 1 (``geometry_candidates``: its ``candidates``) and
    adds the table to the report as ``"geometries"``; ``tune_quant=True``
    runs ``autotune_quant`` at ``quant_ns`` on the matrix with the most
    nonzeros, the report's ``"quant_min_n"``.  ``overlap_mesh`` (a device
    mesh) runs ``autotune_overlap`` on it at ``overlap_ns`` on the matrix
    with the largest CV (where psum plans live), the report's
    ``"overlap_min_n"``."""
    from .core.rmat import rmat
    from .kernels import tune
    device = resolve_device(device)
    if matrices is None:
        matrices = {"uniform": rmat(8, 8, a=0.25, b=0.25, c=0.25, seed=0),
                    "skewed": rmat(8, 8, seed=1)}
    matrices = {k: v.to(device) for k, v in matrices.items()}
    names = {id(v): k for k, v in matrices.items()}
    timer = tune.Timer()

    def time_fn(kernel: str, p: PlanBuilder, n: int) -> float:
        k = p.csr.shape[1]
        x = torch.ones((k, n) if n > 1 else (k,), dtype=torch.float32,
                       device=device)
        return timer(lambda: execute(p, x, impl=kernel, backend=backend),
                     device, repeats, f"{names[id(p.csr)]}|n={n}|{kernel}")

    with backend_scope(backend):
        best, report = calibrate(matrices, ns, time_fn=time_fn, n_grid=n_grid,
                                 avg_grid=avg_grid, cv_grid=cv_grid)
    if tune_geometry:
        tune_ns = tuple(n for n in ns if n > 1) or (8,)
        for csr in matrices.values():
            best = tune.autotune_geometry(
                csr, ns=tune_ns, backend=backend, thresholds=best,
                repeats=repeats, candidates=geometry_candidates, timer=timer)
        report["geometries"] = dict(best.geometries)
    if overlap_mesh is not None:
        from .core.stats import matrix_stats
        skewed = max(matrices.values(), key=lambda c: matrix_stats(c).cv)
        best = tune.autotune_overlap(skewed, overlap_mesh, ns=overlap_ns,
                                     thresholds=best, inner_backend=backend,
                                     repeats=repeats, timer=timer)
        report["overlap_min_n"] = int(best.overlap_min_n)
    if tune_quant:
        # the crossover is traffic-bound: tune on the largest value stream
        heavy = max(matrices.values(), key=lambda c: int(c.nnz))
        best = tune.autotune_quant(heavy, ns=quant_ns, backend=backend,
                                   thresholds=best, repeats=repeats,
                                   timer=timer)
        report["quant_min_n"] = int(best.quant_min_n)
    report["timing"] = timer.modes()
    if save_to is not None:
        save_thresholds(best, save_to)
    return best, report
