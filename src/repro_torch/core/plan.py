"""Plan/execute for one device; counterpart of ``repro.core.plan``.

* ``plan(csr, ...)`` returns a ``PlanBuilder``, the host side of the
  offline/online split: the Fig. 4 statistics computed once, thresholds
  fixed (``$REPRO_THRESHOLDS`` auto-loads), a backend chosen, and the
  substrates (ELL / BalancedCOO) built lazily — only the one the selected
  kernel consumes — with each registry entry's ``prep`` hook run once.
* ``PlanBuilder.finalize(n)`` freezes it into a ``PlanArtifact``: every
  host step done (substrates, maps, prep opts, the backward's plan of Aᵀ),
  its tensors the leaves of a ``torch.utils._pytree`` node, its static half
  a hashable ``PlanMeta`` keyed on ``topology_key()``.
* ``execute(plan, x)`` is the online step: select the logical kernel from
  (stats, N), resolve it through the registry, run it.  ``vals=`` streams a
  CSR-ordered value vector in place of the values baked into the plan.  On
  an artifact it does no host work, so a CUDA graph can capture it.
* ``execute_pattern(rows, cols, vals, shape, x)`` is the training entry: an
  SpMM over a bare balanced pattern with live values, no CSR and no plan.
* ``execute_sddmm`` / ``execute_chain`` run the SDDMM and the SDDMM→SpMM
  chain (DESIGN.md §9) over the plan's pattern; ``execute_attention`` runs
  block-sparse attention over it (DESIGN.md §10).

Every entry is differentiable (``core/vjp.py``).  ``execute`` on all three
families and ``execute_pattern`` in ``x`` and the live stream: the backward
runs the SDDMM entry for the values' gradient and the adaptive SpMM of Aᵀ
(``PlanBuilder.transposed``, built once a plan; K11 on Aᵀ's BSR for the
block family) for ``x``'s.  ``execute_sddmm``, ``execute_chain`` and
``execute_attention`` in their dense operands (and the bias): the backward
recomputes the edge weights with the forward's kernels and runs the pair of
SDDMM and SpMMs over the pattern and its transpose (``_ChainVJP``).  A
plan's baked values are constants, as in the reference.  No autograd node is
made when nothing requires grad.

One rule of the reference does not carry over: its plans demote ``pallas``
to ``xla`` when a tile spans more rows than ``max_win`` — a TPU
spill-window limit; the fused Hopper kernels size nothing by a tile's row
span, so a ``"hopper"`` plan keeps its backend, and only the spill path
(``spill=True`` in the NB kernel opts, the parity reference) refuses such a
plan when it is called.  The block-granule ``"bsr"`` backend builds its BSR
substrate at ``bsr_block``; a ``"bsr"`` plan is not demoted either.
The reference's artifact rides ``jax.jit`` and donation; here the
counterpart of a jitted call is a CUDA graph of ``execute(artifact, x)``.

The sharded backend (``core/shard.py``): ``plan(csr, mesh=...)`` (backend
``"sharded"``) picks a row or nnz split of the matrix over a mesh axis from
its statistics (``shard_kind`` forces one, ``shard_axis`` names the axis)
and runs the entries of an inner backend (``inner_backend``: ``"hopper"``
for a mesh on the card, ``"torch"`` on the CPU) once per shard on the
lazily built ``shard_ell`` / ``shard_balanced`` substrates.  A live stream
is gathered into the shards' slabs through their ``src`` maps; a sharded
artifact freezes the substrates and every shard's prep.  On CPU operands a
failing per-shard inner is rerouted to the ``"torch"`` inner
(``sharded/torch-inner``); on the card it is counted and raises.
``execute_pattern(mesh=...)`` splits a bare pattern's tiles over the shards
(``shard.execute_pattern_sharded``).

Guardrails (DESIGN.md §12, ``core/guardrails.py``), where the reference
has them: ``plan(validate=)`` runs the pattern policy before anything is
built; ``execute`` (builder and artifact), ``execute_sddmm``,
``execute_chain`` and ``execute_attention`` dispatch through
``guardrails.guarded_call``.  On CPU operands a failing ``"hopper"`` or
``"bsr"`` call is rerouted, and counted in ``HEALTH``, to the ``"torch"``
entry of the same logical kernel (on an artifact only where the
``"torch"`` entry's substrate was finalized in: never for ``"bsr"``), its
backward built on ``"torch"`` too; on the card a kernel that fails to
build or launch is counted (``kernel_failure:*``) and raises, and there is
no rung below it (``_rung``); ``execute`` passes its output through
``apply_sentinel`` (``sentinel=``, the plan's ``sentinel``, or the
``sentinel_scope``).  The backward's own products run unguarded, as the
reference's backward has no dispatch to guard.  ``plan_build`` and
``substrate_prep`` are fault sites.  ``execute_pattern`` is not guarded, as
in the reference.

Quantized value streams (DESIGN.md §8, ``core/quant.py``): ``plan(quant=
"int8" | "fp8")`` stores the balanced substrate's values as per-tile codes
with one f32 scale a tile (``quant_scales``), pins the selector to the NB
family (``_quant_logical``: an ``rs_*`` pick would read the float ELL), and
hands the NB entries the mode and the scales: on the card K1, K2, K4 and K5
read the codes.  A slab whose per-tile dynamic range breaks the bound
warns, bumps ``demote:quant_range`` and keeps the float stream (``quant``
becomes None; a plan with ``sentinel="raise"`` raises ``NumericFault``
instead).  A live stream
on a quantized plan, and ``execute_pattern(quant=)``, is quantized at each
call.  The backward is straight through: dX of a baked coded plan is Aᵀ·G
over the decoded stream, of a live one over the float stream, on the
transposed plan, which is never quantized; the chains read the pattern
alone.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import warnings
import weakref
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..runtime.faults import consult
from . import guardrails
from . import quant as quant_mod
from . import registry
from .guardrails import HEALTH, NumericFault
from .formats import (CSR, BalancedCOO, balanced_pattern, balanced_transpose,
                      bsr_block_rows, bsr_slots, csr_to_balanced, csr_to_bsr,
                      csr_to_ell, csr_transpose, host)
from .selector import (SelectorThresholds, TileGeometry, default_thresholds,
                       select_kernel)
from .spmm import CHAIN_TRANSFORMS
from .stats import MatrixStats, matrix_stats
from .vjp import (_as_2d, _stream_to_balanced, exec_attn,  # noqa: F401 (re-export)
                  exec_balanced, exec_bsr, exec_chain, exec_ell, exec_sddmm)

#: plan-context kwargs a prep hook may opt into by declaring them; ``shared``
#: is a dict of the plan that its entries' prep hooks share (the attention
#: block layout, one per pattern)
_PREP_CONTEXT_NAMES = ("geometry", "max_win", "shared", "overlap_min_n")

#: accepted-keyword cache of prep hooks (see ``_prep_context_kwargs``)
_PREP_KWARGS: dict = {}

#: chain_op tags a plan accepts: the chain transforms, and "attn" for the
#: plans of block-sparse attention
CHAIN_OPS: tuple[str, ...] = CHAIN_TRANSFORMS + ("attn",)

#: the substrates of the sharded backend
_SHARD_SUBSTRATES = ("shard_ell", "shard_balanced")


class ShardedBiasError(NotImplementedError, ValueError):
    """``execute_attention`` with a bias on a sharded plan: the reference
    refuses it too (both its ``NotImplementedError`` and a ``ValueError``)."""


class PlanBuildError(RuntimeError):
    """A substrate build failed: the original exception (``__cause__``)
    wrapped with the substrate kind and the pattern shape."""

    def __init__(self, kind: str, shape, cause: BaseException):
        super().__init__(f"building substrate {kind!r} for pattern shape "
                         f"{tuple(shape)} failed: "
                         f"{type(cause).__name__}: {cause}")
        self.kind = kind
        self.shape = tuple(shape)


def _quant_logical(name: str, quant: str | None) -> str:
    """The selector's pick on a quantized plan: the coded stream lives in
    the balanced substrate, which only the NB kernels read, so ``rs_sr`` /
    ``rs_pr`` become ``nb_sr`` / ``nb_pr`` (the SR/PR choice kept)."""
    if quant is None:
        return name
    return {"rs_sr": "nb_sr", "rs_pr": "nb_pr"}.get(name, name)


def _check_quant(quant: str | None) -> str | None:
    """Reject an unknown mode; demote fp8 to int8, warning and bumping
    ``demote:fp8_to_int8``, where this PyTorch has no
    ``float8_e4m3fn``."""
    if quant is None:
        return None
    if quant not in quant_mod.QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; expected one of "
                         f"{quant_mod.QUANT_MODES}")
    if not quant_mod.supports(quant):
        warnings.warn(f"quant={quant!r} is not supported by this PyTorch "
                      "build; demoting to 'int8'", stacklevel=3)
        HEALTH.bump("demote:fp8_to_int8")
        return "int8"
    return quant


def _prep_context_kwargs(prep, ctx: dict) -> dict:
    """Filter the plan context (geometry, ``max_win``, ``shared``) down to
    the names this prep hook declares, so hooks keep the minimal
    ``prep(substrate)`` signature unless they opt in."""
    accepted = _PREP_KWARGS.get(prep)
    if accepted is None:
        try:
            params = inspect.signature(prep).parameters.values()
            if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
                accepted = _PREP_CONTEXT_NAMES
            else:
                accepted = tuple(p.name for p in params
                                 if p.kind in (inspect.Parameter.KEYWORD_ONLY,
                                               inspect.Parameter.POSITIONAL_OR_KEYWORD)
                                 and p.name in _PREP_CONTEXT_NAMES)
        except (TypeError, ValueError):
            accepted = ()
        _PREP_KWARGS[prep] = accepted
    return {k: v for k, v in ctx.items() if k in accepted and v is not None}


# ---------------------------------------------------------------------------
# the frozen artifact
# ---------------------------------------------------------------------------

def _digest_value(h, v) -> None:
    """Fold one prep-opt value into the hash: scalars by repr, containers
    item by item, tensors by type, shape, device kind and bytes, any other
    object (a group layout, spill windows) by its class and attributes."""
    if isinstance(v, (bool, int, float, str, bytes, type(None))):
        h.update(repr(v).encode())
    elif isinstance(v, (tuple, list)):
        h.update(b"(")
        for item in v:
            _digest_value(h, item)
        h.update(b")")
    elif isinstance(v, dict):
        h.update(b"{")
        for k in sorted(v, key=str):
            h.update(str(k).encode())
            _digest_value(h, v[k])
        h.update(b"}")
    elif isinstance(v, torch.Tensor):
        h.update(f"{v.dtype}{tuple(v.shape)}{v.device.type}".encode())
        h.update(v.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    else:
        h.update(type(v).__qualname__.encode())
        _digest_value(h, vars(v))


def _opts_digest(opts: dict) -> str:
    h = hashlib.sha1()
    _digest_value(h, opts)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class PlanMeta:
    """Hashable static half of a ``PlanArtifact`` (its pytree context).
    Equal metas mean equal pattern topology, layout knobs, statistics
    (``MatrixStats`` reads only the pattern), thresholds, prep opts and, for
    a sharded plan, its partition and mesh.  The reference's fields and
    ``transposed``: the meta of the plan of Aᵀ that the backward's ``dX``
    runs on (None on a sharded artifact, whose backward is per shard)."""

    shape: tuple
    nnz: int
    backend: str
    stats: MatrixStats
    thresholds: SelectorThresholds
    tile: int
    bsr_block: tuple
    topology: str
    prep: tuple = ()                 # ((logical, opts digest), ...)
    shard_spec: Any = None           # ShardSpec of a sharded plan
    mesh: Any = None                 # its launch.mesh.Mesh
    inner_backend: str | None = None
    geometry: Any = None             # TileGeometry, or None
    quant: str | None = None         # value-stream mode ("int8" / "fp8")
    chain_op: str | None = None      # chain transform the plan was keyed for
    transposed: "PlanMeta | None" = None


@dataclasses.dataclass(frozen=True, eq=False)
class PlanArtifact:
    """The frozen plan (``PlanBuilder.finalize``): ``substrates`` and
    ``aux`` are dicts of device tensors and formats, ``meta`` the static
    half, ``opts`` each kernel's prep opts (a group layout, spill windows),
    which ride along without being pytree leaves.  Keys ``"t:..."`` hold the
    plan of Aᵀ for the backward: its substrates and maps, and
    ``aux["transposed_perm"]``.  ``execute(artifact, x)`` does no host work:
    no copy to the host, no substrate or prep build, no device sync — so it
    can be captured in a CUDA graph (a live stream on a quantized artifact
    too: it is quantized on the card at each call by tensor ops, with no
    range check).  Registered with
    ``torch.utils._pytree``: it flattens to exactly its tensors and
    unflattens with the same meta and opts."""

    substrates: dict
    aux: dict
    meta: PlanMeta
    opts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> tuple:
        return self.meta.shape

    @property
    def nnz(self) -> int:
        return self.meta.nnz

    @property
    def backend(self) -> str:
        return self.meta.backend

    @property
    def stats(self) -> MatrixStats:
        return self.meta.stats

    @property
    def thresholds(self) -> SelectorThresholds:
        return self.meta.thresholds

    @property
    def topology(self) -> str:
        return self.meta.topology

    def select(self, n: int) -> str:
        return _quant_logical(
            select_kernel(self.meta.stats, n, self.meta.thresholds),
            self.meta.quant)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return execute(self, x)

    # -- the backward's products ----------------------------------------------
    def _pattern(self) -> tuple[torch.Tensor, torch.Tensor]:
        bal = self.substrates.get("balanced")
        if bal is not None:
            return bal.rows, bal.cols
        return self.aux["pattern_rows"], self.aux["pattern_cols"]

    def _sample(self, g2: torch.Tensor, x2: torch.Tensor,
                backend: str | None) -> torch.Tensor:
        """``dvals``: the SDDMM entry over the pattern with the opts that
        ``finalize`` prepared; ``backend`` is None (the artifact's own) or
        the ladder's ``"torch"`` rung of a rerouted call."""
        entry = registry.resolve(
            "sddmm", _sddmm_backend(backend or self.meta.backend, g2))
        return entry.fn(*self._pattern(), g2, x2, shape=self.meta.shape,
                        **self.opts.get("sddmm", {}))

    def _transposed(self) -> "PlanArtifact":
        """The artifact of Aᵀ, a view of this one's ``"t:"`` keys."""
        view = self.__dict__.get("_t")
        if view is None:
            if self.meta.transposed is None:
                raise ValueError("this artifact carries no plan of Aᵀ; "
                                 "finalize it from a PlanBuilder")
            view = PlanArtifact(*(
                {k[2:]: v for k, v in d.items() if k.startswith("t:")}
                for d in (self.substrates, self.aux)),
                self.meta.transposed,
                {k[2:]: v for k, v in self.opts.items() if k.startswith("t:")})
            object.__setattr__(self, "_t", view)
        return view

    def _transposed_matmul(self, vals: torch.Tensor, g: torch.Tensor,
                           backend: str | None) -> torch.Tensor:
        """``dX = Aᵀ·G`` on the artifact of Aᵀ, unguarded, on ``backend``
        (None: the artifact's own)."""
        t = self._transposed()
        name = t.select(1 if g.ndim == 1 else g.shape[1])
        entry, sub = _artifact_entry(t, name, backend or t.meta.backend)
        return _artifact_run(t, entry, sub, g,
                             vals.index_select(0, self.aux["transposed_perm"]),
                             backend)


class _ArtifactContext:
    """A ``PlanArtifact``'s pytree context: its meta, which alone decides
    equality (equal metas give equal tree specs), and its opts."""

    __slots__ = ("meta", "opts")

    def __init__(self, meta: PlanMeta, opts: dict):
        self.meta, self.opts = meta, opts

    def __eq__(self, other) -> bool:
        return isinstance(other, _ArtifactContext) and other.meta == self.meta

    def __hash__(self) -> int:
        return hash(self.meta)

    def __repr__(self) -> str:
        return f"PlanArtifact(topology={self.meta.topology[:12]})"


pytree.register_pytree_node(
    PlanArtifact,
    lambda a: ([a.substrates, a.aux], _ArtifactContext(a.meta, a.opts)),
    lambda values, ctx: PlanArtifact(*values, ctx.meta, ctx.opts),
    serialized_type_name=f"{__name__}.PlanArtifact")


@dataclasses.dataclass
class PlanBuilder:
    """Host-side plan: statistics, thresholds, backend, and caches of the
    lazily built substrates and prep opts."""

    csr: CSR
    stats: MatrixStats
    thresholds: SelectorThresholds
    backend: str
    tile: int = 512
    bsr_block: tuple = (8, 128)      # (bm, bk) of the BSR substrate
    geometry: TileGeometry | None = None
    chain_op: str | None = None      # chain transform the plan was keyed for
    quant: str | None = None         # value-stream mode ("int8" / "fp8")
    #: the default sentinel policy of this plan's ``execute`` calls (None:
    #: the call's ``sentinel=`` or the ``sentinel_scope``); ``"raise"`` also
    #: turns the quant range demotion into a ``NumericFault``
    sentinel: str | None = None
    #: the sharded backend: the mesh, the partition chosen from the
    #: statistics, and the backend whose entries run a shard
    mesh: Any = None
    shard_spec: Any = None
    inner_backend: str | None = None
    _substrates: dict = dataclasses.field(default_factory=dict, repr=False)
    _opts: dict = dataclasses.field(default_factory=dict, repr=False)
    _shared: dict = dataclasses.field(default_factory=dict, repr=False)
    _ell_src: Any = dataclasses.field(default=None, repr=False)
    _bsr_map: Any = dataclasses.field(default=None, repr=False)
    _bsr_brow: Any = dataclasses.field(default=None, repr=False)
    _pattern: Any = dataclasses.field(default=None, repr=False)
    _pattern_prep: Any = dataclasses.field(default=None, repr=False)
    _transposed: Any = dataclasses.field(default=None, repr=False)
    _quant_scales: Any = dataclasses.field(default=None, repr=False)
    _topology: Any = dataclasses.field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.csr.device

    @property
    def nnz(self) -> int:
        return self.csr.nnz

    # -- substrates ---------------------------------------------------------
    def substrate(self, kind: str):
        """Build-and-cache the named substrate; only ever called for the
        format the resolved kernel consumes (the laziness contract).  The
        ``plan_build`` fault site is consulted first; a build that fails
        with anything but a usage error or a ``NumericFault`` raises
        ``PlanBuildError``."""
        sub = self._substrates.get(kind)
        if sub is None:
            consult("plan_build")
            try:
                sub = self._build_substrate(kind)
            except (ValueError, NumericFault):
                raise
            except Exception as e:
                raise PlanBuildError(kind, self.csr.shape, e) from e
            self._substrates[kind] = sub
        return sub

    def _build_substrate(self, kind: str):
        if kind == "ell":
            return csr_to_ell(self.csr)
        if kind == "bsr":
            return csr_to_bsr(self.csr, *self.bsr_block)
        if kind in _SHARD_SUBSTRATES:
            return self._build_sharded(kind)
        if kind != "balanced":
            raise ValueError(f"unknown substrate {kind!r}")
        sub = csr_to_balanced(self.csr, tile=self.tile)
        if self.quant is not None:
            # a tile whose range breaks the bound demotes the whole plan to
            # the float stream
            if quant_mod.check_tile_range(sub.vals):
                q, sc = quant_mod.quantize_stream(sub.vals, self.quant)
                sub = BalancedCOO(sub.rows, sub.cols, q, sub.shape)
                self._quant_scales = sc
            elif self.sentinel == "raise":
                raise NumericFault(
                    "quantized value stream exceeds the per-tile dynamic "
                    f"range ({self.quant!r}); plan with quant=None or "
                    "sentinel!='raise' to demote instead")
            else:
                HEALTH.bump("demote:quant_range")
                self.quant = None
        return sub

    def _build_sharded(self, kind: str):
        """A shard substrate (``shard.build_sharded_substrate``); a quantized
        plan whose per-shard range check fails keeps the float slab
        (``demote:quant_range``, or ``NumericFault`` under
        ``sentinel="raise"``)."""
        if self.mesh is None or self.shard_spec is None:
            raise ValueError("sharded substrates need a plan built with "
                             "mesh=... (plan(csr, backend='sharded', mesh=m))")
        from . import shard
        sub = shard.build_sharded_substrate(
            self.csr, self.shard_spec, self.mesh,
            inner_kind=kind[len("shard_"):], tile=self.tile,
            inner_backend=self.inner_backend, quant=self.quant)
        if self.quant is not None and kind == "shard_balanced" \
                and sub.scales is None:
            if self.sentinel == "raise":
                raise NumericFault(
                    "quantized value stream exceeds the per-tile dynamic "
                    f"range ({self.quant!r}) on a shard; plan with quant=None "
                    "or sentinel!='raise' to demote instead")
            HEALTH.bump("demote:quant_range")
            self.quant = None
        return sub

    @property
    def built_substrates(self) -> tuple[str, ...]:
        return tuple(sorted(self._substrates))

    # -- selection and resolution ---------------------------------------------
    def select(self, n: int) -> str:
        return _quant_logical(select_kernel(self.stats, n, self.thresholds),
                              self.quant)

    def with_thresholds(self, th: SelectorThresholds) -> "PlanBuilder":
        """The same matrix and substrates under other thresholds.  The prep
        opts read thresholds (``max_win``) and the plan of Aᵀ carries this
        plan's thresholds, so both caches start anew."""
        if th == self.thresholds:
            return self
        return dataclasses.replace(self, thresholds=th, _opts={},
                                   _transposed=None)

    def topology_key(self) -> str:
        """The pattern's fingerprint folded with the layout knobs (tile,
        BSR block, geometry, quant mode), values excluded: byte for byte the
        reference's, so artifacts and thresholds files agree across the
        packages.  Recomputed when the range check demotes ``quant``."""
        if self._topology is None or self._topology[0] != self.quant:
            from .cache import pattern_fingerprint
            digest = hashlib.sha1(
                (pattern_fingerprint(self.csr)
                 + repr((self.tile, tuple(self.bsr_block), self.geometry,
                         self.quant))).encode()).hexdigest()
            self._topology = (self.quant, digest)
        return self._topology[1]

    def quant_scales(self) -> torch.Tensor | None:
        """The (n_tiles,) f32 scales of the baked coded substrate (None
        unless the plan quantized its balanced substrate)."""
        if self.quant is not None:
            self.substrate("balanced")
        return self._quant_scales

    def entry(self, name: str, backend: str | None = None) -> registry.KernelEntry:
        return registry.resolve(name, backend or self.backend)

    def kernel_opts(self, entry: registry.KernelEntry) -> dict:
        """The entry's prep-hook opts for this matrix, computed once on the
        built substrate (which may demote ``quant`` first, so the key reads
        it after).  A quantized plan's balanced entries get ``quant``.  The
        ``substrate_prep`` fault site is consulted before a prep runs."""
        sub = self.substrate(entry.substrate)
        key = (entry.logical, entry.backend, self.quant)
        opts = self._opts.get(key)
        if opts is None:
            consult("substrate_prep")
            if entry.prep is None:
                opts = {}
            else:
                ctx = _prep_context_kwargs(
                    entry.prep, {"geometry": self.geometry,
                                 "max_win": self.thresholds.max_win,
                                 "shared": self._shared,
                                 "overlap_min_n": self.thresholds.overlap_min_n})
                opts = dict(entry.prep(sub, **ctx))
            if self.quant is not None and entry.substrate in (
                    "balanced", "shard_balanced"):
                opts["quant"] = self.quant
            self._opts[key] = opts
        return opts

    # -- the backward's plans ---------------------------------------------------
    def pattern(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The balanced ``(rows, cols)`` slabs in CSR order: the balanced
        substrate's when it is built, else built once without values (the
        pattern an ELL plan's backward samples)."""
        bal = self._substrates.get("balanced")
        if bal is not None:
            return bal.rows, bal.cols
        if self._pattern is None:
            self._pattern = balanced_pattern(self.csr, self.tile)
        return self._pattern

    def pattern_prep(self) -> "PatternPrep":
        """The prep of ``pattern()``: the opts of the backward's SDDMM."""
        if self._pattern_prep is None:
            self._pattern_prep = PatternPrep(self.csr.shape)
        return self._pattern_prep

    def transposed(self) -> "PlanBuilder":
        """The plan of Aᵀ, built once and held by this plan (never looked up
        through a cache): Aᵀ's statistics, this plan's thresholds, backend
        and tile, its substrates built lazily.  Its BSR block is this plan's
        transposed, ``(bk, bm)``, so Aᵀ's BSR is the block transpose of A's
        (as many blocks, each as full).  Its values are
        ``csr.data[transposed_perm()]``; the backward streams them live.
        It is never quantized: dX is f32 math on the forward's (decoded)
        values, as in the reference."""
        if self._transposed is None:
            csr_t, perm = csr_transpose(self.csr)
            bm, bk = self.bsr_block
            backend = (self.inner_backend if self.backend == "sharded"
                       else self.backend)
            pt = PlanBuilder(csr=csr_t, stats=matrix_stats(csr_t),
                             thresholds=self.thresholds, backend=backend,
                             tile=self.tile, bsr_block=(bk, bm))
            self._transposed = (pt, perm)
        return self._transposed[0]

    def transposed_perm(self) -> torch.Tensor:
        """(nnz,) int32: the position in this plan's stream of each of Aᵀ's
        nonzeros, in Aᵀ's CSR order."""
        self.transposed()
        return self._transposed[1]

    def _sample(self, g2: torch.Tensor, x2: torch.Tensor,
                backend: str | None) -> torch.Tensor:
        """``dvals``: the SDDMM entry of the call's backend over
        ``pattern()``."""
        return self.pattern_prep().sample(
            *self.pattern(), g2, x2, _sddmm_backend(backend or self.backend, g2))

    def _transposed_matmul(self, vals: torch.Tensor, g: torch.Tensor,
                           backend: str | None) -> torch.Tensor:
        """``dX = Aᵀ·G`` for the CSR-ordered stream ``vals``, unguarded."""
        return _execute(self.transposed(), g,
                        vals.index_select(0, self.transposed_perm()), None,
                        backend)

    # -- ELL live-value support -----------------------------------------------
    def ell_lens(self) -> torch.Tensor:
        """(M,) stored entries per row — the ELL padding mask."""
        return self.substrate("ell").lens

    def ell_src(self) -> torch.Tensor:
        """(M, width) gather map from the CSR value stream into the ELL slab:
        ``ell_vals = where(valid, stream[src], 0)``."""
        if self._ell_src is None:
            ell = self.substrate("ell")
            indptr = host(self.csr.indptr).astype(np.int64)
            j = np.arange(ell.width, dtype=np.int64)[None, :]
            src = np.minimum(indptr[:-1, None] + j, max(self.csr.nnz - 1, 0))
            self._ell_src = torch.from_numpy(src.astype(np.int32)).to(self.device)
        return self._ell_src

    # -- BSR live-value support -------------------------------------------------
    def bsr_map(self) -> torch.Tensor:
        """(3, nnz) scatter map from the CSR value stream into the BSR
        blocks: (block id, row in the block, column in the block), in
        ``csr_to_bsr``'s block order."""
        if self._bsr_map is None:
            self._bsr_map = bsr_slots(self.csr, *self.bsr_block)[1].int()
        return self._bsr_map

    def bsr_brow(self) -> torch.Tensor:
        """(nblocks,) block row of each stored block (the block-level VJP's
        row map, reference ``core/vjp.py::_exec_bsr``)."""
        if self._bsr_brow is None:
            self._bsr_brow = bsr_block_rows(self.substrate("bsr")).int()
        return self._bsr_brow

    # -- freezing -------------------------------------------------------------
    def finalize(self, n: int | None = None, *, impl: str | None = None,
                 kernels: tuple | None = None) -> PlanArtifact:
        """Freeze the plan into a ``PlanArtifact``: freezing is the end of
        the lazy phase, so every host step runs here.

        The artifact carries the substrates, maps and prep opts of the
        logical kernels named by ``kernels``, or of the one the selector
        picks at ``n`` (forced by ``impl``); with none of the three, all
        four.  It also carries what the backward needs: the baked stream,
        the pattern and the SDDMM entry's opts for ``dvals``, and for ``dX``
        the plan of Aᵀ — the substrate of the kernel Aᵀ's selector picks at
        ``n`` (with ``impl`` or ``kernels`` and no ``n``, its picks on both
        sides of ``n_threshold``; all four for a full-coverage artifact) —
        and ``transposed_perm``.  A spill opt's row windows are computed
        here.  The SDDMM and the chains are not matmul kernels and cannot be
        frozen (``ValueError``)."""
        full = kernels is None and impl is None and n is None
        if kernels is None:
            if impl is not None:
                kernels = (impl,)
            elif n is not None:
                if self.quant is not None:       # settle the range check
                    self.substrate("shard_balanced" if self.backend == "sharded"
                                   else "balanced")
                kernels = (self.select(n),)
            else:
                kernels = registry.MATMUL_KERNELS
        kernels = tuple(kernels)
        for name in kernels:
            if name in ("sddmm", "chain", "attn_chain"):
                raise ValueError(
                    f"{name!r} cannot be finalized into a PlanArtifact; use "
                    "execute_sddmm/execute_chain/execute_attention on the "
                    "PlanBuilder")
            if name not in registry.MATMUL_KERNELS:
                raise ValueError(f"{name!r} is not a matmul kernel; expected "
                                 f"one of {registry.MATMUL_KERNELS}")
        subs, aux, opts = self._freeze(kernels)
        aux["vals"] = self.csr.data
        if self.backend == "sharded":
            # the backward runs a shard (shard._ShardVJP): no plan of Aᵀ
            return PlanArtifact(subs, aux, self._meta(opts), opts)
        if "balanced" in subs and self._quant_scales is not None:
            aux["quant_scales"] = self._quant_scales
        rows, cols = self.pattern()
        if "balanced" not in subs:
            aux["pattern_rows"], aux["pattern_cols"] = rows, cols
        sampler = registry.resolve(
            "sddmm", _sddmm_backend(self.backend, self.csr.data))
        opts["sddmm"] = dict(self.pattern_prep().opts(
            sampler, BalancedCOO(rows, cols, None, self.csr.shape)))
        pt = self.transposed()
        th = self.thresholds
        if full:
            t_kernels = registry.MATMUL_KERNELS
        elif n is not None:
            t_kernels = (pt.select(n),)
        else:
            t_kernels = tuple(dict.fromkeys(
                (pt.select(1), pt.select(th.n_threshold + 1))))
        t_subs, t_aux, t_opts = pt._freeze(t_kernels)
        subs.update({f"t:{k}": v for k, v in t_subs.items()})
        aux.update({f"t:{k}": v for k, v in t_aux.items()})
        aux["transposed_perm"] = self.transposed_perm()
        opts.update({f"t:{k}": v for k, v in t_opts.items()})
        return PlanArtifact(subs, aux, self._meta(opts, pt._meta(t_opts)),
                            opts)

    def _freeze(self, kernels: tuple) -> tuple[dict, dict, dict]:
        """The substrates, live-stream maps and prep opts (copied) of the
        named kernels, each built now."""
        subs: dict = {}
        aux: dict = {}
        opts: dict = {}
        for name in kernels:
            entry = self.entry(name)
            sub = self.substrate(entry.substrate)
            subs[entry.substrate] = sub
            o = dict(self.kernel_opts(entry))
            if entry.substrate in _SHARD_SUBSTRATES:
                from . import shard
                shard.freeze_opts(sub, o)
            elif o.get("spill"):
                o["windows"](sub)        # the tile spans, scanned on the host
            opts[entry.logical] = o
            if entry.substrate == "ell":
                aux["ell_src"] = self.ell_src()
            elif entry.substrate == "bsr":
                aux["bsr_map"] = self.bsr_map()
                aux["bsr_brow"] = self.bsr_brow()
        return subs, aux, opts

    def _meta(self, opts: dict, transposed: PlanMeta | None = None) -> PlanMeta:
        prep = tuple(sorted((k, _opts_digest(v)) for k, v in opts.items()
                            if v and not k.startswith("t:")))
        return PlanMeta(
            shape=tuple(self.csr.shape), nnz=self.csr.nnz,
            backend=self.backend, stats=self.stats, thresholds=self.thresholds,
            tile=self.tile, bsr_block=tuple(self.bsr_block),
            topology=self.topology_key(), prep=prep, geometry=self.geometry,
            quant=self.quant, chain_op=self.chain_op, transposed=transposed,
            shard_spec=self.shard_spec, mesh=self.mesh,
            inner_backend=self.inner_backend)


#: the builder's earlier name, kept as an alias (reference ``SparsePlan``)
SparsePlan = PlanBuilder


def plan(csr: CSR, *, n_hint: int | None = None,
         thresholds: SelectorThresholds | None = None,
         backend: str | None = None, tile: int | None = None,
         geometry: TileGeometry | None = None, chain_op: str | None = None,
         bsr_block: tuple = (8, 128), quant: str | None = None,
         validate: str | None = None, sentinel: str | None = None,
         mesh: Any = None, shard_axis: str | None = None,
         shard_kind: str | None = None,
         inner_backend: str | None = None) -> PlanBuilder:
    """Offline planning front door.

    ``n_hint`` (the expected N) builds the substrate and prep of the kernel
    the selector will pick now, off the hot path.  ``thresholds=None``
    auto-loads ``$REPRO_THRESHOLDS`` or takes the defaults; ``backend=None``
    takes the ``use_backend`` scope, else ``"hopper"`` for a CSR on a CUDA
    device and ``"torch"`` on the CPU.  ``geometry=None`` consults the
    thresholds' geometry table for (pattern, ``n_hint``, backend);
    ``tile=None`` takes the geometry's quota (default 512).  ``chain_op``
    tags the plan with the chain transform it will serve (``"attn"`` for
    attention): a cache key segment, not a switch (``execute_chain`` takes
    the transform per call).  ``bsr_block`` is the (bm, bk) block of the
    ``"bsr"`` backend's substrate.

    ``quant`` (``"int8"`` / ``"fp8"``) stores the balanced substrate's
    values as per-tile codes and scales that the NB kernels decode in
    registers.  An ``n_hint`` below ``thresholds.quant_min_n`` drops it; a
    per-tile dynamic range past ``quant.MAX_DYNAMIC_RANGE`` drops it with a
    warning when the substrate is built.

    ``validate`` (``"check"`` / ``"repair"`` / ``"strict"``) runs the pattern
    through ``guardrails.validate_csr`` before anything is built; None or
    ``"off"`` trusts the input.  ``sentinel`` is the plan's default
    numeric-sentinel policy for ``execute``.

    Sharded backend (``core/shard.py``): ``mesh`` (a ``launch.mesh.Mesh``)
    makes ``backend=None`` ``"sharded"``.  The partition is chosen from the
    statistics (``cv`` against ``thresholds.partition_cv``: row split below,
    nnz split above) unless ``shard_kind`` forces one; ``shard_axis``
    defaults to the mesh's largest axis and ``inner_backend`` to the one of
    the first shard's device (``"hopper"`` on the card, ``"torch"`` on the
    CPU).  Other backends ignore the three."""
    if validate is not None and validate != "off":
        csr, _ = guardrails.validate_csr(csr, validate)
    if sentinel is not None and sentinel not in guardrails.SENTINEL_POLICIES:
        raise ValueError(f"unknown sentinel policy {sentinel!r}; expected "
                         f"one of {guardrails.SENTINEL_POLICIES}")
    if chain_op is not None and chain_op not in CHAIN_OPS:
        raise ValueError(f"unknown chain_op {chain_op!r}; expected one of "
                         f"{CHAIN_OPS}")
    if backend is None:
        backend = ("sharded" if mesh is not None
                   else registry.default_backend(csr.device))
    th = thresholds if thresholds is not None else default_thresholds()
    quant = _check_quant(quant)
    if quant is not None and n_hint is not None and n_hint < th.quant_min_n:
        quant = None                 # below the crossover: not worth it
    stats = matrix_stats(csr)
    spec = None
    if backend == "sharded":
        if mesh is None:
            raise ValueError("backend='sharded' needs mesh=... (e.g. "
                             "repro_torch.launch.make_local_mesh)")
        from . import shard
        spec = shard.make_shard_spec(stats, mesh, axis=shard_axis,
                                     kind=shard_kind, thresholds=th)
        inner_backend = inner_backend or shard.default_inner_backend(
            shard.shard_devices(mesh, spec.axis)[0])
    else:
        mesh = inner_backend = None
    if geometry is None and th.geometries:
        from .cache import pattern_fingerprint
        geometry = th.geometry_for(pattern_fingerprint(csr), n_hint,
                                   inner_backend or backend)
    if tile is None:
        tile = geometry.tile if geometry is not None else 512
    bm, bk = (int(b) for b in bsr_block)
    if bm < 1 or bk < 1:
        raise ValueError(f"bsr_block must be two positive ints; got {bsr_block}")
    p = PlanBuilder(csr=csr, stats=stats, thresholds=th, backend=backend,
                    tile=int(tile), bsr_block=(bm, bk), geometry=geometry,
                    chain_op=chain_op, quant=quant, sentinel=sentinel,
                    mesh=mesh, shard_spec=spec, inner_backend=inner_backend)
    if n_hint is not None:
        p.kernel_opts(p.entry(p.select(n_hint)))
    return p


# ---------------------------------------------------------------------------
# the backward of the matmul families
# ---------------------------------------------------------------------------

#: transposed-slab builds of ``PatternPrep`` since process start: one per
#: pattern a training run differentiates, never one per step
PATTERN_PREP = {"builds": 0}


class PatternPrep:
    """The prep of a balanced ``(rows, cols)`` pattern's products: each
    entry's prep-hook opts, and Aᵀ's balanced slabs with ``perm`` (built on
    the first backward of ``execute_pattern`` that needs ``dX``).  It holds
    no reference to the pattern's own slabs, which each call passes."""

    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)
        self._opts: dict = {}
        self._t = None
        #: the pattern split over a mesh's shards, by (devices, entry):
        #: ``shard.execute_pattern_sharded``'s memo
        self.shards: dict = {}

    def transposed(self, rows, cols) -> tuple[BalancedCOO, torch.Tensor]:
        """Aᵀ's values-free ``BalancedCOO`` and ``perm`` (int32, the flat
        slot of A's slabs each of Aᵀ's nonzeros comes from)."""
        if self._t is None:
            PATTERN_PREP["builds"] += 1
            rows_t, cols_t, perm = balanced_transpose(rows, cols, self.shape)
            m, k = self.shape
            self._t = (BalancedCOO(rows_t, cols_t, None, (k, m)), perm)
        return self._t

    def opts(self, entry: registry.KernelEntry, sub: BalancedCOO,
             transposed: bool = False) -> dict:
        """The entry's prep-hook opts on ``sub``, A's pattern or (with
        ``transposed``) Aᵀ's, computed once (the reference's bound-kernel
        cache)."""
        key = (entry.logical, entry.backend, transposed)
        opts = self._opts.get(key)
        if opts is None:
            opts = {} if entry.prep is None else dict(entry.prep(sub))
            self._opts[key] = opts
        return opts

    def sample(self, rows, cols, g2: torch.Tensor, x2: torch.Tensor,
               backend: str) -> torch.Tensor:
        """``dvals``: the SDDMM entry of ``backend`` over the pattern,
        ``<g2[row], x2[col]>`` a slot, shaped like the slabs."""
        entry = registry.resolve("sddmm", backend)
        return entry.fn(rows, cols, g2, x2, shape=self.shape,
                        **self.opts(entry, BalancedCOO(rows, cols, None,
                                                       self.shape)))


#: ``id(rows)`` -> (weak references to rows and cols, their versions,
#: PatternPrep); an entry goes when its rows tensor is freed, so a new
#: tensor that reuses the id never finds the old prep
_PATTERN_PREPS: dict = {}


def pattern_prep(rows: torch.Tensor, cols: torch.Tensor, shape) -> PatternPrep:
    """The prep of the pattern ``(rows, cols)``, memoised on the identity
    of those tensors and on their version counters while ``rows`` lives: an
    in-place write (``copy_``, ``load_state_dict``) bumps a version and
    makes a new prep.  No hash of the slabs, no copy to the host."""
    key = id(rows)
    version = (rows._version, cols._version)
    hit = _PATTERN_PREPS.get(key)
    same = hit is not None and hit[0]() is rows and hit[1]() is cols
    if same and hit[2] == version and \
            hit[3].shape == tuple(int(s) for s in shape):
        return hit[3]
    prep = PatternPrep(shape)
    _PATTERN_PREPS[key] = (weakref.ref(rows), weakref.ref(cols), version, prep)
    if not same:
        weakref.finalize(rows, _PATTERN_PREPS.pop, key, None)
    return prep


def _sddmm_backend(backend: str, t: torch.Tensor) -> str:
    """The backend of the SDDMM entry a backward samples with: the call's,
    or, for the block-granule ``"bsr"`` backend (which has no SDDMM), the
    one of the operands' device (K6 on the card, the plain one on the
    CPU)."""
    if backend == "bsr":
        return "hopper" if t.is_cuda else "torch"
    return backend


class _PlanVJP:
    """The backward products of one ``execute`` call on a plan ``p``, a
    ``PlanBuilder`` or a ``PlanArtifact``: the SDDMM entry over its pattern
    for the values, the adaptive SpMM of its plan of Aᵀ for ``x``, both on
    the call's backend.  ``dtype`` rounds the value gradient (the BSR
    blocks' type, as the reference rounds ``dblocks``).  ``scales``: the
    stream is a baked slab's codes, which ``dx`` decodes."""

    def __init__(self, p, backend: str | None,
                 dtype: torch.dtype | None = None,
                 scales: torch.Tensor | None = None):
        self.p, self.backend, self.dtype = p, backend, dtype
        self.scales = scales

    def dvals(self, g2: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        slab = self.p._sample(g2, x2, self.backend)
        return slab if self.dtype is None else slab.to(self.dtype)

    def dx(self, vals: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.scales is not None:
            # the codes decoded (slab order is CSR order, cut to nnz)
            vals = quant_mod.dequantize_stream(
                vals.reshape(self.scales.shape[0], -1),
                self.scales).reshape(-1)[:self.p.nnz]
        return self.p._transposed_matmul(vals, g, self.backend)


def execute(p: "PlanBuilder | PlanArtifact", x: torch.Tensor, *,
            vals: torch.Tensor | None = None, impl: str | None = None,
            backend: str | None = None,
            sentinel: str | None = None) -> torch.Tensor:
    """``y = A @ x`` on a ``PlanBuilder`` or a frozen ``PlanArtifact``.
    ``vals`` is a live CSR-ordered value stream in place of the plan's baked
    values; ``impl`` forces a logical kernel (oracle / ablation mode);
    ``backend`` overrides a builder's backend for this call (an artifact is
    frozen for its own: another raises ``ValueError``).

    Differentiable in ``x`` and ``vals`` (``ExecBalanced`` / ``ExecEll`` /
    ``ExecBsr``): the backward samples ``G·Xᵀ`` on the pattern with the
    SDDMM entry and runs ``Aᵀ·G`` through the transposed plan's own
    selector, whatever ``impl`` forced the forward to (on the ``"bsr"``
    backend: K11 on Aᵀ's BSR).  On a quantized plan the NB kernels read the
    baked codes (or quantize ``vals``); the backward is straight through.
    On an artifact the call, forward and backward, runs only what
    ``finalize`` built: a kernel it does not cover raises ``ValueError``
    naming ``finalize``.

    Guardrails: the dispatch runs under the (backend, logical kernel)
    circuit breaker, a failing kernel rerouted one rung down
    ``registry.DEMOTION`` on CPU operands and counted and re-raised on the
    card; ``sentinel`` (``"raise"`` / ``"sanitize"`` /
    ``"fallback"``; default: a builder's ``sentinel``, then the
    ``sentinel_scope``) checks the output for non-finite values."""
    if isinstance(p, PlanArtifact):
        return _execute_artifact(p, x, vals, impl, backend, sentinel)
    n = _check_call(p.csr.shape, p.csr.nnz, p.csr.data, x, vals, impl)
    name = impl or p.select(n)
    eff = backend or p.backend
    demoted = _rung(eff, x, p.inner_backend)
    if demoted is None:
        fb = None
    elif eff == "sharded":
        fb = lambda: _builder_exec(_demoted_inner(p), name, None, x, vals)  # noqa: E731
    else:
        fb = lambda: _builder_exec(p, name, demoted, x, vals)  # noqa: E731
    y = guardrails.guarded_call(
        name, eff, lambda: _builder_exec(p, name, backend, x, vals),
        fallback=fb, fallback_name=demoted, on_card=x.is_cuda)
    policy = sentinel if sentinel is not None else (
        p.sentinel or guardrails.active_sentinel())
    return guardrails.apply_sentinel(y, policy, site=f"execute:{name}",
                                     fallback=fb)


def _rung(backend: str, t: torch.Tensor, inner: str | None = None
          ) -> str | None:
    """The rung below ``backend`` for a call on ``t``: ``registry.DEMOTION``'s
    on CPU operands, where the wrappers run their kernels' plain versions
    already; none on the card, where a kernel launches or raises.  A
    sharded call's rung keeps the shards and runs them on the ``"torch"``
    inner (``"sharded/torch-inner"``), none when ``inner`` is that
    already."""
    if t.is_cuda:
        return None
    if backend == "sharded":
        down = registry.DEMOTION["sharded"]
        return None if inner == down else f"sharded/{down}-inner"
    return registry.DEMOTION.get(backend)


def _demoted_inner(p: PlanBuilder) -> PlanBuilder:
    """The sharded plan one rung down: the same matrix, spec and mesh with
    the ``"torch"`` inner, every cache its own (its shard substrates are
    built anew, never aliasing the parent's).  Made once a plan."""
    key = ("demoted_inner",)
    cached = p._opts.get(key)
    if cached is None:
        cached = p._opts[key] = dataclasses.replace(
            p, inner_backend=registry.DEMOTION["sharded"], _substrates={},
            _opts={}, _shared={},
            _ell_src=None, _bsr_map=None, _bsr_brow=None, _pattern=None,
            _pattern_prep=None, _transposed=None, _quant_scales=None,
            _topology=None)
    return cached


def _check_call(shape, nnz: int, baked: torch.Tensor | None, x, vals,
                impl) -> int:
    """The checks of an ``execute`` call; returns N."""
    if torch.is_grad_enabled() and baked is not None and baked.requires_grad:
        raise NotImplementedError(
            "execute: the plan's baked values require grad, but they are "
            "constants of the plan, as in the reference; pass them as a "
            "live stream (SparseMatrix.with_values or vals=) to "
            "differentiate them")
    if impl is not None and impl not in registry.MATMUL_KERNELS:
        raise ValueError(f"impl {impl!r} is not a matmul kernel; expected "
                         f"one of {registry.MATMUL_KERNELS}")
    if vals is not None and vals.numel() != nnz:
        raise ValueError(f"vals stream has {vals.numel()} entries but the "
                         f"matrix has {nnz} nonzeros")
    if x.ndim not in (1, 2) or x.shape[0] != shape[1]:
        raise ValueError(f"x of shape {tuple(x.shape)} does not match A of "
                         f"shape {tuple(shape)}")
    return 1 if x.ndim == 1 else x.shape[1]


def _execute(p: PlanBuilder, x: torch.Tensor, vals, impl, backend, *,
             coded: bool = True) -> torch.Tensor:
    """``execute`` on a builder without the guardrails: the backward's
    products.  With ``coded=False`` a quantized plan runs its live stream
    unquantized (the chains' backward products, f32 math as in the
    reference)."""
    n = _check_call(p.csr.shape, p.csr.nnz, p.csr.data, x, vals, impl)
    return _builder_exec(p, impl or p.select(n), backend, x, vals, coded)


def _builder_exec(p: PlanBuilder, name: str, backend: str | None,
                  x: torch.Tensor, vals, coded: bool = True) -> torch.Tensor:
    """The unguarded builder dispatch: resolve, build, run; the backward is
    built on the same ``backend`` (a rerouted call's on ``"torch"``)."""
    entry = p.entry(name, backend)
    sub = p.substrate(entry.substrate)
    opts = p.kernel_opts(entry)
    maps = {"vals": lambda: p.csr.data, "quant_scales": p.quant_scales,
            "ell_src": p.ell_src, "bsr_map": p.bsr_map}
    return _run_entry(entry, sub, opts, x, vals, lambda k: maps[k](),
                      functools.partial(_PlanVJP, p, backend), coded=coded)


def _artifact_entry(art: PlanArtifact, name: str, backend: str, *,
                    required: bool = True):
    """``(entry, substrate)`` of ``name`` on ``backend`` over the artifact's
    substrates; the substrate is None (or, if ``required``, a
    ``ValueError`` naming ``finalize``) where the artifact lacks it."""
    entry = registry.resolve(name, backend)
    sub = art.substrates.get(entry.substrate)
    if sub is None and required:
        raise ValueError(
            f"artifact carries substrates {tuple(art.substrates)} but kernel "
            f"{name!r} needs {entry.substrate!r}; finalize with n=/impl=/"
            "kernels= covering it")
    return entry, sub


def _artifact_run(art: PlanArtifact, entry: registry.KernelEntry, sub,
                  x: torch.Tensor, vals, backend: str | None) -> torch.Tensor:
    """The unguarded artifact dispatch of ``entry`` over the artifact's own
    tensors and opts, with no host work; ``backend`` is None (the
    artifact's own) or the rung a rerouted call's backward runs on."""
    return _run_entry(entry, sub, art.opts.get(entry.logical, {}), x, vals,
                      art.aux.__getitem__,
                      functools.partial(_PlanVJP, art, backend))


def _execute_artifact(art: PlanArtifact, x: torch.Tensor, vals, impl,
                      backend, sentinel=None) -> torch.Tensor:
    """``execute`` on a frozen artifact.  A rung below exists only on CPU
    operands and where the demoted backend's entry reads a substrate the
    artifact carries (the ``"torch"`` entries read a ``"hopper"``
    artifact's; a ``"bsr"`` artifact carries only its BSR, so there a
    failure re-raises)."""
    meta = art.meta
    if backend is not None and backend != meta.backend:
        raise ValueError(
            f"PlanArtifact is frozen for backend {meta.backend!r}; finalize "
            f"a plan built with backend={backend!r} instead")
    n = _check_call(meta.shape, meta.nnz, art.aux.get("vals"), x, vals, impl)
    name = impl or art.select(n)
    entry, sub = _artifact_entry(art, name, meta.backend)
    # a frozen sharded artifact carries no "torch"-inner substrates
    demoted = None if meta.backend == "sharded" else _rung(meta.backend, x)
    fb = None
    if demoted is not None:
        fbe, fbs = _artifact_entry(art, name, demoted, required=False)
        if fbs is not None:
            fb = functools.partial(_artifact_run, art, fbe, fbs, x, vals,
                                   demoted)
    y = guardrails.guarded_call(
        name, meta.backend, lambda: _artifact_run(art, entry, sub, x, vals, None),
        fallback=fb, fallback_name=demoted, on_card=x.is_cuda)
    policy = sentinel if sentinel is not None else guardrails.active_sentinel()
    return guardrails.apply_sentinel(y, policy, site=f"execute:{name}",
                                     fallback=fb)


def _run_entry(entry: registry.KernelEntry, sub, opts: dict, x: torch.Tensor,
               vals, aux, vjp, *, coded: bool = True) -> torch.Tensor:
    """The dispatch shared by builders and artifacts: the entry on its
    substrate, through the family's autograd Function when an operand
    requires grad.  ``aux(name)`` gives the baked stream and the maps
    (``"vals"``, ``"quant_scales"``, ``"ell_src"``, ``"bsr_map"``);
    ``vjp(dtype, scales)`` the backward's products."""
    if entry.substrate in _SHARD_SUBSTRATES:
        # a shard's entry gathers a live stream through the substrate's src
        # maps and carries the per-shard backward itself (core/shard.py)
        if not coded:
            opts = {k: v for k, v in opts.items() if k != "quant"}
        return entry.fn(sub, x, vals=vals, **opts)
    baked = vals is None             # the substrate as built holds them
    scales = None
    if baked and entry.substrate == "balanced" and \
            quant_mod.is_quantized_dtype(sub.vals.dtype):
        scales = aux("quant_scales")     # the kernels decode the baked codes
        opts = dict(opts, scales=scales)
    elif not coded:
        opts = {k: v for k, v in opts.items() if k != "quant"}
    fn = functools.partial(entry.fn, **opts)
    if baked and not (torch.is_grad_enabled() and x.requires_grad):
        return fn(sub, x)
    if scales is not None:
        stream = sub.vals.reshape(-1)    # codes: dX decodes them
    else:
        stream = (aux("vals") if baked else vals).reshape(-1)
    if entry.substrate == "bsr":
        return exec_bsr(fn, sub, None if baked else aux("bsr_map"),
                        vjp(sub.blocks.dtype), stream, x, baked=baked)
    if entry.substrate == "balanced":
        return exec_balanced(fn, sub, vjp(None, scales), stream, x,
                             baked=baked)
    return exec_ell(fn, sub, None if baked else aux("ell_src"), vjp(), stream,
                    x, baked=baked)


# ---------------------------------------------------------------------------
# the training entry: a bare balanced pattern with live values
# ---------------------------------------------------------------------------

class _PatternVJP:
    """The backward products of one ``execute_pattern`` call: the SDDMM
    entry over the pattern, and the forward's kernel on Aᵀ's slabs."""

    def __init__(self, rows, cols, prep: PatternPrep, entry, backend: str):
        self.rows, self.cols, self.prep = rows, cols, prep
        self.entry, self.backend = entry, backend

    def dvals(self, g2: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.prep.sample(self.rows, self.cols, g2, x2, self.backend)

    def dx(self, vals: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        bal_t, perm = self.prep.transposed(self.rows, self.cols)
        sub = BalancedCOO(bal_t.rows, bal_t.cols, _stream_to_balanced(
            vals.index_select(0, perm), bal_t), bal_t.shape)
        return self.entry.fn(sub, g, **self.prep.opts(self.entry, bal_t,
                                                       transposed=True))


def _pattern_impl(n: int) -> str:
    """The logical kernel of a pattern call that names none: ``nb_pr`` up
    to the selector's default ``n_threshold``, ``nb_sr`` above it (a bare
    pattern has no statistics to select by; the rule of
    ``kernels/vsr.py::_design``)."""
    return "nb_pr" if n <= SelectorThresholds.n_threshold else "nb_sr"


def execute_pattern(rows: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, shape: tuple, x: torch.Tensor, *,
                    impl: str | None = None, backend: str | None = None,
                    mesh: Any = None, shard_axis: str | None = None,
                    quant: str | None = None) -> torch.Tensor:
    """Differentiable SpMM over a bare balanced pattern — the training entry
    for sparse-weight layers (no CSR, the values are live parameters):
    ``rows`` / ``cols`` are ``(n_tiles, tile)`` int32 slabs, padding slots
    ``rows >= M``, and ``vals`` holds one value a slot (any shape of that
    size; its gradient is 0 at padding slots).

    ``impl=None`` takes ``nb_pr`` at N up to the selector's default
    ``n_threshold`` and ``nb_sr`` above it (``_pattern_impl``); a named
    ``impl`` forces that kernel.  ``backend=None`` takes the
    ``use_backend`` scope, else the one of the pattern's device.  The
    backward is ``ExecBalanced``: the SDDMM entry for ``vals``, and the
    forward's kernel on Aᵀ's slabs for ``x``.  Those slabs are per-pattern prep, built
    once: memoised on the identity of ``rows`` and ``cols``, never hashed.

    ``quant`` (``"int8"`` / ``"fp8"``) quantizes the live values per tile
    at each call, so only the coded stream reaches the kernel (K1 / K2 on
    the card); an ``rs_*`` impl is pinned to its ``nb_*`` sibling.  The
    backward is straight through: both products use the float values.

    ``mesh`` (or ``backend="sharded"``) splits the pattern's tiles evenly
    over ``shard_axis`` (default: the mesh's largest axis) and psums the
    partials (``shard.execute_pattern_sharded``); ``backend`` then names the
    inner backend (None or ``"sharded"``: the first shard's device's)."""
    quant = _check_quant(quant)
    if impl is None:
        impl = _pattern_impl(1 if x.ndim == 1 else x.shape[1])
    impl = _quant_logical(impl, quant)
    if mesh is not None or backend == "sharded":
        if mesh is None:
            raise ValueError("backend='sharded' needs mesh=...")
        from . import shard
        return shard.execute_pattern_sharded(
            rows, cols, vals, tuple(shape), x, mesh=mesh, axis=shard_axis,
            impl=impl, backend=None if backend == "sharded" else backend,
            quant=quant)
    backend = backend or registry.default_backend(rows.device)
    entry = registry.resolve(impl, backend)
    if entry.substrate != "balanced":
        raise ValueError(f"execute_pattern needs a balanced-substrate kernel; "
                         f"({impl!r}, {backend!r}) consumes {entry.substrate!r}")
    if vals.numel() != rows.numel():
        raise ValueError(f"vals has {vals.numel()} entries but the pattern "
                         f"has {rows.numel()} slots")
    prep = pattern_prep(rows, cols, shape)
    bal = BalancedCOO(rows, cols, None, prep.shape)
    opts = prep.opts(entry, bal)
    fn = functools.partial(entry.fn, **(opts if quant is None
                                        else dict(opts, quant=quant)))
    return exec_balanced(fn, bal, _PatternVJP(rows, cols, prep, entry, backend),
                         vals, x)


# ---------------------------------------------------------------------------
# SDDMM and the fused chain (DESIGN.md §9), single device
# ---------------------------------------------------------------------------

def _chain_pattern(p: PlanBuilder) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(rows, cols)`` pattern the chain entries take: the balanced
    slab's arrays, whose row-major tiling keeps CSR order."""
    bal = p.substrate("balanced")
    return bal.rows, bal.cols


class _ChainVJP:
    """The backward products of one ``execute_sddmm``, ``execute_chain`` or
    ``execute_attention`` call, over the plan's pattern and on the call's
    backend (``core/vjp.py``'s ``ExecSddmm`` / ``ExecChain`` /
    ``ExecAttn`` read them).  Streams are CSR-ordered and f32.

    * ``weights`` recomputes the edge weights as the unfused forward does:
      on the card K6, then K7 (chain) or K9 (attention) in the design the
      pattern routes to (the block design on an attention mask, through
      the plan's ``AttnBlocks``), the weights by elementwise ops; on the
      ``"torch"`` backend their plain versions;
    * ``sample`` is the ``"sddmm"`` entry over (G, X) (K6);
    * ``rowsum``, ``spmm`` and ``spmm_t`` are ``execute`` with a live
      stream on the plan (against ones for the row sum: K2) and on the
      transposed plan, each through its own selector."""

    def __init__(self, p: PlanBuilder, backend: str | None, *,
                 entry: registry.KernelEntry | None = None,
                 transform: str = "identity", alpha=None):
        self.p, self.backend, self.entry = p, backend, entry
        self.transform, self.alpha = transform, alpha

    def stream(self, slab: torch.Tensor) -> torch.Tensor:
        """A slab shaped like the pattern as the CSR-ordered f32 stream."""
        return slab.reshape(-1)[:self.p.csr.nnz].float()

    def row_ids(self) -> torch.Tensor:
        return _chain_pattern(self.p)[0].reshape(-1)[:self.p.csr.nnz].long()

    def weights(self, a: torch.Tensor, b: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        p, entry = self.p, self.entry
        rows, cols = _chain_pattern(p)
        kw: dict = {"shape": tuple(p.csr.shape)}
        if entry.backend == "hopper":
            from ..kernels import attention, fused_chain
            kw["blocks"] = p.kernel_opts(entry).get("blocks")
            chain_w, attn_w = (fused_chain.chain_edge_weights,
                               attention.attn_edge_weights)
            a, b = a.contiguous(), b.contiguous()
        else:
            from .spmm import attn_edge_weights as attn_w
            from .spmm import chain_edge_weights as chain_w
        if bias is None:
            w = chain_w(rows, cols, a, b, transform=self.transform,
                        alpha=self.alpha, **kw)
        else:
            w = attn_w(rows, cols, a, b, bias, scale=self.alpha, **kw)
        return self.stream(w)

    def sample(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        x2 = _as_2d(x).contiguous()
        slab = p.pattern_prep().sample(*_chain_pattern(p),
                                       _as_2d(g).to(x2.dtype).contiguous(), x2,
                                       self.backend or p.backend)
        return self.stream(slab)

    def rowsum(self, vals: torch.Tensor) -> torch.Tensor:
        ones = torch.ones(self.p.csr.shape[1], dtype=torch.float32,
                          device=vals.device)
        return self.spmm(vals, ones)

    def spmm(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        # f32 streams, never quantized (a quantized plan's chain reads only
        # its pattern)
        return _execute(self.p, x.contiguous(), vals, None, self.backend,
                        coded=False)

    def spmm_t(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        return _execute(p.transposed(), x.contiguous(),
                        vals.index_select(0, p.transposed_perm()), None,
                        self.backend)


def _chain_bound(p: PlanBuilder, entry: registry.KernelEntry,
                 extra: dict):
    """The entry with the matrix shape, the per-call statics (transform,
    alpha) and the prep opts bound (a sharded entry's shard substrate too).
    A quantized plan's mode is dropped: a chain reads the pattern, never the
    coded slab."""
    opts = {k: v for k, v in p.kernel_opts(entry).items() if k != "quant"}
    if entry.substrate in _SHARD_SUBSTRATES:
        opts["sub"] = p.substrate(entry.substrate)
    return functools.partial(entry.fn, shape=tuple(p.csr.shape), **extra,
                             **opts)


def _chain_run(p: PlanBuilder, logical: str, bk: str, ex: dict, exec_fn,
               vjp_kw: dict, *operands):
    """One call of a chain-family entry (``exec_fn`` is ``exec_sddmm`` or
    ``exec_chain``) on ``bk``: over the plan's balanced pattern, or a
    sharded entry over its shard substrate, whose backward runs on the
    inner backend (``ex["inner_backend"]`` on the ladder's rung) over the
    whole pattern."""
    entry = p.entry(logical, bk)
    if entry.substrate in _SHARD_SUBSTRATES:
        inner = ex.get("inner_backend") or p.inner_backend
        vjp = _ChainVJP(p, inner, entry=p.entry(logical, inner), **vjp_kw)
        return exec_fn(_chain_bound(p, entry, ex), None, None, vjp, *operands)
    rows, cols = _chain_pattern(p)
    vjp = _ChainVJP(p, bk, entry=entry, **vjp_kw)
    return exec_fn(_chain_bound(p, entry, ex), rows, cols, vjp, *operands)


def _shut_gate(p: PlanBuilder, backend: str) -> bool:
    """Whether the Hopper kernels run this call (its fuse gates apply)."""
    return backend == "hopper" or (backend == "sharded"
                                   and p.inner_backend == "hopper")


def _check_chain_operands(op: str, p: PlanBuilder, a, b) -> None:
    m, k = p.csr.shape
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{op} needs A (m, d) and B (k, d); got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] != m or b.shape[0] != k:
        raise ValueError(f"operand rows {a.shape[0]}/{b.shape[0]} do not "
                         f"match the pattern shape {(m, k)}")


def _ladder(logical: str, backend: str, run, extra: dict, t: torch.Tensor,
            inner: str | None = None):
    """``guarded_call`` of ``run(backend, extra)``, the rung below (on CPU
    operands ``t``, ``_rung``) running ``run(DEMOTION[backend], extra)`` —
    a sharded call ``run("sharded", extra)`` with the ``"torch"`` inner —
    without the Hopper-only ``fuse`` switch of the fuse gates."""
    demoted = _rung(backend, t, inner)
    ex = {k: v for k, v in extra.items() if k != "fuse"}
    if demoted is None:
        fb = None
    elif backend == "sharded":
        fb = lambda: run(backend, dict(  # noqa: E731
            ex, inner_backend=registry.DEMOTION["sharded"]))
    else:
        fb = lambda: run(demoted, ex)  # noqa: E731
    return guardrails.guarded_call(logical, backend, lambda: run(None, extra),
                                   fallback=fb, fallback_name=demoted,
                                   on_card=t.is_cuda)


def execute_sddmm(p: PlanBuilder, a: torch.Tensor, b: torch.Tensor, *,
                  backend: str | None = None) -> torch.Tensor:
    """Sampled dense-dense matmul over the plan's pattern:
    ``e[i] = <A[row_i], B[col_i]>`` for every nonzero, returned as the
    CSR-ordered ``(nnz,)`` f32 edge-score stream.  Differentiable in ``a``
    and ``b`` (``ExecSddmm``: the SpMMs of A and Aᵀ with the score
    gradient as their stream).  Guarded as ``execute`` is."""
    _check_chain_operands("sddmm", p, a, b)

    def run(bk, extra):
        slab = _chain_run(p, "sddmm", bk or backend, extra, exec_sddmm, {},
                          a, b)
        # the balanced tiling is row-major over the CSR stream (a sharded
        # entry returns the stream): flatten and trim
        return slab.reshape(-1)[:p.csr.nnz]

    return _ladder("sddmm", backend or p.backend, run, {}, a, p.inner_backend)


def execute_chain(p: PlanBuilder, a: torch.Tensor, b: torch.Tensor,
                  x: torch.Tensor, *, transform: str = "identity",
                  alpha=None, backend: str | None = None) -> torch.Tensor:
    """SDDMM→``transform``→SpMM over the plan's pattern:
    ``y = T(mask(A @ Bᵀ)) @ X`` with ``T`` identity, ``alpha``-scale or the
    masked row softmax of ``alpha`` times the scores.

    Fuse gate (``thresholds.chain_fuse_min_n``): at N below it the reference
    runs the unfused xla pair.  A ``"hopper"`` plan there runs the unfused
    pair made of the port's own kernels (SDDMM scores, softmax statistics,
    then the nnz-balanced SpMM on the edge stream), so the plain version
    never takes the card's path; the shut gate bumps ``demote:chain_fuse``,
    the reference's counter of the same decision.

    Differentiable in ``a``, ``b`` and ``x`` (``ExecChain``): the backward
    recomputes the weights, samples ``dW`` over (G, X), applies the
    transform's jacobian (the softmax's row sum by the plan's SpMV) and
    runs ``dA``, ``dB`` and ``dX`` as SpMMs of A and Aᵀ.  Guarded as
    ``execute`` is."""
    if transform not in CHAIN_TRANSFORMS:
        raise ValueError(f"unknown chain transform {transform!r}; expected "
                         f"one of {CHAIN_TRANSFORMS}")
    _check_chain_operands("chain", p, a, b)
    k = p.csr.shape[1]
    if x.ndim not in (1, 2) or x.shape[0] != k:
        raise ValueError(f"chain needs X (k,) or (k, n) with k={k}; got "
                         f"{tuple(x.shape)}")
    n = 1 if x.ndim == 1 else x.shape[1]
    eff = backend or p.backend
    extra: dict = {"transform": transform,
                   "alpha": None if alpha is None else float(alpha)}
    if _shut_gate(p, eff) and n < p.thresholds.chain_fuse_min_n:
        HEALTH.bump("demote:chain_fuse")
        extra["fuse"] = False

    def run(bk, ex):
        return _chain_run(p, "chain", bk or backend, ex, exec_chain,
                          {"transform": transform, "alpha": ex["alpha"]},
                          a, b, x)

    return _ladder("chain", eff, run, extra, a, p.inner_backend)


def execute_attention(p: PlanBuilder, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, scale: float | None = None,
                      bias: torch.Tensor | None = None,
                      backend: str | None = None) -> torch.Tensor:
    """Block-sparse attention over the plan's pattern (DESIGN.md §10):
    ``y = softmax_mask(scale * Q Kᵀ + bias) @ V``, the mask being the
    sparsity pattern.  ``scale`` defaults to ``head_dim**-0.5``; ``bias`` is
    an optional additive per-edge stream in CSR nonzero order, ``(nnz,)``
    (relative-position / ALiBi hooks).  Without a bias this is the softmax
    chain and rides the ``chain`` entries (K7, K8 on the card); with one it
    runs the ``attn_chain`` entries (K9, K10).  Rows the mask leaves empty
    give exactly-zero output rows.

    Fuse gate (``thresholds.attn_fuse_min_seq``): below it the reference
    runs its unfused xla pair.  A ``"hopper"`` plan there runs the port's
    own unfused kernels — ``chain_unfused`` without a bias, K6 → K9 → the
    weights by tensor ops → K1 with one — never the plain version; the shut
    gate bumps ``demote:attn_fuse``.

    Differentiable in ``q``, ``k``, ``v`` and ``bias``: without a bias the
    softmax chain's ``ExecChain``, with one ``ExecAttn`` (``dBias = dZ``,
    carried back from the slab to the flat stream by autograd).  Guarded as
    ``execute`` is, under the logical kernel of the entry it runs."""
    m, kdim = (int(s) for s in p.csr.shape)
    if q.ndim != 2 or k.ndim != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"attention needs Q (m, d) and K (k, d); got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if q.shape[0] != m or k.shape[0] != kdim:
        raise ValueError(f"operand rows {q.shape[0]}/{k.shape[0]} do not "
                         f"match the pattern shape {(m, kdim)}")
    if v.ndim not in (1, 2) or v.shape[0] != kdim:
        raise ValueError(f"attention needs V (k,) or (k, n) with k={kdim}; "
                         f"got {tuple(v.shape)}")
    sc = float(q.shape[1]) ** -0.5 if scale is None else float(scale)
    eff = backend or p.backend
    extra: dict = {}
    if _shut_gate(p, eff) and m < p.thresholds.attn_fuse_min_seq:
        HEALTH.bump("demote:attn_fuse")
        extra["fuse"] = False
    if bias is None:
        def run(bk, ex):
            return _chain_run(p, "chain", bk or backend,
                              dict(ex, transform="softmax", alpha=sc),
                              exec_chain, {"transform": "softmax", "alpha": sc},
                              q, k, v)

        return _ladder("chain", eff, run, extra, q, p.inner_backend)
    if eff == "sharded":
        raise ShardedBiasError(
            "sharded block-sparse attention does not support an additive "
            "bias stream; supported alternatives: (1) keep the bias and run "
            "unsharded — execute_attention(p, ..., backend='hopper') or "
            "'torch' on a single-device plan over the same pattern, or (2) "
            "keep the sharded plan and drop bias= (the no-bias path rides "
            "the sharded softmax chain, cross-shard merge included)")
    if bias.ndim != 1 or bias.shape[0] != p.csr.nnz:
        raise ValueError(f"bias must be a flat ({p.csr.nnz},) per-edge "
                         f"stream in CSR order; got {tuple(bias.shape)}")
    slab = _stream_to_balanced(bias.float(), p.substrate("balanced"))

    def run_attn(bk, ex):
        bk = bk or backend
        entry = p.entry("attn_chain", bk)
        rows, cols = _chain_pattern(p)
        vjp = _ChainVJP(p, bk, entry=entry, transform="softmax", alpha=sc)
        return exec_attn(_chain_bound(p, entry, dict(ex, scale=sc)), rows,
                         cols, vjp, q, k, slab, v)

    return _ladder("attn_chain", eff, run_attn, extra, q)
