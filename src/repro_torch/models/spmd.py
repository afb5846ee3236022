"""The weight-gathered SPMD runtime, in one process: train and prefill of
the dense, SSM (RWKV-6), hybrid (Zamba2) and audio (Whisper) families and
of the sparse FFN; the counterpart of the reference's GSPMD step under
``__gather_weights__`` (``repro.models.sharding_ctx.constrain_gemm``,
``repro.launch.input_specs.rules_for_cell``) and, for the sparse FFN's
value streams, ``SPARSE_WEIGHT_RULES``.

Parameters and AdamW moments are ``Placed`` leaves (``dist/placement.
py``), stored sharded by ``param_shardings``.  The step runs the program of
every mesh position in turn, in one thread and one autograd graph
(``Model.loss_fn`` and ``Model.prefill`` on placed parameters drive it,
``train.step`` and ``train.optim`` run the step's cross-position parts):

* each position takes its rows of the batch over the ``batch`` axes
  (``(pod, data)`` ∩ the mesh; all rows where they do not divide it, the
  reference's fallback); positions that differ along the other axes
  (``model``) compute the same rows;
* each weight is all-gathered at its use (``gather``, called by
  ``sharding_ctx.constrain_gemm`` / ``gathered``), hierarchically: the
  ``data`` / ``pod`` axes first, ``model`` last; a checkpointed block
  gathers again in its recompute;
* the unembedding stays vocab-sharded: a position gathers it over its other
  axes only, and ``model_loss.lm_loss_vocab_parallel`` combines the vocab
  shards' statistics by ``pmax`` / ``psum`` over the vocab axes and the
  token sums by ``psum`` over the batch axes;
* a sparse FFN's value stream, its tiles placed over the DP axes, is never
  gathered: its pieces are the shards of the sharded SpMM
  (``sparse_matmul``), each run on its own piece with the position's
  columns, the partials summed on the position.

Gradients follow the reference's replication: a value all positions of a
group hold alike has one cotangent, held alike by all of them.  So a
``psum`` whose result a group holds alike passes each position's cotangent
back unchanged; ``vary`` (JAX's ``pbroadcast``, where a value held alike
feeds each vocab shard's logits) sums the cotangents over the group in the
backward; and the all-gather of a weight returns each position's cotangent
to the pieces it read along the batch axes — autograd adds them up, the
reduce-scatter — and *slices* it along the other axes: of a piece held by
another ``model`` position only that position's own copy receives a
gradient.  A sparse matmul's shards hold the pieces of this position's
``model`` coordinate, so each piece's ``dvals`` land there once a position
of its column.  Nothing is ``M`` times too large, and each vocab shard of
the unembedding receives its gradient once.  After the backward, a leaf that
the batch axes replicate has its gradients all-reduced over them
(``sync_grads``).

Every collective records an ``analysis.Collective`` for the position whose
program runs it, forward and backward, in each ``collective_log()`` scope
open when it ran (a gather in a block's recompute records again, as the
reference's remat re-gathers).  ``only_position(pos)`` runs the program of
one position alone, for meta tensors only: the other positions' pieces are
stand-ins, and a collective returns tensors of the right shape — the dry
run's count of the step's collectives (``dryrun.runtime_collectives``).

The collectives are ordered device-to-device copies and adds: positions
may sit on several cards (``make_local_mesh`` puts them on ``cuda:0 …
cuda:n-1``), share one card or the CPU.  One process a card
(``torch.distributed``) is not ported (ROADMAP item 7e).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import TYPE_CHECKING, Any, NamedTuple

import numpy as np
import torch

from ..core import registry
from ..core.guardrails import all_finite as _finite
from ..core.plan import _pattern_impl
from ..core.shard import default_inner_backend, pattern_split, run_pattern_shard
from ..dist.placement import (Placed, block_index, coord, dim_axes, extent,
                              first_placed, placed_leaves, positions)
from ..dist.sharding_rules import (TRAIN_RULES, NamedSharding, PartitionSpec,
                                   partition_spec, resolve_rules)
from . import sharding_ctx

if TYPE_CHECKING:
    from ..launch.mesh import Mesh

_TLS = threading.local()


class Collective(NamedTuple):
    """One collective a device takes part in: ``bytes`` is the all-gather's
    output, the all-reduce's and reduce-scatter's input, the all-to-all's
    and permute's buffer, all per device; ``axes`` the mesh axes of its
    group, ``n`` the group's size; ``count`` how many times the step runs
    it; ``what`` the parameter path or activation it moves (diagnose).
    The runtime's log records them; ``launch/analysis.py`` prices them and
    ``launch/dryrun.py`` plans them."""
    kind: str
    bytes: float
    axes: tuple
    n: int
    count: int = 1
    what: str = ""
    rule: str = ""


# ---------------------------------------------------------------------------
# the collective log
# ---------------------------------------------------------------------------

class CollectiveLog:
    """Collectives recorded while the scope was open: ``records`` is a list
    of ``(position, Collective, "forward" | "backward")``."""

    def __init__(self):
        self.records: list = []
        self._lock = threading.Lock()

    def add(self, pos: tuple, rec: Collective, when: str):
        with self._lock:
            self.records.append((tuple(pos), rec, when))

    def program(self, pos: tuple | None = None) -> list:
        """The ``Collective`` records of one position's program (default:
        the first position that recorded one)."""
        if pos is None and self.records:
            pos = self.records[0][0]
        return [r for p, r, _ in self.records if p == tuple(pos or ())]

    def bytes_by_kind(self, pos: tuple | None = None) -> dict:
        """Per-device bytes (``Collective.bytes`` × count) of one position's
        program by kind."""
        out: dict = {}
        for r in self.program(pos):
            out[r.kind] = out.get(r.kind, 0) + r.bytes * r.count
        return out


@contextlib.contextmanager
def collective_log():
    """Record the collectives run in this thread's dynamic extent (and in
    the backward and recompute of what ran there)."""
    log = CollectiveLog()
    stack = getattr(_TLS, "logs", ())
    _TLS.logs = stack + (log,)
    try:
        yield log
    finally:
        _TLS.logs = stack


def _open_logs() -> tuple:
    return getattr(_TLS, "logs", ())


def _record(logs, pos, rec: Collective, when: str):
    if rec.n <= 1:
        return                        # a group of one moves nothing
    for log in logs:
        log.add(pos, rec, when)


@contextlib.contextmanager
def only_position(pos: tuple):
    """Run the program of position ``pos`` alone (meta tensors only)."""
    prev = getattr(_TLS, "only", None)
    _TLS.only = tuple(pos)
    try:
        yield
    finally:
        _TLS.only = prev


# ---------------------------------------------------------------------------
# refusals: what this runtime does not run
# ---------------------------------------------------------------------------

def refuse(cfg, what: str) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for what the
    weight-gathered runtime does not run on placed parameters: decode
    (item 7a) and MoE (item 7b)."""
    if what == "decode":
        raise NotImplementedError(
            "decode on placed parameters needs the tensor-parallel regime "
            "(weights split over model, an all-reduce a block): not ported "
            "yet (ROADMAP item 7a)")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE on placed parameters needs expert parallelism "
            "(experts kept sharded, tokens moved by all-to-all): not ported "
            "yet (ROADMAP item 7b)")


def supports(cfg) -> bool:
    """The runtime runs ``cfg``'s train and prefill on placed params."""
    try:
        refuse(cfg, "train")
    except NotImplementedError:
        return False
    return True


# ---------------------------------------------------------------------------
# the runtime of one step
# ---------------------------------------------------------------------------

def gather_rules(mesh: Mesh) -> dict:
    """The rules of a placed step: those installed by ``sharding_ctx.
    activation_sharding`` for this mesh, else ``TRAIN_RULES`` with
    ``__gather_weights__``."""
    ctx, _ = sharding_ctx.capture()
    if ctx is not None and ctx[0] == mesh:
        return ctx[1]
    return dict(resolve_rules(TRAIN_RULES), __gather_weights__=True)


class Runtime:
    """The mesh, the rules and the activation layout of one step: the
    ``batch`` axes the rows are split over (``batch_axes``), the positions
    whose programs run (every one, or ``only_position``'s), the logs."""

    def __init__(self, mesh: Mesh, rules: dict, batch: int | None):
        if not rules.get("__gather_weights__"):
            raise NotImplementedError(
                "placed parameters under rules without __gather_weights__ "
                "(decode's tensor parallelism) are not ported yet (ROADMAP "
                "item 7a)")
        self.mesh, self.rules = mesh, rules
        axes = tuple(a for a in rules.get("batch", ()) if a in mesh.axis_names)
        if batch is not None and batch % extent(mesh, axes):
            axes = ()                  # the reference's divisibility fallback
        self.batch_axes = axes
        only = getattr(_TLS, "only", None)
        if only is not None and mesh.devices[only].type != "meta":
            raise ValueError("only_position runs one position's program on "
                             "meta tensors; this mesh holds "
                             f"{mesh.devices[only]}")
        self.positions = [only] if only is not None else positions(mesh)
        self.logs = _open_logs()

    @classmethod
    def of(cls, tree: Any, batch: int | None = None) -> "Runtime":
        leaf = first_placed(tree)
        return cls(leaf.mesh, gather_rules(leaf.mesh), batch)

    # ------------------------------------------------------------ positions
    @property
    def alone(self) -> bool:
        """Only some positions' programs run (shape-only collectives)."""
        return len(self.positions) < self.mesh.size

    def device(self, pos: tuple) -> torch.device:
        return self.mesh.devices[pos]

    def group(self, pos: tuple, axes) -> list:
        """The positions that differ from ``pos`` along ``axes`` only, in
        the order of their coordinates."""
        idx = [self.mesh.axis_names.index(a) for a in axes]
        out = []
        for c in itertools.product(*(range(self.mesh.shape[a]) for a in axes)):
            q = list(pos)
            for i, v in zip(idx, c):
                q[i] = v
            out.append(tuple(q))
        return out

    def rows(self, x: torch.Tensor, pos: tuple) -> torch.Tensor:
        """``pos``'s rows of the logical ``x`` (split along dim 0 over the
        batch axes), on ``pos``'s device."""
        i = block_index(self.mesh, pos, self.batch_axes)
        b = x.shape[0] // extent(self.mesh, self.batch_axes)
        return x[i * b:(i + 1) * b].to(self.device(pos))

    @contextlib.contextmanager
    def at(self, pos: tuple):
        """Run ``pos``'s program: the rules and the position installed."""
        with sharding_ctx.activation_sharding(self.mesh, self.rules), \
                sharding_ctx.position_scope(Position(self, pos)):
            yield

    def views(self, tree: Any, pos: tuple) -> Any:
        """``pos``'s local views of the placed leaves of ``tree``."""
        if isinstance(tree, dict):
            return {k: self.views(v, pos) for k, v in tree.items()}
        if isinstance(tree, Placed):
            return LocalView(tree, pos)
        return tree

    def placed(self, by_pos: dict, spec=PartitionSpec(), shape=None,
               name: str = "") -> Placed:
        """A ``Placed`` from each run position's tensor (``spec`` the layout
        they form; ``shape`` the logical shape, by default the local shape
        times the extents)."""
        some = next(iter(by_pos.values()))
        spec = tuple(spec) + (None,) * (some.ndim - len(tuple(spec)))
        if shape is None:
            shape = tuple(s * extent(self.mesh, dim_axes(d))
                          for s, d in zip(some.shape, spec))
        out = np.empty(self.mesh.devices.shape, dtype=object)
        for pos, t in by_pos.items():
            out[pos] = t
        return Placed(shape, some.dtype, NamedSharding(self.mesh,
                                                       PartitionSpec(*spec)),
                      out, name)

    def rep(self, by_pos: dict, name: str = "") -> Placed:
        """Values every position holds alike, as a replicated ``Placed``."""
        return self.placed(by_pos, PartitionSpec(), name=name)

    def spec_for(self, logical: tuple, shape: tuple) -> tuple:
        """The spec the rules give a tensor of ``shape`` with the axes
        ``logical``: ``batch`` on the runtime's batch axes, a dim its axes
        do not divide kept whole."""
        spec = list(partition_spec(logical, self.rules, self.mesh))
        spec += [None] * (len(shape) - len(spec))
        for d, name in enumerate(logical):
            if name == "batch":
                spec[d] = spec_dim(self.batch_axes)
            elif spec[d] is not None and shape[d] % extent(
                    self.mesh, dim_axes(spec[d])):
                spec[d] = None
        return tuple(spec)

    def place_local(self, by_pos: dict, logical_of, keys: tuple = ()) -> Any:
        """Each run position's tree of tensors, whole but for its rows,
        cut to the spec the rules give each leaf's logical axes
        (``logical_of(path keys, ndim)``): a tree of ``Placed``."""
        some = next(iter(by_pos.values()))
        if isinstance(some, dict):
            return {k: self.place_local({p: c[k] for p, c in by_pos.items()},
                                        logical_of, keys + (k,))
                    for k in some}
        spec = self.spec_for(logical_of(keys, some.ndim), tuple(some.shape))
        out = {}
        for pos, t in by_pos.items():
            sl = []
            for d, dim in enumerate(spec):
                axes = [a for a in dim_axes(dim) if a not in self.batch_axes]
                if axes:          # the batch dim holds this position's rows
                    b = t.shape[d] // extent(self.mesh, axes)
                    i = block_index(self.mesh, pos, axes)
                    sl.append(slice(i * b, (i + 1) * b))
                else:
                    sl.append(slice(None))
            out[pos] = t[tuple(sl)].clone() if t.ndim else t
        return self.placed(out, spec, name=".".join(keys))

    # ---------------------------------------------------------- collectives
    def _groups(self, xs: dict, axes) -> list:
        seen, out = set(), []
        for pos in xs:
            g = tuple(self.group(pos, axes))
            if g not in seen:
                seen.add(g)
                out.append(g)
        return out

    def _log_group(self, xs: dict, g, kind, axes, what, when="forward"):
        n = extent(self.mesh, axes)
        for pos in g:
            if pos in xs:
                t = xs[pos]
                _record(self.logs, pos,
                        Collective(kind, t.numel() * t.element_size(),
                                   tuple(axes), n, 1, what, "runtime"), when)

    def psum(self, xs: dict, axes, what: str = "") -> dict:
        """The sum over each group along ``axes`` (added in the group's
        order on its first member's device), held alike by the group:
        each position's cotangent passes back unchanged."""
        axes = tuple(axes)
        if extent(self.mesh, axes) == 1:
            return dict(xs)
        out = {}
        for g in self._groups(xs, axes):
            here = [p for p in g if p in xs]
            self._log_group(xs, g, "all-reduce", axes, what)
            res = _PSum.apply(self._alone_ok(here, g), *(xs[p] for p in here))
            out.update(zip(here, res if isinstance(res, tuple) else (res,)))
        return out

    def pmax(self, xs: dict, axes, what: str = "") -> dict:
        """The elementwise max over each group along ``axes`` (no
        gradient)."""
        axes = tuple(axes)
        if extent(self.mesh, axes) == 1:
            return {p: t.detach() for p, t in xs.items()}
        out = {}
        for g in self._groups(xs, axes):
            here = [p for p in g if p in xs]
            self._log_group(xs, g, "all-reduce", axes, what)
            self._alone_ok(here, g)
            with torch.no_grad():
                total = xs[here[0]].detach().clone()
                for p in here[1:]:
                    total = torch.maximum(total, xs[p].detach().to(total.device))
                out.update({p: total.to(xs[p].device) for p in here})
        return out

    def vary(self, xs: dict, axes, what: str = "") -> dict:
        """A value the group holds alike, used differently by each member
        (JAX's ``pbroadcast``): the identity forward, the cotangents summed
        over the group backward (an all-reduce, logged then)."""
        axes = tuple(axes)
        if extent(self.mesh, axes) == 1:
            return dict(xs)
        out = {}
        for g in self._groups(xs, axes):
            here = [p for p in g if p in xs]
            meta = (self, here, g, axes, what, self._alone_ok(here, g))
            res = _Vary.apply(meta, *(xs[p] for p in here))
            out.update(zip(here, res if isinstance(res, tuple) else (res,)))
        return out

    def _alone_ok(self, here: list, g) -> bool:
        if len(here) < len(g):
            if not self.alone:
                raise RuntimeError(f"a collective over {g} is missing "
                                   f"{set(g) - set(here)}")
            return True
        return False


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alone, *xs):
        if alone:
            return tuple(x.clone() for x in xs) if len(xs) > 1 else xs[0].clone()
        total = xs[0].clone()
        for x in xs[1:]:
            total = total + x.to(total.device)
        outs = tuple(total.to(x.device, copy=True) for x in xs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + grads


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, *xs):
        ctx.meta = meta
        outs = tuple(x.view_as(x) for x in xs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        rt, here, g, axes, what, alone = ctx.meta
        gs = {p: gr for p, gr in zip(here, grads)}
        rt._log_group(gs, g, "all-reduce", axes, what, "backward")
        if alone:
            return (None,) + grads
        total = grads[0].clone()
        for gr in grads[1:]:
            total = total + gr.to(total.device)
        return (None,) + tuple(total.to(gr.device, copy=True) for gr in grads)


# ---------------------------------------------------------------------------
# one position's program: local views and their gathers
# ---------------------------------------------------------------------------

class Position:
    """One position's program inside ``Runtime.at``: installed by
    ``sharding_ctx.position_scope``, read by ``constrain`` (``check``) and
    by the local views' gathers."""

    def __init__(self, rt: Runtime, pos: tuple):
        self.rt, self.pos = rt, tuple(pos)

    @property
    def device(self) -> torch.device:
        return self.rt.device(self.pos)

    def split(self, name) -> tuple:
        """The mesh axes the runtime splits a logical activation dim over:
        ``batch`` over the batch axes, ``vocab`` over the unembedding's
        vocab axes (the local logits), nothing else."""
        if name == "batch":
            return self.rt.batch_axes
        if name == "vocab":
            return tuple(a for a in self.rt.rules.get("vocab", ())
                         if a in self.rt.mesh.axis_names)
        return ()

    def check(self, x: torch.Tensor, logical: tuple) -> None:
        """``x`` lies on this position's device and each dim is split as
        the rules give ``logical`` (with the reference's fallback to
        unsharded where the axes do not divide the logical size)."""
        mesh, rules = self.rt.mesh, self.rt.rules
        if not _same_device(x.device, self.device):
            raise ValueError(f"an activation on {x.device} in the program of "
                             f"{self.pos} on {self.device}")
        used: set = set()
        for size, name in zip(x.shape, logical):
            have = self.split(name)
            full = size * extent(mesh, have)
            axes = rules.get(name, ()) if name is not None else ()
            picked = tuple(a for a in axes if a in mesh.axis_names
                           and a not in used)
            if not picked or full % extent(mesh, picked):
                picked = ()
            used.update(picked)
            if picked != have:
                raise ValueError(
                    f"activation {tuple(x.shape)} {logical}: dim {name!r} is "
                    f"split over {have} here, the rules give {picked}")


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` are one device."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def gather_order(axes) -> list:
    """The order a leaf is gathered in: the slow axes (``pod``, ``data``)
    first, in the spec's order, ``model`` last."""
    axes = list(axes)
    return [a for a in axes if a != "model"] + [a for a in axes if a == "model"]


class LocalView:
    """Position ``pos``'s view of a placed leaf, indexed along leading dims
    that no axis shards (the stacked layers).  Not a tensor: it is read only
    through ``gather`` (``sharding_ctx.constrain_gemm`` / ``gathered``)."""

    __slots__ = ("placed", "pos", "index")

    def __init__(self, placed: Placed, pos: tuple, index: tuple = ()):
        self.placed, self.pos, self.index = placed, tuple(pos), tuple(index)

    def __getitem__(self, i) -> "LocalView":
        i = i if isinstance(i, tuple) else (i,)
        idx = self.index + i
        for d in range(len(idx)):
            if self.placed.spec[d] is not None:
                raise ValueError(f"{self.placed.name}: dim {d} is sharded "
                                 f"{self.placed.spec}; a local view indexes "
                                 "unsharded leading dims only")
        return LocalView(self.placed, self.pos, idx)

    @property
    def shape(self) -> tuple:
        return self.placed.shape[len(self.index):]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def name(self) -> str:
        suffix = "".join(f"[{i}]" for i in self.index)
        return f"{self.placed.name}{suffix}"

    def local(self) -> torch.Tensor:
        return self.placed.local(self.pos)[self.index]

    def gather(self, keep=()) -> torch.Tensor:
        """This leaf whole on the position (``keep``: axes left sharded)."""
        position = sharding_ctx.current_position()
        if position is None or position.pos != self.pos:
            raise RuntimeError(f"{self.name}: a local view of {self.pos} read "
                               f"outside its program ({position and position.pos})")
        return _gather(position.rt, self, tuple(keep))

    def __repr__(self) -> str:
        return f"LocalView({self.name} at {self.pos})"


def _gather(rt: Runtime, view: LocalView, keep: tuple) -> torch.Tensor:
    """The all-gather of ``view`` at its position over every sharded axis
    but ``keep``, hierarchically (``gather_order``).  The pieces read from
    positions along the batch axes carry gradients (autograd adds them: the
    reduce-scatter); along the others only the position's own piece does."""
    placed, pos, idx = view.placed, view.pos, view.index
    mesh = rt.mesh
    spec = placed.spec[len(idx):]
    shape = placed.shape[len(idx):]
    gathered = []
    out_shape = []
    for size, dim in zip(shape, spec):
        axes = dim_axes(dim)
        g = [a for a in axes if a not in keep]
        if g and len(g) != len(axes):
            raise ValueError(f"{view.name}: dim sharded over {axes} cannot "
                             f"keep {keep} and gather the rest")
        gathered += g
        out_shape.append(size if g else size // extent(mesh, axes))
    order = gather_order(gathered)
    if not order:
        return view.local()
    pieces, slices, attach = [], [], []
    meta = rt.device(pos).type == "meta"
    for q in rt.group(pos, order):
        piece = placed.local(q)[idx]
        attach.append(all(coord(mesh, q, a) == coord(mesh, pos, a)
                          for a in order if a not in rt.batch_axes))
        pieces.append(piece)
        if meta and not attach[-1]:
            slices.append(None)          # shapes only: nothing is copied
            continue
        sl = []
        for size, dim in zip(shape, spec):
            axes = dim_axes(dim)
            if not axes or axes[0] in keep:
                sl.append(slice(None))
                continue
            b, i = size // extent(mesh, axes), block_index(mesh, q, axes)
            sl.append(slice(i * b, (i + 1) * b))
        slices.append(tuple(sl))
    itemsize = pieces[0].element_size()
    full = math.prod(out_shape) * itemsize
    fwd, left = [], extent(mesh, order)
    for a in order:
        left //= mesh.shape[a]
        fwd.append(Collective("all-gather", full // left, (a,), mesh.shape[a],
                              1, view.name, "runtime"))
    bwd, cur = [], full
    for a in reversed(order):
        if a in rt.batch_axes:
            bwd.append(Collective("reduce-scatter", cur, (a,), mesh.shape[a],
                                  1, view.name, "runtime"))
        cur //= mesh.shape[a]
    plan = _GatherPlan(tuple(out_shape), rt.device(pos), tuple(slices),
                       tuple(attach), pos, fwd, bwd, rt.logs)
    return _Gather.apply(plan, *pieces)


class _GatherPlan:
    __slots__ = ("shape", "device", "slices", "attach", "pos", "fwd", "bwd",
                 "logs")

    def __init__(self, shape, device, slices, attach, pos, fwd, bwd, logs):
        self.shape, self.device, self.slices, self.attach = (shape, device,
                                                             slices, attach)
        self.pos, self.fwd, self.bwd, self.logs = pos, fwd, bwd, logs


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _GatherPlan, *pieces):
        ctx.plan = plan
        ctx.devices = [p.device for p in pieces]
        for rec in plan.fwd:
            _record(plan.logs, plan.pos, rec, "forward")
        out = torch.empty(plan.shape, dtype=pieces[0].dtype, device=plan.device)
        if plan.device.type != "meta":
            for sl, p in zip(plan.slices, pieces):
                out[sl] = p
        return out

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        for rec in plan.bwd:
            _record(plan.logs, plan.pos, rec, "backward")
        return (None,) + tuple(
            g[sl].to(dev, copy=True) if att else None
            for sl, dev, att in zip(plan.slices, ctx.devices, plan.attach))


def spec_dim(axes: tuple):
    """One dim of a ``PartitionSpec`` over ``axes``."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


# ---------------------------------------------------------------------------
# the sparse-weight layers: the placed value stream's pieces as the shards
# ---------------------------------------------------------------------------

def sparse_matmul(rows: torch.Tensor, cols: torch.Tensor, shape,
                  view: LocalView, x: torch.Tensor) -> torch.Tensor:
    """``W · x`` in a position's program: W ``(m, k)`` sparse, its pattern
    ``(rows, cols)`` the balanced tiles, its value stream the placed leaf
    ``view`` ``(tiles, tile)``; ``x`` ``(k, T)`` the position's columns.
    Returns ``(m, T)`` on the position's device.

    The shards are the pieces of the stream held by the positions that
    differ from this one along the mesh axes of its tiles dim, taken as
    they are: shard s holds tiles ``[s·per, (s+1)·per)``, the reference's
    split of ``execute_pattern_sharded``.  ``x`` goes to every shard
    (``broadcast``), each runs the kernel ``execute_pattern`` would pick
    for the width of ``x`` on its own piece, and the
    partials are summed on the position (``reduce``), in shard order.  In
    the backward ``dvals`` of each shard (the SDDMM) lands on that shard's
    piece, whose holder shares this position's ``model`` coordinate, and
    the shards' ``dX`` are summed back onto the position.  A replicated
    leaf is one shard: the position's own copy, and nothing moves."""
    position = sharding_ctx.current_position()
    if position is None or position.pos != view.pos:
        raise RuntimeError(f"{view.name}: a local view of {view.pos} read "
                           f"outside its program ({position and position.pos})")
    rt, pos = position.rt, view.pos
    axes = dim_axes(view.placed.spec[len(view.index)])
    group = rt.group(pos, axes)
    devices = [rt.device(q) for q in group]
    backend = default_inner_backend(devices[0])
    entry = registry.resolve(_pattern_impl(x.shape[1]), backend)
    split, per = pattern_split(rows, cols, shape, devices, entry)
    pieces = [view.placed.local(q)[view.index] for q in group]
    if per * len(group) != rows.shape[0] or pieces[0].shape[0] != per:
        raise ValueError(f"{view.name}: {rows.shape[0]} tiles in "
                         f"{len(group)} pieces of {pieces[0].shape[0]}")
    if len(group) == 1:
        return run_pattern_shard(split, 0, entry, backend, pieces[0], x)
    meta = _Moves(rt, pos, group, devices, axes, view.name)
    xs = _Broadcast.apply(meta, x)
    parts = []
    for s, d in enumerate(devices):
        with _on_device(d):
            parts.append(run_pattern_shard(split, s, entry, backend,
                                           pieces[s], xs[s]))
    return _Reduce.apply(meta, *parts)


def _on_device(d: torch.device):
    """The CUDA device ``d`` current (a kernel's launch reads it)."""
    if d.type == "cuda":
        return torch.cuda.device(d)
    return contextlib.nullcontext()


class _Moves:
    """What a sparse matmul's broadcast and reduce record and where they
    go: the position, its shards (``group``) and their devices."""
    __slots__ = ("rt", "pos", "group", "devices", "axes", "what")

    def __init__(self, rt, pos, group, devices, axes, what):
        self.rt, self.pos, self.group, self.devices = rt, pos, group, devices
        self.axes, self.what = tuple(axes), what

    def log(self, kind: str, t: torch.Tensor, when: str):
        _record(self.rt.logs, self.pos,
                Collective(kind, t.numel() * t.element_size(), self.axes,
                           len(self.group), 1, self.what, "runtime"), when)

    def sum_on_position(self, ts) -> torch.Tensor:
        """The sum of ``ts`` in their order, on the position's device."""
        dev = self.rt.device(self.pos)
        total = ts[0].to(dev)
        for t in ts[1:]:
            total = total + t.to(dev)
        return total


class _Broadcast(torch.autograd.Function):
    """The position's ``x`` on each shard's device; backward, the shards'
    cotangents summed onto the position (a reduce)."""

    @staticmethod
    def forward(ctx, meta: _Moves, x):
        ctx.meta = meta
        meta.log("broadcast", x, "forward")
        return tuple(x.view_as(x) if d == x.device else x.to(d)
                     for d in meta.devices)

    @staticmethod
    def backward(ctx, *gs):
        meta = ctx.meta
        meta.log("reduce", gs[0], "backward")
        return None, meta.sum_on_position(gs)


class _Reduce(torch.autograd.Function):
    """The shards' partials summed onto the position, in shard order;
    backward, the position's cotangent on each shard's device (a
    broadcast)."""

    @staticmethod
    def forward(ctx, meta: _Moves, *parts):
        ctx.meta = meta
        meta.log("reduce", parts[0], "forward")
        return meta.sum_on_position(parts)

    @staticmethod
    def backward(ctx, g):
        meta = ctx.meta
        meta.log("broadcast", g, "backward")
        return (None,) + tuple(g.view_as(g) if d == g.device else g.to(d)
                               for d in meta.devices)


# ---------------------------------------------------------------------------
# the train step's cross-position parts
# ---------------------------------------------------------------------------

def psum_all(rt: Runtime, xs: dict, what: str = "") -> dict:
    """``psum`` over every axis of the mesh."""
    return rt.psum(xs, rt.mesh.axis_names, what)


def sync_grads(rt: Runtime, grads: Any) -> Any:
    """Each placed gradient all-reduced over the batch axes that replicate
    its leaf (their copies hold the gradients of different rows)."""
    if isinstance(grads, dict):
        return {k: sync_grads(rt, v) for k, v in grads.items()}
    axes = tuple(a for a in rt.batch_axes if a not in grads.sharded_axes())
    if not axes or extent(rt.mesh, axes) == 1:
        return grads
    xs = {p: grads.local(p) for p in rt.positions}
    with torch.no_grad():
        out = rt.psum(xs, axes, grads.name)
    return rt.placed(out, grads.spec, grads.shape, grads.name)


def grad_leaves(rt: Runtime, params: Any) -> Any:
    """``params`` with each run position's tensor detached and requiring
    grad (the autograd leaves of one step); under ``only_position`` the
    other positions' tensors stay, the stand-ins its gathers read."""
    if isinstance(params, dict):
        return {k: grad_leaves(rt, v) for k, v in params.items()}
    out = {p: params.local(p) for p in positions(rt.mesh)}  # stand-ins
    out.update({p: params.local(p).detach().requires_grad_()
                for p in rt.positions})
    return rt.placed(out, params.spec, params.shape, params.name)


def local_grads(rt: Runtime, loss: Placed, leaves: Any) -> Any:
    """The gradients of every run position's ``leaves`` from the sum of the
    positions' copies of ``loss``, each seeded with 1 (one graph; see the
    module docstring for why 1 and not 1/P)."""
    flat = placed_leaves(leaves)
    ins = [leaf.local(p) for leaf in flat for p in rt.positions]
    outs = [loss.local(p) for p in rt.positions]
    gs = torch.autograd.grad(outs, ins, grad_outputs=[torch.ones_like(o)
                                                     for o in outs],
                             allow_unused=True)
    it = iter(gs)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        out = {}
        for p in rt.positions:
            g = next(it)
            out[p] = torch.zeros_like(tree.local(p)) if g is None else g
        return rt.placed(out, tree.spec, tree.shape, tree.name)
    return rebuild(leaves)


def grads_of(loss_fn, rt: Runtime, params: Any, batch: dict):
    """``(loss, metrics, grads)`` of one (micro)batch on placed params:
    loss and metrics as the first position's tensors (the positions hold
    them alike), the grads placed and synced."""
    leaves = grad_leaves(rt, params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        if not isinstance(loss, Placed):
            raise TypeError("a train step on placed parameters needs a loss "
                            "that runs on them (Model.loss_fn); got "
                            f"{type(loss).__name__}")
        grads = local_grads(rt, loss, leaves)
    grads = sync_grads(rt, grads)
    p0 = rt.positions[0]
    metrics = {k: (v.local(p0) if isinstance(v, Placed) else v).detach()
               for k, v in metrics.items()}
    return loss.local(p0).detach(), metrics, grads


def all_finite(rt: Runtime, loss: torch.Tensor, grads: Any) -> Placed:
    """One decision for every position, a replicated 0-d bool: the loss
    (which the positions hold alike) and every floating gradient of every
    position finite (a ``psum`` of the non-finite counts over the mesh)."""
    bad = {}
    for p in rt.positions:
        dev = rt.device(p)
        checks = [_finite(loss).to(dev)]
        checks += [_finite(g.local(p)).to(dev) for g in placed_leaves(grads)
                   if g.local(p).is_floating_point()]
        bad[p] = (~torch.stack(checks).all()).to(torch.float32)
    with torch.no_grad():
        tot = psum_all(rt, bad, "non-finite guard")
    return rt.rep({p: t == 0 for p, t in tot.items()}, "all_finite")

