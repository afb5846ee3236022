"""The single-process SPMD runtime: train and prefill of the dense, SSM
(RWKV-6), hybrid (Zamba2) and audio (Whisper) families and of the sparse
FFN with the weights gathered at their use, and their decode with the
weights kept split over ``model`` (tensor parallelism); the counterpart of
the reference's GSPMD step under ``repro.launch.input_specs.
rules_for_cell`` (``__gather_weights__`` for train and prefill, classic TP
at decode) and, for the sparse FFN's value streams, ``SPARSE_WEIGHT_RULES``.

Parameters and AdamW moments are ``Placed`` leaves (``dist/placement.
py``), stored sharded by ``param_shardings``.  The step runs the program of
every mesh position (``Model.loss_fn``, ``Model.prefill`` and
``Model.decode_step`` on placed parameters drive it, ``train.step`` and
``train.optim`` run the train step's cross-position parts):

* each position takes its rows of the batch over the ``batch`` axes
  (``(pod, data)`` ∩ the mesh; all rows where they do not divide it, the
  reference's fallback); positions that differ along the other axes
  (``model``) compute the same rows;
* train and prefill (``__gather_weights__``): each weight is all-gathered
  at its use (``gather``, called by ``sharding_ctx.constrain_gemm`` /
  ``gathered``), hierarchically: the ``data`` / ``pod`` axes first,
  ``model`` last; a checkpointed block gathers again in its recompute;
* decode (rules without it): a weight's pieces split over ``model`` stay
  where they are, those over ``data`` / ``pod`` (FSDP kept) are gathered
  at use (``tp_dot``).  A product whose output features are split
  (column-parallel) gives the position's slice of them, all-gathered where
  the caller needs every one; a product whose input features are split
  (row-parallel) takes the slice and all-reduces the partial outputs over
  ``model``.  The embedding is looked up in the position's vocab range
  and all-reduced (``embed_lookup``).  A cache leaf split along its
  sequence, channels or heads is read through a ``LocalView``: attention
  merges the shards' softmax statistics over the cache's sequence axes
  (``layers.decode_attention``);
* the unembedding stays vocab-sharded: a position gathers it over its other
  axes only; train's ``model_loss.lm_loss_vocab_parallel`` combines the
  vocab shards' statistics by ``pmax`` / ``psum`` over the vocab axes and
  the token sums by ``psum`` over the batch axes;
* a sparse FFN's value stream, its tiles placed over the DP axes, is never
  gathered: its pieces are the shards of the sharded SpMM
  (``sparse_matmul``), each run on its own piece with the position's
  columns, the partials summed on the position.

Train and prefill run the positions' programs one after another: they meet
only after the forward (the loss) and in the backward.  Decode's programs
meet inside every block, so ``Runtime.run`` runs each on a thread of its
own, one at a time in the mesh's order: a program runs to its next
collective and hands the turn on (``_Lockstep``), so a step is as
deterministic as a sequential run.

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

from ..core import guardrails, registry
from ..core.guardrails import all_finite as _finite
from ..core.plan import _pattern_impl
from ..core.shard import default_inner_backend, pattern_split, run_pattern_shard
from ..dist.placement import (Placed, block_index, coord, dim_axes, extent,
                              first_placed, placed_leaves, positions)
from ..dist.sharding_rules import (TRAIN_RULES, NamedSharding, PartitionSpec,
                                   partition_spec, resolve_rules)
from ..runtime import faults
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
    runtime does not run on placed parameters (``what``: train, prefill or
    decode): MoE, which needs expert parallelism (item 7b)."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE {what} on placed parameters needs expert "
            "parallelism (experts kept sharded, tokens moved by all-to-all): "
            "not ported yet (ROADMAP item 7b)")


def supports(cfg) -> bool:
    """The runtime runs ``cfg``'s train, prefill and decode on placed
    params."""
    try:
        refuse(cfg, "train")
    except NotImplementedError:
        return False
    return True


# ---------------------------------------------------------------------------
# the runtime of one step
# ---------------------------------------------------------------------------

def gather_rules(mesh: Mesh, decode: bool = False) -> dict:
    """The rules of a placed step: those installed by ``sharding_ctx.
    activation_sharding`` for this mesh, else ``TRAIN_RULES``, with
    ``__gather_weights__`` unless the step is a decode."""
    ctx, _ = sharding_ctx.capture()
    if ctx is not None and ctx[0] == mesh:
        return ctx[1]
    rules = resolve_rules(TRAIN_RULES)
    return rules if decode else dict(rules, __gather_weights__=True)


class Runtime:
    """The mesh, the rules and the activation layout of one step: the
    ``batch`` axes the rows are split over (``batch_axes``), the positions
    whose programs run (every one, or ``only_position``'s), the logs.
    ``decode``: the step is a decode, whose rules keep the weights split
    (no ``__gather_weights__``); train and prefill gather them."""

    def __init__(self, mesh: Mesh, rules: dict, batch: int | None,
                 decode: bool = False):
        if bool(rules.get("__gather_weights__")) == decode:
            raise ValueError(
                "decode on placed parameters runs tensor-parallel, under "
                "rules without __gather_weights__ (rules_for_cell of a "
                "decode cell)" if decode else
                "train and prefill on placed parameters gather the weights "
                "at their use, under rules with __gather_weights__; rules "
                "without it are decode's")
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
        self.lockstep = None

    @classmethod
    def of(cls, tree: Any, batch: int | None = None,
           decode: bool = False) -> "Runtime":
        leaf = first_placed(tree)
        return cls(leaf.mesh, gather_rules(leaf.mesh, decode), batch, decode)

    def run(self, program) -> dict:
        """``{pos: program(pos)}`` of every run position, each inside
        ``at(pos)``.  Programs that meet in collectives (``Position.psum``,
        ``pmax``, ``all_gather``) run on threads of their own, one at a
        time (``_Lockstep``), each in the caller's grad mode, backend
        scope, sentinel and gradient-sentinel scopes and fault injector,
        and on its position's card."""
        if len(self.positions) == 1:
            pos = self.positions[0]
            with self.at(pos):
                return {pos: program(pos)}
        grad, backend = torch.is_grad_enabled(), registry.scoped_backend()
        sentinel = guardrails.active_sentinel()
        grad_sentinel = guardrails.active_grad_sentinel()
        injector = faults.active_injector()

        def body(pos):
            with torch.set_grad_enabled(grad), \
                    registry.backend_scope(backend), \
                    guardrails.sentinel_scope(sentinel), \
                    guardrails.grad_scope(grad_sentinel), \
                    faults.inject_faults(injector), \
                    _on_device(self.device(pos)), self.at(pos):
                return program(pos)
        self.lockstep = _Lockstep(self.positions)
        try:
            return self.lockstep.run(body)
        finally:
            self.lockstep = None

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

    def reads_split(self, leaf: Placed, split: tuple) -> bool:
        """A program reads the cache ``leaf`` as a ``LocalView``: its name
        is in ``split`` and a dim besides the batch is split."""
        return leaf.name.rsplit(".", 1)[-1] in split and \
            not set(leaf.sharded_axes()) <= set(self.batch_axes)

    def cache_views(self, tree: Any, pos: tuple, split: tuple) -> Any:
        """``pos``'s view of each placed leaf of a cache tree, inside its
        program: a ``LocalView`` of the leaves named in ``split`` whose
        other dims are split (a KV cache's sequence, a conv cache's
        channels, an SSM state's heads), the rows of every other leaf —
        all-gathered over the other axes where it is split beyond its batch
        dim (``cut`` takes the position's piece of its new value)."""
        if isinstance(tree, dict):
            return {k: self.cache_views(v, pos, split)
                    for k, v in tree.items()}
        if not isinstance(tree, Placed):
            return tree
        if self.reads_split(tree, split):
            return LocalView(tree, pos)
        if set(tree.sharded_axes()) <= set(self.batch_axes):
            return tree.local(pos)
        return LocalView(tree, pos).gather(keep=self.batch_axes)

    def shardings(self, tree: Any, logical_of, keys: tuple = ()) -> Any:
        """The ``NamedSharding`` of each leaf of ``tree`` (tensors or
        placed leaves): the spec the rules give its logical axes
        ``logical_of(path keys, ndim)`` (``spec_for``)."""
        if isinstance(tree, dict):
            return {k: self.shardings(v, logical_of, keys + (k,))
                    for k, v in tree.items()}
        return NamedSharding(self.mesh, PartitionSpec(*self.spec_for(
            logical_of(keys, len(tree.shape)), tuple(tree.shape))))

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
        out = {pos: self.cut(t, spec, pos) for pos, t in by_pos.items()}
        return self.placed(out, spec, name=".".join(keys))

    def cut(self, t: torch.Tensor, spec: tuple, pos: tuple) -> torch.Tensor:
        """``pos``'s piece of ``t``, whole but for its rows, under
        ``spec``."""
        sl = []
        for d, dim in enumerate(spec):
            axes = [a for a in dim_axes(dim) if a not in self.batch_axes]
            if axes:              # the batch dim holds this position's rows
                b = t.shape[d] // extent(self.mesh, axes)
                i = block_index(self.mesh, pos, axes)
                sl.append(slice(i * b, (i + 1) * b))
            else:
                sl.append(slice(None))
        return t[tuple(sl)].clone() if t.ndim else t

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


class _Aborted(Exception):
    """Another position's program failed: this one stops."""


class _Lockstep:
    """The programs of ``order``'s positions on threads of their own, one
    running at a time: a program runs until its next collective
    (``exchange``), leaves its tensor and hands the turn to the next
    position in ``order``; it resumes once every other program has left
    its tensor for the same collective.  Every program must run the same
    collectives in the same order (SPMD); a program that raises stops the
    others, and ``run`` raises its error."""

    def __init__(self, order: list):
        self.order = list(order)
        self.live = list(order)
        self.turn = self.order[0]
        self.cond = threading.Condition()
        self.rounds: dict = {}         # collective number -> {pos: tensor}
        self.reads: dict = {}
        self.seq = {p: 0 for p in order}
        self.error: BaseException | None = None

    def _await(self, pos):
        while self.turn != pos and self.error is None:
            self.cond.wait()
        if self.error is not None:
            raise _Aborted()

    def _hand_on(self, pos):
        i = self.live.index(pos)
        self.turn = self.live[(i + 1) % len(self.live)]
        self.cond.notify_all()

    def exchange(self, pos: tuple, x: torch.Tensor) -> dict:
        """Every position's tensor of this collective, by position."""
        with self.cond:
            k = self.seq[pos]
            self.seq[pos] = k + 1
            self.rounds.setdefault(k, {})[pos] = x
            self._hand_on(pos)
            self._await(pos)
            got = self.rounds[k]
            if len(got) != len(self.order):
                raise RuntimeError(
                    f"collective {k}: the programs of "
                    f"{sorted(set(self.order) - set(got))} ran no such "
                    "collective (the positions' programs differ)")
            self.reads[k] = self.reads.get(k, 0) + 1
            if self.reads[k] == len(self.order):
                del self.rounds[k], self.reads[k]
            return got

    def run(self, body) -> dict:
        out = {}

        def main(pos):
            try:
                with self.cond:
                    self._await(pos)
                out[pos] = body(pos)
            except _Aborted:
                pass
            except BaseException as err:    # re-raised by the caller
                with self.cond:
                    if self.error is None:
                        self.error = err
            finally:
                with self.cond:
                    i = self.live.index(pos)
                    self.live.remove(pos)
                    if self.turn == pos and self.live:
                        self.turn = self.live[i % len(self.live)]
                    self.cond.notify_all()

        threads = [threading.Thread(target=main, args=(pos,), daemon=True,
                                    name=f"position {pos}")
                   for pos in self.order]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.error is not None:
            raise self.error
        return out


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

    # ------------------------------------- collectives inside the program
    def _members(self, x: torch.Tensor, axes: tuple, kind: str, nbytes,
                 what: str):
        """Record the collective and return the group's tensors in the
        group's order (None when this position's program runs alone)."""
        rt = self.rt
        _record(rt.logs, self.pos, Collective(kind, nbytes, axes,
                                              extent(rt.mesh, axes), 1,
                                              what, "runtime"), "forward")
        if rt.alone:
            return None
        if rt.lockstep is None:
            raise RuntimeError(f"a collective over {axes} ({what}) outside "
                               "Runtime.run")
        got = rt.lockstep.exchange(self.pos, x)
        return [got[q] for q in rt.group(self.pos, axes)]

    def psum(self, x: torch.Tensor, axes, what: str = "") -> torch.Tensor:
        """The sum of ``x`` over the positions along ``axes`` (added in the
        group's order on its first member's device), on this position."""
        axes = tuple(axes)
        if extent(self.rt.mesh, axes) == 1:
            return x
        xs = self._members(x, axes, "all-reduce",
                           x.numel() * x.element_size(), what)
        if xs is None:
            return x.clone()
        total = xs[0].clone()
        for t in xs[1:]:
            total = total + t.to(total.device)
        return total.to(x.device)

    def pmax(self, x: torch.Tensor, axes, what: str = "") -> torch.Tensor:
        """The elementwise max of ``x`` over the positions along ``axes``."""
        axes = tuple(axes)
        if extent(self.rt.mesh, axes) == 1:
            return x
        xs = self._members(x, axes, "all-reduce",
                           x.numel() * x.element_size(), what)
        if xs is None:
            return x.clone()
        total = xs[0]
        for t in xs[1:]:
            total = torch.maximum(total, t.to(total.device))
        return total.to(x.device)

    def all_gather(self, x: torch.Tensor, dim: int, axes,
                   what: str = "") -> torch.Tensor:
        """The positions' ``x`` along ``axes`` concatenated along ``dim``
        in the order of their blocks (``block_index``)."""
        axes = tuple(axes)
        n = extent(self.rt.mesh, axes)
        if n == 1:
            return x
        xs = self._members(x, axes, "all-gather",
                           x.numel() * x.element_size() * n, what)
        if xs is None:
            shape = list(x.shape)
            shape[dim] *= n
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        return torch.cat([t.to(x.device) for t in xs], dim=dim)

    def part(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """This position's block of ``x`` along ``dim`` split over
        ``axes`` (no collective)."""
        n = extent(self.rt.mesh, axes)
        if n == 1:
            return x
        b = x.shape[dim] // n
        return x.narrow(dim, block_index(self.rt.mesh, self.pos, axes) * b, b)


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
        return _gather(_position_of(self).rt, self, tuple(keep))

    def axes(self, dim: int) -> tuple:
        """The mesh axes dim ``dim`` (of this view) is split over."""
        return dim_axes(self.placed.spec[len(self.index) + dim % self.ndim])

    def offset(self, dim: int) -> int:
        """The index, in the whole leaf, of this position's first entry
        along ``dim``."""
        axes = self.axes(dim)
        size = self.shape[dim] // extent(self.placed.mesh, axes)
        return block_index(self.placed.mesh, self.pos, axes) * size

    def part(self, dim: int, axes) -> torch.Tensor:
        """This position's block along ``dim`` over ``axes``, every other
        dim whole: the local piece where the leaf is split so (its other
        axes gathered), else cut from the whole leaf."""
        axes = tuple(axes)
        if axes and self.axes(dim) == axes:
            return self.gather(keep=axes)
        whole = self.gather()
        return sharding_ctx.current_position().part(whole, dim, axes)

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
# decode's tensor parallelism: the split weights' products
# ---------------------------------------------------------------------------

#: the axes decode keeps a weight split over (``rules_for_cell``: heads,
#: ff, ssm_in and vocab over ``model``)
TP_AXES = ("model",)


def _position_of(view: LocalView) -> Position:
    position = sharding_ctx.current_position()
    if position is None or position.pos != view.pos:
        raise RuntimeError(f"{view.name}: a local view of {view.pos} read "
                           f"outside its program ({position and position.pos})")
    return position


def _kept(view: LocalView, dim: int) -> tuple:
    axes = view.axes(dim)
    return axes if any(a in TP_AXES for a in axes) else ()


def tp_dot(a: torch.Tensor, view: LocalView, whole: bool = False
           ) -> torch.Tensor:
    """``a @ W`` for the placed weight ``view`` (``(k, n)``) under decode's
    tensor parallelism, in ``a.dtype``: W's pieces over ``model`` stay,
    its other axes (FSDP kept) are gathered.  W split along ``n``
    (column-parallel): the position's slice of the output features, all
    of them all-gathered when ``whole``.  W split along ``k``
    (row-parallel): ``a`` (its slice, or whole and cut here) times the
    piece, the partial outputs all-reduced over the axes in f32 and cast
    once, as the reference all-reduces its f32 product before the cast (a
    bf16 partial rounded before the sum drifts from the unsharded product
    by a rounding a branch).  The partials come from the product in the
    operands' type with an f32 result (``_f32_product``): the piece is
    read as it is stored."""
    position = _position_of(view)
    w = view.gather(keep=TP_AXES)
    k_axes, n_axes = _kept(view, -2), _kept(view, -1)
    if k_axes:
        if a.shape[-1] != w.shape[-2]:
            a = position.part(a, -1, k_axes)
        y = _f32_product(a, w.to(a.dtype))
        return position.psum(y, k_axes,
                             f"{view.name} (row-parallel)").to(a.dtype)
    y = torch.matmul(a, w.to(a.dtype))
    if n_axes and whole:
        y = position.all_gather(y, -1, n_axes,
                                f"{view.name} (column-parallel)")
    return y


def _f32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (``w`` 2-D) with an f32 result.  On the card a 16-bit
    product is one GEMM that accumulates in f32 and writes f32
    (``torch.mm``'s ``out_dtype``): neither operand is cast, and no f32
    copy of the weight is made.  Elsewhere the operands are cast: a
    product of two bf16 or f16 values is exact in f32, so it is the same
    sum up to the order of its terms."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], w.shape[-1])
    return torch.matmul(a.float(), w.float())


def embed_lookup(view: LocalView, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the embedding ``view`` ``(V, D)`` at ``tokens``, vocab
    split: each position looks up the tokens in its vocab range (zero
    elsewhere), all-reduced over the vocab axes — the table is never
    gathered."""
    position = _position_of(view)
    vaxes = view.axes(0)
    w = view.gather(keep=vaxes)
    if not vaxes:
        return w[tokens]
    ids = tokens - view.offset(0)
    hit = (ids >= 0) & (ids < w.shape[0])
    x = torch.where(hit[..., None], w[ids.clamp(0, w.shape[0] - 1)],
                    torch.zeros((), dtype=w.dtype, device=w.device))
    return position.psum(x, vaxes, f"{view.name} (vocab-parallel lookup)")


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
    position = _position_of(view)
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

