"""Activation-sharding context; counterpart of ``repro.models.sharding_ctx``.

The reference pins activations to mesh axes at a few load-bearing points
(attention q/k/v, block outputs, loss logits) through GSPMD, and in train
and prefill cells (``__gather_weights__``) pins each weight replicated at
its GEMM: the weight-gathered (ZeRO-3) regime; decode cells keep the
weights split over ``model`` (tensor parallelism).  The port runs both
regimes on placed parameters (``dist/placement.py``) through the
single-process SPMD runtime of ``models/spmd.py``, which runs each
position's program inside a *position scope*:

* ``constrain_gemm(w=)`` — and ``gathered(w)`` for the embedding and the
  norms — gathers a placed leaf's local view over its sharded axes (an
  all-gather with a log); a plain tensor is returned as it is.  Under rules
  without ``__gather_weights__`` a product with a local view is
  tensor-parallel (``tensor_parallel``; ``layers.dot`` runs
  ``spmd.tp_dot``), while ``gathered`` still returns the leaf whole.
* ``local``, ``split_axes``, ``offset`` and ``part`` read a cache leaf or
  a weight that decode keeps split (a tensor is whole: no axes, offset 0);
  ``psum``, ``pmax`` and ``all_gather`` are the position's collectives over
  the axes given (none: the argument as it is).
* ``constrain(x, logical)`` checks a local activation against the spec the
  rules give ``logical`` (the reference's divisibility fallback applied to
  the logical size): its device is the position's and its dims are split
  over the axes the runtime split them over.  It returns ``x``.

Without a position scope the dense hooks return their argument, under a
mesh too.  What a scope carries besides: ``sparse_shard()`` routes the
sparse-weight layers through the sharded backend (rules with the
``__sparse_shard_axis__`` marker, ``launch.sharding_rules.
SPARSE_WEIGHT_RULES``; inside a position the placed value stream's
pieces are the shards, ``models.spmd.sparse_matmul``) and
``moe_groups()`` reads ``__moe_groups__``.  The context is a no-op unless
installed.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_TLS = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict, enabled: bool = True):
    """Install ``(mesh, rules)`` for this thread's dynamic extent (disabled:
    none)."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules) if enabled and mesh is not None else None
    try:
        yield
    finally:
        _TLS.ctx = prev


@contextlib.contextmanager
def position_scope(position):
    """Run one mesh position's program: ``position`` (a ``models.spmd.
    Position``) gathers local views and checks activations for this
    thread's dynamic extent."""
    prev = getattr(_TLS, "position", None)
    _TLS.position = position
    try:
        yield
    finally:
        _TLS.position = prev


def current_position():
    """The position whose program runs on this thread, or None."""
    return getattr(_TLS, "position", None)


def capture() -> tuple:
    """This thread's scopes, for ``restore`` on another thread (autograd's
    recompute of a checkpointed block)."""
    return getattr(_TLS, "ctx", None), getattr(_TLS, "position", None)


@contextlib.contextmanager
def restore(captured: tuple):
    """Re-enter the scopes ``capture`` returned."""
    prev = capture()
    _TLS.ctx, _TLS.position = captured
    try:
        yield
    finally:
        _TLS.ctx, _TLS.position = prev


def gather_weights_mode() -> bool:
    """The installed rules carry ``__gather_weights__`` (train and prefill
    cells)."""
    ctx = getattr(_TLS, "ctx", None)
    return bool(ctx and ctx[1].get("__gather_weights__"))


def gathered(w):
    """``w`` whole on this position: a tensor as it is, a placed leaf's
    local view all-gathered over its sharded axes."""
    if w is None or isinstance(w, torch.Tensor):
        return w
    return w.gather()


def tensor_parallel(w) -> bool:
    """``w`` is a placed leaf's local view under rules without
    ``__gather_weights__``: decode's tensor parallelism, where a product
    keeps the weight's pieces over ``model`` (``spmd.tp_dot``)."""
    return w is not None and not isinstance(w, torch.Tensor) and \
        not gather_weights_mode()


# --------------------------------------------- split leaves inside a program

def local(c):
    """A tensor as it is, a local view's piece on this position."""
    return c if c is None or isinstance(c, torch.Tensor) else c.local()


def split_axes(c, dim: int) -> tuple:
    """The mesh axes dim ``dim`` of ``c`` is split over (a tensor: none)."""
    return () if c is None or isinstance(c, torch.Tensor) else c.axes(dim)


def offset(c, dim: int) -> int:
    """The index, in the whole leaf, of the first entry of ``local(c)``
    along ``dim``."""
    return 0 if c is None or isinstance(c, torch.Tensor) else c.offset(dim)


def part(x, dim: int, axes):
    """This position's block of ``x`` along ``dim`` over ``axes``: of a
    tensor (whole) cut here, of a local view read as its piece (its other
    axes gathered); no axes: ``x`` whole."""
    if not isinstance(x, torch.Tensor):
        return x.part(dim, axes) if axes else x.gather()
    return current_position().part(x, dim, axes) if axes else x


def axes_extent(axes) -> int:
    """The number of positions along ``axes`` of the program's mesh."""
    if not axes:
        return 1
    mesh = current_position().rt.mesh
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def psum(x, axes, what: str = ""):
    """``x`` summed over the positions along ``axes`` (none: ``x``)."""
    return current_position().psum(x, axes, what) if axes else x


def pmax(x, axes, what: str = ""):
    """The elementwise max of ``x`` over the positions along ``axes``."""
    return current_position().pmax(x, axes, what) if axes else x


def all_gather(x, dim: int, axes, what: str = ""):
    """The positions' ``x`` along ``axes`` concatenated along ``dim``."""
    return current_position().all_gather(x, dim, axes, what) if axes else x


def constrain_gemm(w=None, out=None):
    """The weight-gathered GEMM's pins (reference ``:39-55``): ``w`` whole
    at its use (a placed leaf's local view gathered, see ``gathered``) and
    ``out`` batch-sharded, in train and prefill cells; the argument as it
    is otherwise."""
    if w is not None and not isinstance(w, torch.Tensor):
        return gathered(w)
    if not gather_weights_mode():
        return w if out is None else out
    if w is not None:
        return constrain(w, (None,) * w.ndim)
    return constrain(out, ("batch",) + (None,) * (out.ndim - 1))


def sparse_shard():
    """``(mesh, axis)`` of the sharded sparse-weight layers: the installed
    mesh and the rules' ``__sparse_shard_axis__`` when the mesh has that
    axis, else ``(None, None)`` (the single-device path).  Inside a
    position scope ``(None, None)``: a position's sparse layer reads the
    placed value stream's local view, whose pieces are its shards
    (``models.spmd.sparse_matmul``)."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or current_position() is not None:
        return None, None
    mesh, rules = ctx
    axis = rules.get("__sparse_shard_axis__")
    if not axis or axis not in mesh.axis_names:
        return None, None
    return mesh, axis


def moe_groups() -> int:
    """Dispatch groups of the grouped MoE: the rules' ``__moe_groups__``
    (1 without a scope)."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return 1
    return int(ctx[1].get("__moe_groups__", 1))


def constrain(x, logical: tuple):
    """``x`` as it is.  Inside a position scope it is first checked against
    the spec the rules give ``logical`` (``models.spmd.Position.check``);
    without one, nothing is pinned (and a non-dividing dim cannot raise)."""
    position = current_position()
    if position is not None:
        position.check(x, logical)
    return x
