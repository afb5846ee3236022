"""Activation-sharding context; counterpart of ``repro.models.sharding_ctx``.

The reference pins activations to mesh axes at a few load-bearing points
(attention q/k/v, block outputs, loss logits) through GSPMD, and in train
and prefill cells (``__gather_weights__``) pins each weight replicated at
its GEMM: the weight-gathered (ZeRO-3) regime.  The port runs that regime
on placed parameters (``dist/placement.py``) through the single-process
SPMD runtime of ``models/spmd.py``, which runs one position's program at a
time inside a *position scope*:

* ``constrain_gemm(w=)`` — and ``gathered(w)`` for the embedding and the
  norms — gathers a placed leaf's local view over its sharded axes (an
  all-gather with a log); a plain tensor is returned as it is.  A local
  view outside the weight-gathered regime (decode's tensor parallelism)
  is refused.
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
    local view all-gathered over its sharded axes (weight-gathered regime
    only; decode's tensor parallelism is not ported)."""
    if w is None or isinstance(w, torch.Tensor):
        return w
    if not gather_weights_mode():
        raise NotImplementedError(
            "a placed weight outside the weight-gathered regime (rules "
            "without __gather_weights__, decode's tensor parallelism over "
            "model) is not ported yet (ROADMAP item 7a)")
    return w.gather()


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
