"""Activation-sharding context; counterpart of ``repro.models.sharding_ctx``.

The reference pins activations to mesh axes at a few load-bearing points
(attention q/k/v, block outputs, loss logits) through GSPMD.  The port's
dense layers run whole on each device, so ``constrain`` and
``constrain_gemm`` return their argument, under a mesh too (a dim its axis
does not divide, 24 heads on ``model=16``, falls back to unsharded in the
reference and is left as it is here).  What the scope does carry:
``sparse_shard()`` routes the sparse-weight layers through the sharded
backend (rules with the ``__sparse_shard_axis__`` marker,
``launch.sharding_rules.SPARSE_WEIGHT_RULES``) and ``moe_groups()`` reads
``__moe_groups__``.  The context is a no-op unless installed.
"""
from __future__ import annotations

import contextlib
import threading

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


def constrain_gemm(w=None, out=None):
    """``w`` (or ``out`` when given): the port gathers no weights."""
    return w if out is None else out


def sparse_shard():
    """``(mesh, axis)`` of the sharded sparse-weight layers: the installed
    mesh and the rules' ``__sparse_shard_axis__`` when the mesh has that
    axis, else ``(None, None)`` (the single-device path)."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
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
    """``x`` as it is: the port's dense tensors stay whole on each device,
    so no dim is pinned (and a non-dividing one cannot raise)."""
    del logical
    return x
