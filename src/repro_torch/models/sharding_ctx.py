"""Activation-sharding context; counterpart of ``repro.models.sharding_ctx``
on one device.

The reference pins activations to mesh axes at a few load-bearing points
(attention q/k/v, block outputs, loss logits).  The port runs on one card
until the sharded backend is ported, so every hook is a single-device
stand-in: ``constrain`` and ``constrain_gemm`` return their argument,
``moe_groups()`` is 1 and ``sparse_shard()`` is ``(None, None)``.
``activation_sharding`` with a mesh refuses, naming the sharded backend.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict, enabled: bool = True):
    """The reference's scope that installs ``(mesh, rules)``.  Disabled or
    without a mesh it is a no-op; enabled with a mesh it raises."""
    if enabled and mesh is not None:
        raise NotImplementedError(
            "activation_sharding: the sharded backend (mesh, rules) is not "
            "ported yet; the port's models run on one device")
    yield


def constrain_gemm(w=None, out=None):
    """``w`` (or ``out`` when given): no weight gathering on one device."""
    return w if out is None else out


def sparse_shard():
    """``(mesh, axis)`` of the sharded sparse layers: none on one device."""
    return None, None


def moe_groups() -> int:
    """Dispatch groups of the grouped MoE: one on one device."""
    return 1


def constrain(x, logical: tuple):
    """``x`` as it is: nothing to pin on one device."""
    del logical
    return x
