"""Logical-axis → mesh-axis rules; counterpart of
``repro.launch.sharding_rules`` (``launch/sharding_rules.py`` re-exports
this module under the reference's path).

One table names the mesh axes each logical axis of params, activations,
caches and inputs shards over; ``partition_spec`` resolves a logical tuple
against a mesh, dropping the axes the mesh does not have and never
assigning one mesh axis twice.  ``PartitionSpec`` is a plain tuple and
``NamedSharding`` a ``(mesh, spec)`` pair: ``dist/placement.py`` places
dense tensors by them and ``models/spmd.py`` runs the weight-gathered step
on them; the sparse-weight rules route the sparse layers through the
sharded backend (``models/sharding_ctx.py``,
``train.step.sparse_weight_shardings``).  The tables sit below the models
and the train step, which read them, and the launch tooling, which
composes them.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, NamedTuple, Optional

if TYPE_CHECKING:
    from ..launch.mesh import Mesh

TRAIN_RULES: dict[str, tuple] = {
    "batch": ("pod", "data"),
    # MoE dispatch groups: one per device
    "tokens": ("pod", "data", "model"),
    "vocab": ("model",),
    "embed": ("pod", "data"),          # FSDP: params sharded over DP axes
    "heads": ("model",),
    # kv heads stay replicated; the KV cache shards its sequence instead
    "kv_heads": (),
    "ff": ("model",),
    "experts": ("model",),
    "ssm_in": ("model",),
    "cache_seq": ("model",),
    "head_dim": (),
    "layers": (), "groups": (), "inner": (),
    "tiles": (), "nnz": (),
}

#: the long-context batch=1 cells move the data axis to the sequence
LONG_CTX_OVERRIDES: dict[str, tuple] = {
    "batch": (),
    "cache_seq": ("data", "model"),
}

#: sparse-weight rules (opt-in overrides; ``core/shard.py``): the value
#: streams of pruned-FFN layers, logical ``("tiles", "nnz")``, shard their
#: tile axis over the DP axes — a tile is a fixed-nnz quota, so equal tile
#: counts are equal nonzero counts.  The ``__sparse_shard_axis__`` marker
#: routes the sparse layers' SpMMs through the sharded backend on that axis.
SPARSE_WEIGHT_RULES: dict[str, tuple] = {
    "tiles": ("pod", "data"),
    "nnz": (),
    "__sparse_shard_axis__": "data",
}


class PartitionSpec(tuple):
    """The mesh axes of each dim: None (replicated), a name, or a tuple of
    names.  A plain tuple: ``PartitionSpec("data", None)``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A partition spec on a mesh."""
    mesh: Mesh
    spec: PartitionSpec


def resolve_rules(base: Mapping[str, tuple] = TRAIN_RULES,
                  overrides: Optional[Mapping[str, tuple]] = None) -> dict:
    rules = dict(base)
    if overrides:
        rules.update(overrides)
    return rules


def partition_spec(logical: tuple, rules: Mapping[str, tuple],
                   mesh: Mesh) -> PartitionSpec:
    """Resolve one logical tuple to a ``PartitionSpec`` on ``mesh``."""
    used: set[str] = set()
    dims = []
    for name in logical:
        axes = rules.get(name, ()) if name is not None else ()
        picked = tuple(a for a in axes if a in mesh.axis_names and a not in used)
        used.update(picked)
        if len(picked) == 0:
            dims.append(None)
        elif len(picked) == 1:
            dims.append(picked[0])
        else:
            dims.append(picked)
    return PartitionSpec(*dims)


def make_sharding_fn(mesh: Mesh, rules: Optional[Mapping[str, tuple]] = None):
    """``fn(logical) -> NamedSharding`` under ``rules`` (default
    ``TRAIN_RULES``)."""
    rules = rules or TRAIN_RULES

    def fn(logical: tuple) -> NamedSharding:
        return NamedSharding(mesh, partition_spec(logical, rules, mesh))

    return fn


def check_divisibility(shape: tuple, spec: PartitionSpec, mesh: Mesh) -> bool:
    """True when every sharded dim divides evenly by its axes' extent."""
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if dim % n:
            return False
    return True
