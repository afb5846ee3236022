"""Dense tensors placed over a device mesh; counterpart of ``jax.device_put``
/ ``jax.device_get`` with a ``NamedSharding``.

A ``Placed`` leaf holds a logical tensor's shape and type, its
``NamedSharding`` (``dist/sharding_rules.py``) and one tensor a mesh
position, on that position's device: the position's slice of the logical
tensor.  Positions along an axis the leaf is not sharded over hold equal
copies.  A dim whose axes do not divide it is refused with ``ValueError``,
as ``jax.device_put`` refuses it (a shard of ``ceil(n / k)`` rows is what
the dry run's ``shard_bytes`` sizes, never what is placed).

``device_put(tree, shardings)`` places the tensors of a nested dict (a leaf
whose sharding is None is left as it is), ``device_get(tree)`` assembles
each placed leaf back into one tensor, ``local_tree(tree, pos)`` is one
position's view.  Positions are coordinate tuples in the mesh's row-major
order (``positions(mesh)``), the order of ``Mesh.devices``.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from .sharding_rules import NamedSharding, PartitionSpec

if TYPE_CHECKING:
    from ..launch.mesh import Mesh


def positions(mesh: Mesh) -> list:
    """Every position of ``mesh`` as a coordinate tuple, row-major."""
    return list(np.ndindex(mesh.devices.shape))


def dim_axes(dim) -> tuple:
    """The mesh axes of one dim of a ``PartitionSpec``."""
    if dim is None:
        return ()
    return (dim,) if isinstance(dim, str) else tuple(dim)


def full_spec(spec, ndim: int) -> tuple:
    """``spec`` padded with None to ``ndim`` dims."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more dims than the tensor ({ndim})")
    return spec + (None,) * (ndim - len(spec))


def extent(mesh: Mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def coord(mesh: Mesh, pos: tuple, axis: str) -> int:
    return int(pos[mesh.axis_names.index(axis)])


def block_index(mesh: Mesh, pos: tuple, axes) -> int:
    """Which of the ``extent(mesh, axes)`` equal blocks of a dim sharded
    over ``axes`` position ``pos`` holds: over ``(a, b)`` the block
    ``coord(a) * n_b + coord(b)``, as JAX orders a multi-axis dim."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coord(mesh, pos, a)
    return i


def shard_index(mesh: Mesh, spec, shape: tuple, pos: tuple) -> tuple:
    """The slices of the logical tensor that position ``pos`` holds."""
    out = []
    for size, dim in zip(shape, full_spec(spec, len(shape))):
        axes = dim_axes(dim)
        block = size // extent(mesh, axes)
        i = block_index(mesh, pos, axes)
        out.append(slice(i * block, (i + 1) * block))
    return tuple(out)


def check_placeable(shape: tuple, sharding: NamedSharding, name: str = ""):
    """Raise ``ValueError`` where a dim's axes do not divide it, with the
    words of ``jax.device_put``'s refusal."""
    mesh, spec = sharding
    for d, (size, dim) in enumerate(zip(shape, full_spec(spec, len(shape)))):
        axes = dim_axes(dim)
        for a in axes:
            if a not in mesh.axis_names:
                raise ValueError(f"{name or 'leaf'}: spec {tuple(spec)} names "
                                 f"the axis {a!r}, which {mesh} does not have")
        n = extent(mesh, axes)
        if size % n:
            raise ValueError(
                f"{name or 'leaf'} of shape {tuple(shape)} was given the "
                f"sharding {PartitionSpec(*spec)}, which implies that the "
                f"global size of its dimension {d} should be divisible by "
                f"{n}, but it is equal to {size}")


class Placed:
    """A logical tensor over a mesh: ``shape``, ``dtype``, ``sharding`` and
    ``locals``, an object array of the mesh's shape holding each position's
    tensor.  ``name`` is the leaf's path in its tree (collective logs)."""

    __slots__ = ("shape", "dtype", "sharding", "locals", "name")

    def __init__(self, shape, dtype, sharding: NamedSharding, locals_,
                 name: str = ""):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.sharding = sharding
        self.locals = locals_
        self.name = name

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return full_spec(self.sharding.spec, len(self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def local(self, pos: tuple) -> torch.Tensor:
        return self.locals[tuple(pos)]

    def sharded_axes(self) -> list:
        """The mesh axes some dim is sharded over, in the spec's order."""
        return [a for dim in self.spec for a in dim_axes(dim)]

    def map(self, fn, *others: "Placed") -> "Placed":
        """``fn`` of each position's tensor (and ``others``' at the same
        position), on this leaf's sharding: a new ``Placed``."""
        out = np.empty(self.locals.shape, dtype=object)
        for pos in np.ndindex(out.shape):
            if self.locals[pos] is not None:     # a position that did not run
                out[pos] = fn(self.locals[pos],
                              *(o.locals[pos] for o in others))
        first = next(t for t in out.reshape(-1) if t is not None)
        return Placed(self.shape, first.dtype, self.sharding, out, self.name)

    def owns(self, pos: tuple) -> bool:
        """``pos`` is the first of the positions holding its shard (its
        coordinate 0 along every axis the leaf is not sharded over)."""
        sharded = set(self.sharded_axes())
        return all(c == 0 for a, c in zip(self.mesh.axis_names, pos)
                   if a not in sharded)

    def __repr__(self) -> str:
        return (f"Placed({self.name or '?'}, shape={self.shape}, "
                f"{self.dtype}, {PartitionSpec(*self.spec)} on {self.mesh})")


def is_placed(tree: Any) -> bool:
    """True when the first leaf of the nested dict ``tree`` is ``Placed``
    (a placed tree is placed all the way through: ``device_put`` of params
    or state by their shardings)."""
    while isinstance(tree, dict) and tree:
        tree = next(iter(tree.values()))
    return isinstance(tree, Placed)


def per_position(fn):
    """``fn`` of tensors, lifted to placed leaves: on a ``Placed`` first
    argument, ``fn`` of each position's tensors (and of the other
    ``Placed`` arguments' at the same position) on its sharding; on a
    tensor, ``fn`` itself."""
    def lifted(x, *rest):
        if isinstance(x, Placed):
            return x.map(fn, *rest)
        return fn(x, *rest)
    return lifted


def placed_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in placed_leaves(v)]
    return [tree] if isinstance(tree, Placed) else []


def first_placed(tree: Any):
    leaves = placed_leaves(tree)
    return leaves[0] if leaves else None


def put(x, sharding: NamedSharding, name: str = "") -> Placed:
    """One tensor placed by ``sharding``: each position a copy of its slice
    on its own device (a copy even where the device is ``x``'s)."""
    if isinstance(x, Placed):
        x = get(x)
    x = torch.as_tensor(x)
    check_placeable(tuple(x.shape), sharding, name)
    mesh, spec = sharding
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos in positions(mesh):
        piece = x[shard_index(mesh, spec, tuple(x.shape), pos)]
        out[pos] = piece.to(mesh.devices[pos], copy=True).contiguous()
    return Placed(x.shape, x.dtype, sharding, out, name)


def get(p: Placed, device=None) -> torch.Tensor:
    """The logical tensor of ``p``, assembled from the first position that
    holds each shard, on ``device`` (default: the CPU, as ``jax.device_get``
    returns host arrays)."""
    dev = torch.device("cpu" if device is None else device)
    out = torch.empty(p.shape, dtype=p.dtype, device=dev)
    done = set()
    for pos in positions(p.mesh):
        idx = shard_index(p.mesh, p.spec, p.shape, pos)
        key = tuple((s.start, s.stop) for s in idx)
        if key in done:
            continue
        done.add(key)
        out[idx] = p.locals[pos].detach().to(dev)
    return out


def _walk(tree, shardings, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, shardings[k] if isinstance(shardings, dict)
                         else shardings, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if shardings is None:
        return tree
    return put(tree, shardings, path)


def device_put(tree: Any, shardings: Any) -> Any:
    """``tree`` (nested dicts of tensors) with each leaf placed by the
    matching ``NamedSharding`` of ``shardings`` (a tree of the same keys, or
    one sharding for every leaf); a leaf whose sharding is None is kept."""
    return _walk(tree, shardings)


def device_get(tree: Any, device=None) -> Any:
    """``tree`` with every ``Placed`` leaf assembled into one tensor on
    ``device`` (default the CPU)."""
    if isinstance(tree, dict):
        return {k: device_get(v, device) for k, v in tree.items()}
    if isinstance(tree, Placed):
        return get(tree, device)
    return tree


def local_tree(tree: Any, pos: tuple) -> Any:
    """Position ``pos``'s tensors of ``tree`` (other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: local_tree(v, pos) for k, v in tree.items()}
    if isinstance(tree, Placed):
        return tree.local(pos)
    return tree


def replicated(x: torch.Tensor, mesh: Mesh, name: str = "") -> Placed:
    """``x`` copied to every position (the spec ``()``)."""
    return put(x, NamedSharding(mesh, PartitionSpec()), name)
