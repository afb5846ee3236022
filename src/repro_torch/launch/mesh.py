"""A device mesh held by one process; counterpart of ``repro.launch.mesh``.

The reference is single-controller: one process holds a ``jax`` mesh and
``shard_map`` runs a body once per device.  ``Mesh`` is the port's
counterpart: named axes over an array of ``torch.device``.  The sharded
backend (``core/shard.py``) runs each shard's kernels on its position's
device, each on a CUDA stream of its own, and moves tensors between
positions by ordered device-to-device copies.  Positions may share a device
(``devices=["cuda:0"] * 4``, or ``["cpu"] * 4`` like XLA's virtual host
devices): the shards then run concurrently on one card's streams.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """Named axes over a ``numpy`` object array of ``torch.device``.

    ``axis_names`` is a tuple of names, ``shape`` a dict of their extents,
    ``devices`` the array reshaped to the extents and ``size`` its number
    of positions.  Two meshes are equal when their names, extents and
    device strings are."""

    def __init__(self, devices, axis_names: tuple):
        src = np.asarray(devices, dtype=object)
        if src.ndim != len(axis_names):
            raise ValueError(f"devices of shape {src.shape} do not match the "
                             f"axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.devices = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            self.devices[idx] = torch.device(src[idx])
        self.shape = {a: int(n) for a, n in zip(self.axis_names, src.shape)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def signature(self) -> tuple:
        """``(axis names, extents, device string of each position)``."""
        return (self.axis_names, tuple(self.shape[a] for a in self.axis_names),
                tuple(str(d) for d in self.devices.reshape(-1)))

    def shard_devices(self, axis: str) -> tuple:
        """The device of each shard along ``axis``: the first position of
        the slice of the mesh that holds that index of ``axis``."""
        pos = self.axis_names.index(axis)
        return tuple(np.take(self.devices, s, axis=pos).reshape(-1)[0]
                     for s in range(self.shape[axis]))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and other.signature() == self.signature()

    def __hash__(self) -> int:
        return hash(self.signature())

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devs = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({axes}; {', '.join(devs)})"


def make_local_mesh(data: int = 1, model: int = 1, *, devices=None) -> Mesh:
    """A ``(data, model)`` mesh.  ``devices=None`` puts the positions on
    ``cuda:0 … cuda:n-1`` and raises when fewer cards are present; a list of
    ``data * model`` devices places them as given, so that shards may share
    one device (``["cuda:0"] * 4``, ``["cpu"] * 4``)."""
    n = int(data) * int(model)
    if n < 1:
        raise ValueError(f"a mesh needs at least one position; got "
                         f"data={data}, model={model}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"make_local_mesh({data}, {model}) needs {n} CUDA devices and "
                f"{have} are present; pass devices=[...] to place shards on "
                "shared devices (e.g. ['cuda:0'] * 4 or ['cpu'] * 4)")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"make_local_mesh({data}, {model}) needs {n} devices; "
                         f"got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(int(data), int(model)), ("data", "model"))
