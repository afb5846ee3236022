"""A device mesh held by one process; counterpart of ``repro.launch.mesh``.

The reference is single-controller: one process holds a ``jax`` mesh and
``shard_map`` runs a body once per device.  ``Mesh`` is the port's
counterpart: named axes over an array of ``torch.device``.  The sharded
backend (``core/shard.py``) runs each shard's kernels on its position's
device, each on a CUDA stream of its own, and moves tensors between
positions by ordered device-to-device copies.  Positions may share a device
(``devices=["cuda:0"] * 4``, or ``["cpu"] * 4`` like XLA's virtual host
devices): the shards then run concurrently on one card's streams.

``make_production_mesh`` gives the dry run's meshes: positions of
``torch.device("meta")``, shape only, at the reference's chip counts.
``Hardware`` holds a card's roofline constants (``H100``, and the
reference's ``V5E`` for parity with its roofline).
"""
from __future__ import annotations

import dataclasses

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


#: the production meshes' ``model`` extent: one node's NVLink domain
MODEL_AXIS = 8


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry run's meshes at the reference's chip counts, so that
    per-device sizes compare: ``(data=32, model=8)``, 256 cards, or
    ``(pod=2, data=32, model=8)``, 512.  ``model`` = 8 is one node's NVLink
    domain; ``data`` and ``pod`` cross nodes.  Positions are
    ``torch.device("meta")``: the mesh places nothing."""
    shape = (2, 32, MODEL_AXIS) if multi_pod else (32, MODEL_AXIS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, "meta", dtype=object), axes)


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One card's roofline constants.  ``links`` maps a link name to its
    per-card rate a direction (B/s); ``axis_link`` names the link each mesh
    axis crosses; ``default_link`` carries wire bytes given as one number."""
    name: str
    peak_flops_bf16: float          # FLOP/s, dense
    hbm_bw: float                   # B/s
    hbm_bytes: float                # capacity
    links: tuple                    # ((link, B/s), ...)
    axis_link: tuple                # ((mesh axis, link), ...)
    default_link: str

    def link_bw(self, link: str) -> float:
        return dict(self.links)[link]

    def link_of(self, axis: str) -> str:
        return dict(self.axis_link).get(axis, self.default_link)


# NVIDIA H100 SXM5, the card `nvidia-smi` names "NVIDIA H100 80GB HBM3" at a
# 700 W power limit.  Datasheet values, not measurements: bf16 dense tensor
# cores 989 TFLOP/s, HBM3 3.35 TB/s and 80 GiB, NVLink 4 900 GB/s both
# directions (450 GB/s a direction a card), InfiniBand NDR 400 Gb/s a card
# (50 GB/s).
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80 * 2 ** 30          # B
NVLINK_BW = 450e9                 # B/s a direction a card
IB_BW = 50e9                      # B/s a card

H100 = Hardware(
    name="NVIDIA H100 80GB HBM3, 700 W (datasheet)",
    peak_flops_bf16=PEAK_FLOPS_BF16, hbm_bw=HBM_BW, hbm_bytes=HBM_BYTES,
    links=(("nvlink", NVLINK_BW), ("ib", IB_BW)),
    axis_link=(("model", "nvlink"), ("data", "ib"), ("pod", "ib")),
    default_link="ib")

# The reference's TPU v5e constants (``repro.launch.mesh``: 197 TFLOP/s bf16,
# 819 GB/s HBM, 50 GB/s ICI a link; 16 GB HBM, whose half is the
# reference's decode threshold).  Kept to check the port's roofline against
# the reference's; they describe no card the port runs on.
V5E = Hardware(
    name="TPU v5e (the reference's constants)",
    peak_flops_bf16=197e12, hbm_bw=819e9, hbm_bytes=16e9,
    links=(("ici", 50e9),),
    axis_link=(("model", "ici"), ("data", "ici"), ("pod", "ici")),
    default_link="ici")
