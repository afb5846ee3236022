"""Parameter specifications; counterpart of ``repro.models.params``.

One tree of ``ParamSpec`` per model (nested dicts), consumed by
``init_params`` (real tensors from an explicit ``torch.Generator``),
``param_count`` and ``param_bytes``.  The logical axis names are the
reference's (``layers``, ``embed``, ``heads``, ``experts``, ...), kept for
sharding rules (``launch/sharding_rules.py``).  The reference's
``abstract_params`` and ``param_shardings`` (the dry run's tooling and
GSPMD placement of dense leaves) are not ported yet (ROADMAP queue 1,
item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..core.registry import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple                  # one name-or-None per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"            # normal | zeros | ones
    scale: float | None = None      # None → 1/sqrt(fan_in) with fan_in=shape[-2 or 0]

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _std(spec: ParamSpec) -> float:
    if spec.scale is not None:
        return spec.scale
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[0], 1)
    return 1.0 / math.sqrt(fan_in)


def map_specs(fn, specs) -> Any:
    """``specs`` with ``fn`` applied to each ``ParamSpec`` leaf (dicts are
    walked in sorted key order, as JAX flattens them)."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, specs[k]) for k in sorted(specs)}


def _leaves(specs) -> list:
    out = []
    map_specs(out.append, specs)
    return out


def init_params(specs, generator: torch.Generator | None = None,
                device=None) -> Any:
    """Real tensors for a spec tree: ``normal`` leaves N(0, ``_std``²) drawn
    in f32 from ``generator`` and cast to the spec's type, ``zeros`` and
    ``ones`` constant.  ``device=None`` is the generator's device, else the
    card.  The stream differs from JAX's; tests carry weights across
    (``interop.model_params_from_arrays``)."""
    if device is None and generator is not None:
        device = generator.device
    dev = resolve_device(device)

    def make(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(_std(spec)).to(spec.dtype)
    return map_specs(make, specs)


def param_count(specs) -> int:
    return int(sum(math.prod(s.shape) for s in _leaves(specs)))


def param_bytes(specs) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in _leaves(specs)))
