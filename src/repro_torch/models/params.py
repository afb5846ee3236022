"""Parameter specifications; counterpart of ``repro.models.params``.

One tree of ``ParamSpec`` per model (nested dicts), consumed by
``init_params`` (real tensors from an explicit ``torch.Generator``),
``abstract_params`` (shape-only stand-ins on the ``meta`` device, for the
dry run), ``param_shardings`` (each leaf's ``NamedSharding``, a parallel
tree), ``param_count`` and ``param_bytes``.  The logical axis names are the
reference's (``layers``, ``embed``, ``heads``, ``experts``, ...), resolved
by the sharding rules (``launch/sharding_rules.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

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


def abstract_params(specs, sharding_fn: Callable | None = None) -> Any:
    """A ``meta`` tensor a leaf, of the spec's shape and type: nothing is
    allocated.  A meta tensor carries no sharding, so ``sharding_fn`` (the
    reference's argument) is only checked to resolve every leaf; the
    shardings themselves are ``param_shardings(specs, sharding_fn)``, a
    tree of the same keys."""
    if sharding_fn is not None:
        param_shardings(specs, sharding_fn)
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device="meta"), specs)


def param_shardings(specs, sharding_fn: Callable) -> Any:
    """``sharding_fn(spec.logical)`` a leaf (a ``NamedSharding``)."""
    return map_specs(lambda s: sharding_fn(s.logical), specs)


def param_count(specs) -> int:
    return int(sum(math.prod(s.shape) for s in _leaves(specs)))


def param_bytes(specs) -> int:
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in _leaves(specs)))
