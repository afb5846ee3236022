"""Backend-aware kernel registry; counterpart of ``repro.core.registry``.

The paper's 2x2 design space (row-split / nnz-balanced x sequential /
parallel reduction) gives four logical kernels.  The registry maps
``(logical kernel, backend)`` to one ``KernelEntry``:

* ``"torch"`` — the plain PyTorch lowerings in ``repro_torch.core.spmm``: the
  CPU path and the oracle the Hopper kernels are held to;
* ``"hopper"`` — the hand-written CUDA kernels in ``repro_torch.kernels``;
* ``"bsr"`` — the block-granule backend: all four matmul kernels resolve to
  the one block-sparse SpMM (K11, ``repro_torch.kernels.bsr``) on the BSR
  substrate.

Backend modules register their entries when imported, and are imported on
first resolve.  A matmul entry's ``fn`` has the signature ``fn(substrate, x,
**opts)``; the ``"sddmm"`` and ``"chain"`` entries take the balanced slab's
pattern, ``fn(rows, cols, a, b[, x], *, shape, **opts)``, and the
``"attn_chain"`` entries ``fn(rows, cols, q, k, bias, v, *, shape, scale,
**opts)`` with ``bias`` a slab shaped like ``rows``.  ``opts`` come from
the entry's optional host-side ``prep`` hook, run once per plan.

``DEMOTION`` is the degradation ladder (``core/guardrails.py``): a call on
CPU operands whose kernel fails on ``"hopper"`` or ``"bsr"`` is rerouted,
and counted, to the ``"torch"`` entry of the same logical kernel;
``"torch"`` is the bottom and re-raises.  On the card there is no rung
below: a failing kernel is counted and raises.  A ``"sharded"`` plan's
rung keeps its shards and demotes their inner backend to ``"torch"``
(``core/plan.py``, counted as ``sharded/torch-inner``).

``"sharded"`` (``core/shard.py``) runs a matmul, SDDMM or chain entry of
an inner backend once per shard of a device mesh, on the stacked
per-shard substrates ``shard_ell`` / ``shard_balanced``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Callable, Optional

import torch

#: the paper's 2x2 SpMM space — the kernels ``execute`` dispatches between
MATMUL_KERNELS: tuple[str, ...] = ("rs_sr", "rs_pr", "nb_sr", "nb_pr")

#: every logical kernel an entry may implement: the SpMM space plus the
#: SDDMM and the fused SDDMM→SpMM chain (DESIGN.md §9); ``attn_chain`` is
#: the chain's attention sibling, softmax with an additive per-edge bias
#: (DESIGN.md §10)
LOGICAL_KERNELS: tuple[str, ...] = MATMUL_KERNELS + ("sddmm", "chain",
                                                     "attn_chain")

#: one rung down the degradation ladder (``guardrails.guarded_call``): the
#: backend a failing call of each accelerated backend on CPU operands is
#: rerouted to; for ``"sharded"``, the inner backend its shards demote to
DEMOTION: dict[str, str] = {"hopper": "torch", "bsr": "torch",
                            "sharded": "torch"}

#: substrate format each entry consumes
SUBSTRATES: tuple[str, ...] = ("ell", "balanced", "bsr", "shard_ell",
                               "shard_balanced")


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    logical: str                      # one of LOGICAL_KERNELS
    backend: str                      # "torch" | "hopper" | ...
    substrate: str                    # one of SUBSTRATES
    fn: Callable                      # see the module docstring
    prep: Optional[Callable] = None   # prep(substrate, **ctx) -> opts dict


_REGISTRY: dict[tuple[str, str], KernelEntry] = {}

#: module that registers each backend's kernels; imported on first resolve
_LAZY_BACKENDS: dict[str, str] = {
    "torch": "repro_torch.core.spmm",
    "hopper": "repro_torch.kernels",
    "bsr": "repro_torch.kernels",
    "sharded": "repro_torch.core.shard",
}


def register(logical: str, backend: str, substrate: str, fn: Callable, *,
             prep: Callable | None = None) -> KernelEntry:
    """Register (or replace) the physical implementation of a logical kernel."""
    if logical not in LOGICAL_KERNELS:
        raise ValueError(f"unknown logical kernel {logical!r}; "
                         f"expected one of {LOGICAL_KERNELS}")
    if substrate not in SUBSTRATES:
        raise ValueError(f"unknown substrate {substrate!r}; "
                         f"expected one of {SUBSTRATES}")
    entry = KernelEntry(logical, backend, substrate, fn, prep)
    _REGISTRY[(logical, backend)] = entry
    return entry


def _ensure_backend_loaded(backend: str) -> None:
    mod = _LAZY_BACKENDS.get(backend)
    if mod is not None:
        importlib.import_module(mod)


def resolve(logical: str, backend: str) -> KernelEntry:
    """Look up the physical kernel for (logical, backend), importing the
    backend's module on a miss."""
    entry = _REGISTRY.get((logical, backend))
    if entry is not None:
        return entry
    _ensure_backend_loaded(backend)
    try:
        return _REGISTRY[(logical, backend)]
    except KeyError:
        raise KeyError(
            f"no kernel registered for (logical={logical!r}, backend={backend!r}); "
            f"registered: {sorted(_REGISTRY)}") from None


def available(backend: str | None = None) -> tuple[KernelEntry, ...]:
    """All registered entries, optionally filtered by backend."""
    for b in ((backend,) if backend is not None else tuple(_LAZY_BACKENDS)):
        _ensure_backend_loaded(b)
    return tuple(e for e in _REGISTRY.values()
                 if backend is None or e.backend == backend)


def backends_for(logical: str) -> tuple[str, ...]:
    """The backends that implement ``logical`` (every lazy backend loaded)."""
    for b in _LAZY_BACKENDS:
        _ensure_backend_loaded(b)
    return tuple(b for (name, b) in _REGISTRY if name == logical)


# ---------------------------------------------------------------------------
# scoped backend override (the facade's ``use_backend``)
# ---------------------------------------------------------------------------

_SCOPE = threading.local()


@contextlib.contextmanager
def backend_scope(backend: str | None):
    """Make ``backend`` the default for every ``plan()`` / ``sparse()`` in
    the dynamic extent that names none.  ``None`` is a no-op scope."""
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    if backend is not None:
        stack.append(backend)
    try:
        yield
    finally:
        if backend is not None:
            stack.pop()


def scoped_backend() -> str | None:
    """Innermost ``backend_scope`` override, or None."""
    stack = getattr(_SCOPE, "stack", None)
    return stack[-1] if stack else None


def resolve_device(device) -> torch.device:
    """The device a front door plans on: CUDA (the current card) for
    ``None``, raising when there is none — the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' for the plain 'torch' backend")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def default_backend(device) -> str:
    """The scoped override inside ``backend_scope``; otherwise the Hopper
    kernels for data on a CUDA device and the plain lowerings for data on
    the CPU."""
    scoped = scoped_backend()
    if scoped is not None:
        return scoped
    return "hopper" if torch.device(device).type == "cuda" else "torch"
