"""Gradient and optimizer-state compression with error feedback;
counterpart of ``repro.train.compress``.

* ``int8_encode`` / ``int8_decode`` — per-tensor symmetric int8, the same
  objects as ``core.quant``'s (shared with the quantized value streams);
* ``ef_accumulate`` — error feedback: the quantization residual is carried
  and added back at the next round, so compression error does not bias the
  optimizer;
* ``tree_int8_encode`` / ``tree_int8_decode`` — the pair over a nest of
  dicts, lists and tuples of tensors (the reference's pytrees).

The sharded int8 all-reduce over a mesh is ``train/manual_collectives.py``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.quant import int8_decode, int8_encode  # noqa: F401 (re-export)


def ef_accumulate(grad: torch.Tensor, residual: torch.Tensor):
    """Quantize ``grad + residual``; return ``(q, scale, new_residual)``."""
    target = grad.float() + residual
    q, scale = int8_encode(target)
    new_residual = target - int8_decode(q, scale)
    return q, scale, new_residual


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on the tensors of ``tree`` (and the matching leaves of
    ``rest``), keeping its dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_int8_encode(tree: Any) -> tuple[Any, Any]:
    """``(codes, scales)``: two nests shaped like ``tree``."""
    if isinstance(tree, dict):
        pairs = {k: tree_int8_encode(v) for k, v in tree.items()}
        return ({k: q for k, (q, _) in pairs.items()},
                {k: s for k, (_, s) in pairs.items()})
    if isinstance(tree, (list, tuple)):
        pairs = [tree_int8_encode(v) for v in tree]
        kind = list if isinstance(tree, list) else tuple
        return kind(q for q, _ in pairs), kind(s for _, s in pairs)
    return int8_encode(tree)


def tree_int8_decode(qs: Any, scales: Any) -> Any:
    return _tree_map(int8_decode, qs, scales)
