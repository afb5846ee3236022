"""Carry the reference package's state into the port.

The reference's "weights" are its CSR, its calibrated thresholds, its
attention specs, its model configs, its sparse-FFN patterns and
parameters, and a model's parameter tree.  This module turns a reference
CSR's arrays — numpy ``indptr``, ``indices``, ``data`` and ``shape``, e.g.
``np.asarray(csr.indptr)`` —, a thresholds JSON, the fields of the
reference's dataclasses (``dataclasses.asdict``), a sparse FFN's pattern
slabs and parameters (numpy) and a model's nested dicts of numpy arrays
into the port's objects.
It imports nothing of the reference: only arrays, text and plain fields
cross over.  ``alibi_bias`` builds the per-edge bias stream both packages'
attention takes.
"""
from __future__ import annotations

import numpy as np
import torch

from .attention.patterns import AttentionSpec
from .core.formats import CSR, _csr, row_ids_from_indptr
from .core.registry import resolve_device
from .core.selector import SelectorThresholds
from .models.config import (ModelConfig, MoEConfig, SparseFFNConfig,
                            SSMConfig)
from .models.layers import SparsePattern
from .models.params import ParamSpec
from .models.transformer import SparseFFN, model_specs


def csr_from_arrays(indptr, indices, data, shape, *, device="cpu") -> CSR:
    """The port's CSR from a reference CSR's arrays (values keep their
    dtype, index arrays become int32, the shape Python ints).  The triplet
    crosses as it is, defects included — no sort, no coalesce, no clip of
    an index or of the indptr's values — so ``validate=``
    (``core/guardrails.py``) sees what the reference's sees.  Refused with
    ``ValueError``: lengths that disagree (an indptr of other than
    ``shape[0] + 1`` entries, indices and data of different lengths) and
    an index int32 cannot hold, which the cast would wrap into range."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    if len(indptr) != int(shape[0]) + 1 or len(indices) != len(np.asarray(data)):
        raise ValueError("indptr must have shape[0] + 1 entries and indices "
                         "one per value")
    for name, a in (("indptr", indptr), ("indices", indices)):
        if a.size and (int(a.min()) < -2**31 or int(a.max()) >= 2**31):
            raise ValueError(f"{name} holds values int32 cannot hold")
    return _csr(indptr, indices, np.asarray(data), shape, device)


def thresholds_from_json(text: str) -> SelectorThresholds:
    """The port's thresholds from a reference thresholds JSON (v1-v5)."""
    return SelectorThresholds.from_json(text)


def attention_spec_from_fields(**fields) -> AttentionSpec:
    """The port's ``AttentionSpec`` from a reference spec's fields; an
    explicit block mask becomes a tuple of tuples of bools again."""
    if "block_mask" in fields:
        fields["block_mask"] = tuple(tuple(bool(x) for x in row)
                                     for row in fields["block_mask"])
    return AttentionSpec(**fields)


def model_config_from_fields(**fields) -> ModelConfig:
    """The port's ``ModelConfig`` from a reference config's fields, nested
    MoE / SSM / sparse-FFN configs given as dicts."""
    for name, cls in (("moe", MoEConfig), ("ssm", SSMConfig),
                      ("sparse_ffn", SparseFFNConfig)):
        if isinstance(fields.get(name), dict):
            fields[name] = cls(**fields[name])
    if "mrope_sections" in fields:
        fields["mrope_sections"] = tuple(fields["mrope_sections"])
    return ModelConfig(**fields)


def sparse_ffn_from_arrays(cfg: ModelConfig, patterns: dict, params: dict, *,
                           device=None) -> SparseFFN:
    """The port's ``SparseFFN`` computing what the reference's ``ffn_apply``
    computes with ``patterns`` and ``params``: ``patterns`` maps ``gate`` /
    ``up`` / ``down`` to a reference ``SparsePattern``'s ``(rows, cols)``
    slabs (numpy, one layer's), ``params`` maps ``ln`` / ``v_gate`` /
    ``v_up`` / ``v_down`` to numpy arrays, whose type the parameters keep.
    ``device=None`` is the card."""
    dev = resolve_device(device)
    shapes = {"gate": (cfg.d_ff, cfg.d_model), "up": (cfg.d_ff, cfg.d_model),
              "down": (cfg.d_model, cfg.d_ff)}
    pats = {name: SparsePattern.from_arrays(rows, cols, shapes[name],
                                            device=dev)
            for name, (rows, cols) in patterns.items()}
    ffn = SparseFFN(cfg, patterns=pats)
    with torch.no_grad():
        for name, value in params.items():
            t = torch.from_numpy(np.array(value))
            setattr(ffn, name, torch.nn.Parameter(t.to(dev)))
    return ffn


def _tensor(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 ones as ``ml_dtypes`` give them included:
    read through float32, which holds them exactly) as a tensor of
    ``dtype`` on ``dev``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(dev, dtype)


def model_params_from_arrays(cfg: ModelConfig, params: dict, *,
                             device=None) -> dict:
    """The port's parameter tree of ``Model(cfg)`` from the reference's:
    nested dicts of numpy arrays with the same keys and stacking, as
    ``jax.tree_util.tree_map(np.asarray, Model(cfg).init(key))`` gives
    them.  Each leaf takes the type of its ``ParamSpec``; a missing or
    extra key, or a shape other than the spec's, raises ``ValueError``.
    ``device=None`` is the card."""
    dev = resolve_device(device)

    def walk(specs, tree, path):
        if isinstance(specs, ParamSpec):
            if tuple(np.shape(tree)) != specs.shape:
                raise ValueError(f"{path}: shape {np.shape(tree)} != "
                                 f"{specs.shape}")
            return _tensor(tree, specs.dtype, dev)
        if not isinstance(tree, dict) or set(tree) != set(specs):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'params'}: keys {got} != "
                             f"{sorted(specs)}")
        return {k: walk(specs[k], tree[k], f"{path}/{k}") for k in specs}
    return walk(model_specs(cfg), params, "")


def model_patterns_from_arrays(cfg: ModelConfig, patterns: dict, *,
                               device=None) -> dict:
    """The sparse FFN's per-layer patterns of ``Model(cfg, patterns=)``
    from the reference model's stacked ones: ``patterns`` maps ``gate`` /
    ``up`` / ``down`` to ``(rows, cols)`` numpy slabs of shape
    ``(num_layers, n_tiles, tile)`` (a reference ``SparsePattern``'s
    ``rows`` / ``cols``).  Returns ``{name: [SparsePattern, ...]}``, one a
    layer.  ``device=None`` is the card."""
    dev = resolve_device(device)
    shapes = {"gate": (cfg.d_ff, cfg.d_model), "up": (cfg.d_ff, cfg.d_model),
              "down": (cfg.d_model, cfg.d_ff)}
    return {name: [SparsePattern.from_arrays(r, c, shapes[name], device=dev)
                   for r, c in zip(np.asarray(rows), np.asarray(cols))]
            for name, (rows, cols) in patterns.items()}


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def alibi_bias(csr, slope: float) -> np.ndarray:
    """ALiBi's per-edge bias ``−slope·|i − j|`` for query ``i`` and key
    ``j``, as the ``(nnz,)`` float32 stream in ``csr``'s nonzero order
    (``−slope·(i − j)`` on a causal pattern).  ``csr`` is either package's
    CSR: its index arrays are read as numpy."""
    indptr, indices = _host(csr.indptr), _host(csr.indices)
    rows = row_ids_from_indptr(indptr, len(indices)).astype(np.int64)
    dist = np.abs(rows - indices.astype(np.int64))
    return (-float(slope) * dist).astype(np.float32)
