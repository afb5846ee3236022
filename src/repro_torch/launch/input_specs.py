"""Shape-only stand-ins for every (architecture x shape-cell) input;
counterpart of ``repro.launch.input_specs``.

A stand-in is a ``meta`` tensor: shape and type, no storage.  A meta tensor
carries no sharding, so each tree of stand-ins comes with a parallel tree of
``NamedSharding``s (the same keys).  The dry run traces the cell's step on
the stand-ins and sizes each device's share from the shardings.
"""
from __future__ import annotations

import functools
import os
from typing import Any, NamedTuple

import torch

from ..dist.placement import device_put
from ..models import Model, ModelConfig, ShapeCell
from ..models.model import cache_logical
from ..models.params import abstract_params, param_bytes, param_shardings
from ..models.sharding_ctx import activation_sharding
from ..models.transformer import model_specs
from ..train import OptConfig, TrainConfig, init_state, make_train_step
from ..train.optim import tree_map
from .mesh import H100, MODEL_AXIS, Mesh
from .train import param_placement
from .sharding_rules import (LONG_CTX_OVERRIDES, SPARSE_WEIGHT_RULES,
                             TRAIN_RULES, make_sharding_fn, resolve_rules)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def rules_for_cell(cell: ShapeCell, cfg: ModelConfig | None = None, *,
                   model_axis: int = MODEL_AXIS,
                   hbm_bytes: float = H100.hbm_bytes) -> dict:
    """The reference's regimes: weights gathered for train and prefill;
    at decode, weights TP-sharded over ``model`` and replicated over the
    DP axes when a device's share, ``param_bytes / model_axis``, is under
    half of ``hbm_bytes`` (else FSDP kept).  The reference hard-wires a
    v5e (``/ 16``, ``< 8e9``); ``model_axis=16, hbm_bytes=16e9`` gives its
    rules.  A ``cfg`` with a sparse FFN adds ``SPARSE_WEIGHT_RULES`` (its
    value streams' tiles over the DP axes), as ``launch.train.
    train_rules`` does."""
    if cell.name == "long_500k":
        rules = resolve_rules(TRAIN_RULES, LONG_CTX_OVERRIDES)
    else:
        rules = resolve_rules(TRAIN_RULES)
    if cfg is not None and cfg.sparse_ffn is not None:
        rules.update(SPARSE_WEIGHT_RULES)
    if cell.kind in ("train", "prefill"):
        rules["__gather_weights__"] = True
    elif cfg is not None:
        per_dev = param_bytes(model_specs(cfg)) / model_axis
        if per_dev < hbm_bytes / 2:
            rules["embed"] = ()
    return rules


def finalize_rules(rules: dict, mesh: Mesh) -> dict:
    """One MoE dispatch group per device."""
    rules["__moe_groups__"] = int(mesh.size)
    return rules


def train_config_for(cfg: ModelConfig) -> TrainConfig:
    """bf16 optimizer moments for the ≥50B archs, as the reference."""
    big = cfg.name in ("kimi-k2-1t-a32b", "qwen2-vl-72b")
    return TrainConfig(opt=OptConfig(moment_dtype="bfloat16" if big else "float32"))


def batch_specs(cfg: ModelConfig, cell: ShapeCell, sfn):
    """``(stand-ins, shardings)`` of the cell's batch."""
    b, s = cell.global_batch, cell.seq_len
    out = {"tokens": _meta((b, s), torch.int32)}
    shard = {"tokens": sfn(("batch", None))}
    if cell.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
        shard["labels"] = sfn(("batch", None))
    if cfg.family == "audio":
        out["frames"] = _meta((b, cfg.num_frames, cfg.d_model), torch.float32)
        shard["frames"] = sfn(("batch", None, None))
    return out, shard


def cache_specs(model: Model, batch: int, max_len: int, sfn):
    """``(stand-ins, shardings)`` of the caches, shapes from
    ``Model.init_cache(..., device="meta")``."""
    shapes = model.init_cache(batch, max_len, device="meta")

    def walk(tree, keys):
        if isinstance(tree, dict):
            pairs = {k: walk(v, keys + (k,)) for k, v in tree.items()}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        return tree, sfn(cache_logical(keys, tree.ndim))

    return walk(shapes, ())


def state_specs(model: Model, tcfg: TrainConfig, sfn):
    """``(stand-ins, shardings)`` of the train state: params, AdamW moments
    in ``tcfg.opt.moment_dtype`` on the params' shardings, the step."""
    params = abstract_params(model.specs)
    shard = param_shardings(model.specs, sfn)
    mdt = getattr(torch, tcfg.opt.moment_dtype)

    def moments():
        return tree_map(lambda p: _meta(p.shape, mdt), params)
    state = {"params": params,
             "opt": {"step": _meta((), torch.int32), "m": moments(),
                     "v": moments()}}
    shardings = {"params": shard,
                 "opt": {"step": sfn(()), "m": shard, "v": shard}}
    return state, shardings


class Cell(NamedTuple):
    """A cell's step and inputs: ``fn(*args)``, ``shardings`` parallel to
    ``args``, ``rules`` the resolved rules.  The reference also returns the
    arguments its compiled step donates; the port's step donates none."""
    fn: Any
    args: tuple
    shardings: tuple
    rules: dict


def build_cell(model: Model, cell: ShapeCell, mesh: Mesh,
               act_sharding: bool | None = None, *,
               hbm_bytes: float = H100.hbm_bytes) -> Cell:
    """The cell's step and its inputs.  On a mesh of meta devices (the dry
    run's production meshes) the inputs are stand-ins; on a mesh of real
    devices (``make_local_mesh``) they are placed by their shardings
    (``dist.placement``): params from ``Model.init`` with a generator
    seeded 0, AdamW moments at zero, tokens drawn from it, caches at zero,
    which the runtime runs (``models/spmd.py``: train and prefill
    weight-gathered, decode tensor-parallel; a sparse FFN's value streams
    placed by ``launch.train.param_placement``).
    ``act_sharding`` installs the activation-sharding scope while the step
    runs (default on; ``REPRO_ACT_SHARDING=0`` turns it off): the rules,
    with the weight gather of train and prefill and the MoE's dispatch
    groups (``__moe_groups__``).  Decode's rules read the mesh's ``model``
    extent and ``hbm_bytes``."""
    built = _build_cell(model, cell, mesh, act_sharding, hbm_bytes)
    if mesh.devices.reshape(-1)[0].type == "meta":
        return built
    return built._replace(args=_placed_args(model, cell, built, mesh))


def _placed_args(model: Model, cell: ShapeCell, built: Cell,
                 mesh: Mesh) -> tuple:
    """The cell's inputs made real on the first position's device and placed
    by their shardings."""
    cfg = model.cfg
    dev = mesh.devices.reshape(-1)[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)

    def tokens(t):
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             device=dev, dtype=t.dtype)

    def batch(stand_in):
        return {k: tokens(v) if k in ("tokens", "labels") else
                torch.zeros(v.shape, dtype=v.dtype, device=dev)
                for k, v in stand_in.items()}
    if cell.kind == "train":
        args = (init_state(params, train_config_for(cfg)),
                batch(built.args[1]))
    elif cell.kind == "prefill":
        args = (params, batch(built.args[1]))
    else:
        args = (params, model.init_cache(cell.global_batch, cell.seq_len,
                                         device=dev),
                tokens(built.args[2]))
    return tuple(device_put(a, s) for a, s in zip(args, built.shardings))


def _build_cell(model: Model, cell: ShapeCell, mesh: Mesh,
                act_sharding: bool | None, hbm_bytes: float) -> Cell:
    cfg = model.cfg
    rules = finalize_rules(
        rules_for_cell(cell, cfg, model_axis=mesh.shape.get("model", 1),
                       hbm_bytes=hbm_bytes), mesh)
    sfn = make_sharding_fn(mesh, rules)
    if act_sharding is None:
        act_sharding = os.environ.get("REPRO_ACT_SHARDING", "1") != "0"

    def wrap(fn):
        def wrapped(*args):
            with activation_sharding(mesh, rules, enabled=act_sharding):
                return fn(*args)
        return wrapped

    if cell.kind == "train":
        tcfg = train_config_for(cfg)
        step = make_train_step(model.loss_fn, tcfg)
        state, state_sh = state_specs(model, tcfg, sfn)
        batch, batch_sh = batch_specs(cfg, cell, sfn)
        return Cell(wrap(step), (state, batch), (state_sh, batch_sh), rules)

    params = abstract_params(model.specs)
    params_sh = param_placement(model, params, mesh, rules)
    if cell.kind == "prefill":
        fn = functools.partial(_prefill_fn, model, cell.seq_len)
        batch, batch_sh = batch_specs(cfg, cell, sfn)
        return Cell(wrap(fn), (params, batch), (params_sh, batch_sh), rules)

    # decode: one new token against a seq_len-deep cache
    caches, caches_sh = cache_specs(model, cell.global_batch, cell.seq_len,
                                    sfn)
    toks = _meta((cell.global_batch, 1), torch.int32)
    return Cell(wrap(_decode_fn(model)), (params, caches, toks),
                (params_sh, caches_sh, sfn(("batch", None))), rules)


def _prefill_fn(model, max_len, params, batch):
    with torch.no_grad():
        return model.prefill(params, batch, max_len)


def _decode_fn(model):
    def fn(params, caches, tokens):
        with torch.no_grad():
            return model.decode_step(params, caches, tokens)
    return fn
