"""Train-step builder; counterpart of ``repro.train.step``: loss → grads →
(optional microbatch accumulation) → clip → AdamW, one step a call over the
state ``{"params": ..., "opt": ...}`` (nested dicts of tensors); and
``sparse_weight_shardings``, the split of the sparse weights over a mesh."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.guardrails import all_finite
from ..core.registry import backend_scope
from ..dist.placement import device_get, is_placed, per_position
from ..dist.sharding_rules import (SPARSE_WEIGHT_RULES, NamedSharding,
                                   check_divisibility, partition_spec)
from ..models import spmd
from .optim import (OptConfig, adamw_update, init_opt_state, tree_leaves,
                    tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    accum_dtype: str = "float32"
    #: scoped backend of the sparse layers' kernels for the whole step (the
    #: facade's ``use_backend``); None keeps the default of the data's device
    sparse_backend: str | None = None
    #: skip-and-report guardrail (DESIGN.md §12): when the loss or any
    #: floating grad is non-finite, keep the previous params and optimizer
    #: state for this step and report it (``skipped_nonfinite``); the test
    #: is one device tensor and ``torch.where``, with no host sync
    skip_nonfinite: bool = False


def make_train_step(loss_fn: Callable, tcfg: TrainConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics dict)``.

    Returns ``train_step(state, batch) -> (state, metrics)``.  The batch is
    a dict of tensors split along dim 0 into ``tcfg.microbatches`` equal
    parts, whose gradients are summed in ``tcfg.accum_dtype`` and averaged;
    ``tcfg.sparse_backend`` pins the sparse kernels' backend for the step
    through ``use_backend``.  With ``tcfg.skip_nonfinite`` a step whose loss
    or grads hold a non-finite value returns the state it was given, bit
    for bit, and ``skipped_nonfinite`` 1 (a 0-d tensor on the params'
    device, as the all-finite predicate the selection reads).

    On placed state (``dist.placement``) the same step runs on the
    weight-gathered runtime (``models/spmd.py``): each position's rows of
    each microbatch (a microbatch is a slice of the global batch, then
    split over the batch axes, as the reference's), one graph over the
    positions, gradients synced over the batch axes that replicate a leaf,
    AdamW on each position's shards, one non-finite decision for all; the
    metrics are the first position's tensors (the positions hold them
    alike)."""

    def grads_of(params: dict, batch: dict, rt):
        if rt is not None:
            with backend_scope(tcfg.sparse_backend):
                return spmd.grads_of(loss_fn, rt, params, batch)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with backend_scope(tcfg.sparse_backend), torch.enable_grad():
            loss, metrics = loss_fn(leaves, batch)
            grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda _: next(grads), leaves)

    def accumulate(params: dict, batch: dict, rt):
        mb = tcfg.microbatches
        adt = getattr(torch, tcfg.accum_dtype)
        acc = tree_map(per_position(lambda p: torch.zeros(
            p.shape, dtype=adt, device=p.device)), params)
        total = 0.0
        batch = device_get(batch)        # a placed batch splits as logical
        for i in range(mb):
            part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                    for k, v in batch.items()}
            loss, _, grads = grads_of(params, part, rt)
            acc = tree_map(per_position(lambda a, g: a + g.to(adt)), acc, grads)
            total = total + loss
        return total / mb, {}, tree_map(per_position(
            lambda a: (a / mb).to(adt)), acc)

    def train_step(state: dict, batch: dict):
        params, opt = state["params"], state["opt"]
        rt = None
        if is_placed(params):
            rt = spmd.Runtime.of(params,
                                 batch["tokens"].shape[0] // tcfg.microbatches)
        if tcfg.microbatches > 1:
            loss, metrics, grads = accumulate(params, batch, rt)
        else:
            loss, metrics, grads = grads_of(params, batch, rt)
        new_params, new_opt, opt_metrics = adamw_update(params, grads, opt,
                                                        tcfg.opt)
        out = {"loss": loss, **{k: v for k, v in metrics.items()
                                if torch.as_tensor(v).ndim == 0},
               **opt_metrics}
        if tcfg.skip_nonfinite:
            if rt is None:
                ok = _all_finite(loss, grads)
                skipped = ~ok
            else:
                ok = spmd.all_finite(rt, loss, grads)
                skipped = ~ok.local(rt.positions[0])
            new_params = _keep(ok, new_params, params)
            new_opt = _keep(ok, new_opt, opt)
            out["skipped_nonfinite"] = skipped.to(torch.int32)
        return {"params": new_params, "opt": new_opt}, out

    return train_step


def _all_finite(loss: torch.Tensor, grads: dict) -> torch.Tensor:
    """One 0-d bool tensor on the loss's device: the loss and every
    floating grad finite (``guardrails.all_finite``, a reduction each)."""
    checks = [all_finite(loss)]
    checks += [all_finite(g).to(loss.device)
               for g in tree_leaves(grads) if g.is_floating_point()]
    return torch.stack(checks).all()


def _keep(ok, new, old):
    """``new`` where ``ok``, else ``old``, through nested dicts of tensors
    (the state on its own devices); of placed state each position by its
    own copy of ``ok``, a replicated ``Placed``."""
    keep = per_position(lambda n, o, k: torch.where(k.to(n.device), n, o))
    return tree_map(lambda n, o: keep(n, o, ok), new, old)


def init_state(params: dict, tcfg: TrainConfig) -> dict:
    """``{"params": detached copies, "opt": init_opt_state(...)}`` (of
    placed params: placed, each position's copy its own)."""
    params = tree_map(per_position(lambda p: p.detach().clone()), params)
    return {"params": params, "opt": init_opt_state(params, tcfg.opt)}


def sparse_weight_shardings(params: dict, mesh, rules=None) -> dict:
    """A ``NamedSharding`` (the pair ``(mesh, PartitionSpec)``) a leaf for
    the sparse-FFN value streams (``v_gate`` / ``v_up`` / ``v_down``,
    ``(..., tiles, nnz)``): tiles over the DP axes, nnz contiguous — the
    split the sharded SpMM backend makes
    (``dist.sharding_rules.SPARSE_WEIGHT_RULES``); leading (layer) axes
    unsharded, a tile count the axes do not divide replicated.  Other
    leaves map to None (the caller's layout)."""
    rules = rules or SPARSE_WEIGHT_RULES

    def one(name: str, leaf):
        if isinstance(leaf, dict):
            return {k: one(k, v) for k, v in leaf.items()}
        if not name.startswith("v_"):
            return None
        logical = (None,) * (leaf.ndim - 2) + ("tiles", "nnz")
        spec = partition_spec(logical, rules, mesh)
        if not check_divisibility(tuple(leaf.shape), spec, mesh):
            spec = partition_spec((), rules, mesh)
        return NamedSharding(mesh, spec)

    return {k: one(k, v) for k, v in params.items()}
