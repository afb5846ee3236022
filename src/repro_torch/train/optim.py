"""AdamW and its learning-rate schedule; counterpart of
``repro.train.optim``.

Functions on nested dicts of tensors, as the reference's are on pytrees: the
global-norm clip in f32 whatever the gradients' type, linear warmup then
cosine decay to ``min_lr_ratio``, and weight decay decoupled from the
adaptive step.  Nothing is updated in place: each call returns new dicts.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..dist.placement import (first_placed, is_placed, local_tree,
                              per_position, replicated)
from ..models import spmd


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" halves the moments' memory
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor): linear warmup
    to ``cfg.lr``, then cosine decay to ``lr · min_lr_ratio``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, ``rest`` walked by ``tree``'s
    keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]

def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    """``{"step": 0, "m": zeros, "v": zeros}``, the moments in
    ``cfg.moment_dtype`` on each parameter's device and the step on the
    first parameter's (the CPU for none): a step on the card computes its
    learning rate there, with no copy from the host, so ``adamw_update``
    and a ``skip_nonfinite`` step make no host sync."""
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = tree_map(per_position(
        lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)), params)
    if is_placed(params):
        step = replicated(torch.zeros((), dtype=torch.int32),
                          first_placed(params).mesh, "step")
    else:
        leaves = tree_leaves(params)
        step = torch.zeros((), dtype=torch.int32,
                           device=leaves[0].device if leaves else None)
    return {"step": step, "m": zeros,
            "v": tree_map(per_position(torch.clone), zeros)}


def global_norm(tree: dict) -> torch.Tensor:
    """The f32 2-norm of every tensor in ``tree`` together, on the device
    of the first.  Of placed gradients, the norm of the logical ones: each
    position sums the squares of the shards it is the first to hold (a
    replicated copy counts once), a psum over the mesh adds them; a
    replicated ``Placed`` 0-d value."""
    if is_placed(tree):
        rt = spmd.Runtime.of(tree)
        sq = {}
        for p in rt.positions:
            parts = [torch.sum(torch.square(g.local(p).float()))
                     for g in tree_leaves(tree) if g.owns(p)]
            zero = torch.zeros((), dtype=torch.float32, device=rt.device(p))
            sq[p] = torch.stack(parts).sum() if parts else zero
        with torch.no_grad():
            tot = spmd.psum_all(rt, sq, "global norm")
        return rt.rep({p: torch.sqrt(t) for p, t in tot.items()}, "grad_norm")
    sq = [torch.sum(torch.square(t.float())) for t in tree_leaves(tree)]
    if not sq:
        return torch.zeros(())
    return torch.sqrt(torch.stack([s.to(sq[0].device) for s in sq]).sum())


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """One AdamW step: ``(new_params, new_state, {"grad_norm", "lr"})``.
    On placed trees each position updates its own shards (the clip on the
    logical gradients' norm); the metrics are the first position's."""
    if is_placed(params):
        return _adamw_placed(params, grads, state, cfg)
    return _adamw(params, grads, state, cfg, global_norm(grads))


def _adamw_placed(params: dict, grads: dict, state: dict, cfg: OptConfig):
    rt = spmd.Runtime.of(params)
    gnorm = global_norm(grads)
    outs = {p: _adamw(local_tree(params, p), local_tree(grads, p),
                      local_tree(state, p), cfg, gnorm.local(p))
            for p in rt.positions}

    def back(like, pick):
        if isinstance(like, dict):
            return {k: back(v, lambda o, k=k: pick(o)[k])
                    for k, v in like.items()}
        return rt.placed({p: pick(o) for p, o in outs.items()}, like.spec,
                         like.shape, like.name)
    p0 = rt.positions[0]
    return (back(params, lambda o: o[0]), back(state, lambda o: o[1]),
            outs[p0][2])


def _adamw(params: dict, grads: dict, state: dict, cfg: OptConfig,
           gnorm: torch.Tensor):
    step = state["step"] + 1
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    stepf = step.float()
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf
    mdt = getattr(torch, cfg.moment_dtype)

    def one(p, g, m, v):
        dev = p.device
        g32 = g.float() * scale.to(dev)
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mhat, vhat = m32 / bc1.to(dev), v32 / bc2.to(dev)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr.to(dev) * delta).to(p.dtype), m32.to(mdt), \
            v32.to(mdt)
    out = tree_map(one, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda t, i=i: t[i], out)
                           for i in range(3))
    return new_p, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}
