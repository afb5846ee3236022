"""Sequence-chunked LM cross-entropy; counterpart of
``repro.models.model_loss``.

The unembed and the softmax cross-entropy run a sequence chunk at a time,
so the live logits are (B, chunk, V), never (B, S, V).
``lm_loss_vocab_parallel`` is the same loss over a mesh's positions with
the unembedding vocab-sharded (the weight-gathered runtime,
``models/spmd.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .sharding_ctx import constrain


def lm_loss(hidden: torch.Tensor, w_unembed: torch.Tensor,
            labels: torch.Tensor, chunk: int = 512):
    """hidden (B, S, D), w_unembed (D, V), labels (B, S) int (-1 = ignore).
    Returns (mean CE over valid tokens, n_valid), both f32 0-d tensors."""
    b, s, d = hidden.shape
    c = min(chunk, s)
    if s % c:
        pad = c - s % c
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s = s + pad
    w = w_unembed.float()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        h, y = hidden[:, c0:c0 + c], labels[:, c0:c0 + c]
        logits = h.float() @ w                                 # (B, c, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, y.clamp_min(0).long()[..., None])[..., 0]
        mask = (y >= 0).float()
        tot = tot + torch.sum((logz - gold) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / cnt.clamp_min(1.0), cnt


def lm_loss_vocab_parallel(hidden: dict, w_local: dict, labels: dict,
                           vocab_start: dict, rt, vocab_axes: tuple,
                           chunk: int = 512):
    """``lm_loss`` over the positions of a mesh (``models.spmd.Runtime``),
    the unembedding vocab-sharded as the reference's pins make it
    (reference ``:34-42``).  Per position ``p``: ``hidden[p]`` (B_l, S, D)
    its rows, ``w_local[p]`` (D, V_l) its vocab shard starting at
    ``vocab_start[p]``, ``labels[p]`` (B_l, S) (-1 = ignore).

    Each position computes its shard's logits a chunk at a time, their
    logsumexp and the gold logit where the label falls in its shard; the
    vocab axes combine them (``pmax`` of the logsumexps, ``psum`` of
    ``exp(lse - max)`` and of the gold logits), and the batch axes sum the
    token losses and counts, so the mean is over every valid token of the
    global batch (a mean of per-slice means is not).  Returns dicts
    ``(loss, n_valid)``, f32 0-d tensors each position holds alike."""
    some = next(iter(hidden.values()))
    s = some.shape[1]
    c = min(chunk, s)
    pad = (c - s % c) % c
    tot = {p: torch.zeros((), dtype=torch.float32, device=h.device)
           for p, h in hidden.items()}
    cnt = dict(tot)
    for c0 in range(0, s + pad, c):
        hs, ys, lse, gold, mask = {}, {}, {}, {}, {}
        for p, h in hidden.items():
            hb, y = h[:, c0:c0 + c], labels[p][:, c0:c0 + c]
            if hb.shape[1] < c:                  # the padded tail chunk
                hb = F.pad(hb, (0, 0, 0, c - hb.shape[1]))
                y = F.pad(y, (0, c - y.shape[1]), value=-1)
            hs[p], ys[p] = hb.float(), y
        hs = rt.vary(hs, vocab_axes, "loss dh (B, chunk, D)")
        for p in hidden:
            with rt.at(p):
                h = constrain(hs[p], ("batch", None, None))
                w = w_local[p].float()
                logits = constrain(h @ w, ("batch", None, "vocab"))
            y = ys[p]
            v0, vl = vocab_start[p], w.shape[1]
            lse[p] = torch.logsumexp(logits, dim=-1)
            mine = (y >= v0) & (y < v0 + vl)
            g = logits.gather(-1, (y.long() - v0).clamp(0, vl - 1)[..., None])
            gold[p] = torch.where(mine, g[..., 0], 0.0)
            mask[p] = (y >= 0).float()
        top = rt.pmax(lse, vocab_axes, "loss max (B, chunk)")
        ssum = rt.psum({p: torch.exp(lse[p] - top[p]) for p in lse},
                       vocab_axes, "loss sum (B, chunk)")
        gold = rt.psum(gold, vocab_axes, "loss gold (B, chunk)")
        for p in hidden:
            logz = torch.log(ssum[p]) + top[p]
            tot[p] = tot[p] + torch.sum((logz - gold[p]) * mask[p])
            cnt[p] = cnt[p] + torch.sum(mask[p])
    tot = rt.psum(tot, rt.batch_axes, "loss total")
    cnt = rt.psum({p: t.detach() for p, t in cnt.items()}, rt.batch_axes,
                  "loss count")
    return {p: tot[p] / cnt[p].clamp_min(1.0) for p in tot}, cnt
