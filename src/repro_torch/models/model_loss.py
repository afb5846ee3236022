"""Sequence-chunked LM cross-entropy; counterpart of
``repro.models.model_loss``.

The unembed and the softmax cross-entropy run a sequence chunk at a time,
so the live logits are (B, chunk, V), never (B, S, V).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
