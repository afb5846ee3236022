"""RWKV-6 (Finch) — attention-free token mixing with data-dependent decay;
counterpart of ``repro.models.rwkv``.

Time-mix: all per-token projections (r, k, v, g and the decay LoRA) are
computed for the whole sequence at once; only the rank-1 WKV state update
runs over time, a loop over the tokens here where the reference scans, with
the state in f32.  State per head is (N, N), the outer-product memory.

Decode carries (wkv_state (B,H,N,N), x_prev (B,D)): no KV cache, so the
cache is O(1) in the sequence length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dot
from .sharding_ctx import gathered


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor | None):
    """x (B,S,D) → previous-token view; x_prev (B,D) seeds streaming mode."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _lerp(x, prev, mu):
    return x + (prev - x) * mu[None, None, :].to(x.dtype)


def wkv6_scan(r, k, v, w, u, state):
    """The WKV recurrence.  r,k,v (B,S,H,N); w (B,S,H,N) decay in (0,1);
    u (H,N) bonus; state (B,H,N,N).  Returns (y (B,S,H,N), state)."""
    ys = []
    bonus = u[None, :, :, None]
    for t in range(r.shape[1]):
        kt, wt = k[:, t], w[:, t]                               # (B,H,N) each
        kv = kt[..., :, None] * v[:, t, :, None, :]             # rank-1 update
        y = torch.einsum("bhi,bhij->bhj", r[:, t], state + bonus * kv)
        state = state * wt[..., None] + kv
        ys.append(y)
    return torch.stack(ys, dim=1), state


def rwkv6_time_mix(p: dict, x: torch.Tensor, n_heads: int, *,
                   state=None, x_prev=None):
    """x (B,S,D).  Returns (out, (state, x_prev_new))."""
    bsz, s, d = x.shape
    n = d // n_heads
    prev = _token_shift(x, x_prev)

    # the parameters read outside ``dot``, gathered on a placed step
    mu_r, mu_k, mu_v, mu_w, mu_g, w0, u_bonus, ln_w, ln_b = (
        gathered(p[k]) for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                                 "w0", "u_bonus", "ln_w", "ln_b"))
    xr = _lerp(x, prev, mu_r)
    xk = _lerp(x, prev, mu_k)
    xv = _lerp(x, prev, mu_v)
    xw = _lerp(x, prev, mu_w)
    xg = _lerp(x, prev, mu_g)

    # whole: at decode on placed parameters each position runs the
    # recurrence on every head (the state is not split), so the projections'
    # column slices are gathered
    r = dot(xr, p["w_r"], whole=True).reshape(bsz, s, n_heads, n)
    k = dot(xk, p["w_k"], whole=True).reshape(bsz, s, n_heads, n)
    v = dot(xv, p["w_v"], whole=True).reshape(bsz, s, n_heads, n)
    g = F.silu(dot(xg, p["w_g"], whole=True))

    # data-dependent decay (the Finch contribution): w = exp(-exp(w0 + lora))
    lora = dot(xw, p["w_decay_a"])
    lora = dot(torch.tanh(lora), p["w_decay_b"], whole=True)
    w = torch.exp(-torch.exp(torch.clamp(
        w0[None, None].float() + lora.float(), -8.0, 8.0)))
    w = w.reshape(bsz, s, n_heads, n)

    if state is None:
        state = torch.zeros((bsz, n_heads, n, n), dtype=torch.float32,
                            device=x.device)
    y, state = wkv6_scan(r.float(), k.float(), v.float(), w,
                         u_bonus.reshape(n_heads, n).float(), state)
    # per-head groupnorm
    mean = y.mean(dim=-1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = (y.reshape(bsz, s, d) * ln_w[None, None].float()
         + ln_b[None, None].float())
    out = dot(y.to(x.dtype) * g.to(x.dtype), p["w_o"])
    return out, (state, x[:, -1])


def rwkv6_channel_mix(p: dict, x: torch.Tensor, *, x_prev=None):
    """Squared-ReLU channel mix.  Returns (out, x_prev_new)."""
    prev = _token_shift(x, x_prev)
    xk = _lerp(x, prev, gathered(p["mu_ck"]))
    xr = _lerp(x, prev, gathered(p["mu_cr"]))
    k = dot(xk, p["w_ck"])
    k = torch.square(F.relu(k))
    kv = dot(k, p["w_cv"])
    r = torch.sigmoid(dot(xr, p["w_cr"]).float())
    return r.to(x.dtype) * kv, x[:, -1]
