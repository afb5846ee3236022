"""Mamba-2 (SSD) block — chunked-parallel for train/prefill, recurrent for
decode; counterpart of ``repro.models.ssm``.

The chunked form: within a chunk of length L the recurrence is rewritten as
two products (an L×L decay-masked score matrix and a state outer product);
only the O(S/L) inter-chunk state recurrence is sequential, a loop over the
chunks here where the reference scans.  Plain PyTorch, as the reference is
plain JAX (no Pallas kernel): every product in f32.

Shapes: x (B, S, H, P) heads x head_dim; B/C (B, S, N) (single group);
dt (B, S, H); A (H,) negative; state (B, H, N, P).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import SSMConfig
from .layers import dot
from .sharding_ctx import all_gather, constrain, gathered, local, part, psum, \
    split_axes


def ssd_chunked(x, dt, a_log, b, c, d_skip, *, chunk: int):
    """Chunked SSD scan.  Returns (y, final_state).

    x (B,S,H,P)  dt (B,S,H)  a_log (H,)  b,c (B,S,N)  d_skip (H,)
    """
    bsz, s_in, h, p = x.shape
    n = b.shape[-1]
    l = min(chunk, s_in)
    pad = (-s_in) % l
    if pad:  # dt=0 padding: decay=exp(0)=1, input=0 → state passes through
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    s = s_in + pad
    nc = s // l

    a = -torch.exp(a_log.float())                               # (H,) < 0
    dt32 = dt.float()
    la = dt32 * a[None, None, :]                                # (B,S,H) log-decay
    u = dt32[..., None] * x.float()                             # dt-scaled input

    # chunk views
    lac = la.reshape(bsz, nc, l, h)
    cum = torch.cumsum(lac, dim=2)                              # (B,NC,L,H)
    total = cum[:, :, -1, :]                                    # (B,NC,H)
    uc = u.reshape(bsz, nc, l, h, p)
    bc = b.reshape(bsz, nc, l, n).float()
    cc = c.reshape(bsz, nc, l, n).float()

    # ---- intra-chunk: the decay-masked score product ----
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)            # (B,NC,L,L)
    ii = torch.arange(l, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    # decay(i,j) = exp(cum_i - cum_j) for i >= j, per head
    dec = torch.exp(torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                -60.0, 0.0))                    # (B,NC,L,L,H)
    m = scores[..., None] * torch.where(causal[None, None, :, :, None], dec,
                                        0.0)
    del dec
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, uc)
    del m

    # ---- chunk state summaries: S_k = sum_j exp(total - cum_j) B_j ⊗ u_j ----
    w = torch.exp(torch.clamp(total[:, :, None, :] - cum, min=-60.0))  # (B,NC,L,H)
    sk = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, w, uc)      # (B,NC,H,N,P)

    # ---- inter-chunk recurrence (the only sequential part, NC steps): the
    # state entering each chunk is kept, as the reference's scan returns ----
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    h_prevs = []
    decay = torch.exp(total)                                    # (B,NC,H)
    for k in range(nc):
        h_prevs.append(hstate)
        hstate = hstate * decay[:, k, :, None, None] + sk[:, k]
    h_prevs = torch.stack(h_prevs, dim=1)                       # (B,NC,H,N,P)

    # ---- inter-chunk contribution: C_i · h_{k-1} * exp(cum_i) ----
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", cc, torch.exp(cum),
                           h_prevs)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + d_skip.float()[None, None, :, None] * x.float()
    return y[:, :s_in].to(x.dtype), hstate


def ssd_decode_step(state, x, dt, a_log, b, c, d_skip):
    """One-token recurrence.  state (B,H,N,P); x (B,H,P); dt (B,H); b,c (B,N)."""
    a = -torch.exp(a_log.float())
    dt32 = dt.float()
    decay = torch.exp(dt32 * a[None, :])                        # (B,H)
    u = dt32[..., None] * x.float()                             # (B,H,P)
    state = (state * decay[..., None, None]
             + torch.einsum("bn,bhp->bhnp", b.float(), u))
    y = torch.einsum("bn,bhnp->bhp", c.float(), state)
    y = y + d_skip.float()[None, :, None] * x.float()
    return y.to(x.dtype), state


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                cache: torch.Tensor | None = None):
    """Depthwise causal conv.  x (B,S,C), w (W,C).  If ``cache`` (B,W-1,C)
    is given, runs in streaming mode; returns (y, new_cache)."""
    width = w.shape[0]
    if cache is not None:
        ctx = torch.cat([cache, x], dim=1)                      # (B, W-1+S, C)
    else:
        ctx = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    y = sum(ctx[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    new_cache = (ctx[:, ctx.shape[1] - (width - 1):, :] if width > 1
                 else ctx[:, :0, :])
    return y.to(x.dtype), new_cache


def mamba2_mix(p: dict, x: torch.Tensor, cfg: SSMConfig, d_model: int, *,
               state=None, conv_cache=None, decode: bool = False):
    """Full Mamba2 mixer.  x (B,S,D).  Returns (y, (state, conv_cache)).

    At decode on placed parameters the caches may be split (local views):
    the conv cache's channels and the state's heads over ``model``.  The
    in-projection's columns, split where they do not line up with
    ``z | xBC | dt``, are gathered whole (B x zdim, small at decode); the
    conv runs on the cache's channels and its output is gathered; the
    recurrence runs on the state's heads, whose outputs the gated norm
    sums over the positions before the row-parallel out-projection."""
    d_inner = cfg.expand * d_model
    h = d_inner // cfg.head_dim
    n = cfg.d_state

    zxbcdt = dot(x, p["w_in"], whole=True)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, h], dim=-1)
    z = constrain(z, ("batch", None, None))
    xbc = constrain(xbc, ("batch", None, None))
    dt = F.softplus(dt.float() + gathered(p["dt_bias"]).float())

    cax = split_axes(conv_cache, -1)            # the conv cache's channels
    xbc, conv_cache = causal_conv(part(xbc, -1, cax),
                                  part(p["w_conv"], -1, cax),
                                  local(conv_cache))
    xbc = all_gather(F.silu(xbc), -1, cax, "mamba2 conv channels")
    xs, b, c = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(*xs.shape[:-1], h, cfg.head_dim)

    hax = split_axes(state, 1) if decode else ()   # the state's heads
    a_log, d_skip = (part(p[k], 0, hax) for k in ("a_log", "d_skip"))
    if decode:
        y, state = ssd_decode_step(local(state), part(xs[:, 0], 1, hax),
                                   part(dt[:, 0], 1, hax), a_log,
                                   b[:, 0], c[:, 0], d_skip)
        y = y[:, None]                                          # (B,1,H,P)
    else:
        y, state = ssd_chunked(xs, dt, a_log, b, c, d_skip, chunk=cfg.chunk)
    y = y.reshape(*y.shape[:-2], -1)
    # gated RMSNorm (mamba2's norm-before-out) over all d_inner channels
    y32 = y.float() * F.silu(part(z, -1, hax).float())
    if hax:
        var = psum((y32 * y32).sum(dim=-1, keepdim=True), hax,
                   "mamba2 gated norm") / d_inner
    else:
        var = (y32 * y32).mean(dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + 1e-5)).to(x.dtype) \
        * (1.0 + part(p["norm_w"], -1, hax).to(x.dtype))
    out = dot(y, p["w_out"])
    return out, (state, conv_cache)
