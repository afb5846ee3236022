"""Shared layers; counterpart of ``repro.models.layers``: ``rmsnorm``,
``dot``, the rotary embeddings (standard and Qwen2-VL's M-RoPE), attention
(``flash_attention`` for train/prefill, ``decode_attention`` against a
cache), the dense MLP and the sparse FFN — the paper as a feature: FFN
weights pruned to a fixed pattern, stored as a balanced value stream and
executed through the SpMM (``pattern_matmul``), differentiable in the values
and the input.

Attention here is plain PyTorch, as the reference's is plain JAX (no Pallas
kernel): scores in f32, masked entries at −1e30 (not −inf), so a row with
every key masked averages V instead of giving NaN.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.plan import execute_pattern
from ..core.registry import resolve_device
from . import spmd
from .sharding_ctx import (constrain, constrain_gemm, gathered, pmax, psum,
                           sparse_shard, tensor_parallel)

#: the score of a masked (query, key) pair, the reference's
MASKED = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x / rms(x) * (1 + w)``, the norm taken in f32 and cast back to
    ``x.dtype`` before the scale, as the reference does.  A placed weight's
    local view is gathered first."""
    w = gathered(w)
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + w.to(x.dtype))


def dot(a: torch.Tensor, b: torch.Tensor, whole: bool = False
        ) -> torch.Tensor:
    """``a @ b`` (``(..., i, j) x (j, k)``) in ``a.dtype``: a bf16 product
    accumulates in f32 and rounds once, as the reference's
    ``preferred_element_type=f32`` product cast back.  Weight-gathered in
    train and prefill cells (``constrain_gemm``, reference ``:35-41``).
    Tensor-parallel at decode on placed parameters (``spmd.tp_dot``): a
    weight split along ``k`` gives the position's slice of the output
    features (all of them with ``whole``), one split along ``j`` takes
    ``a``'s slice and all-reduces the partial outputs."""
    if tensor_parallel(b):
        return spmd.tp_dot(a, b, whole)
    b = constrain_gemm(w=b)
    out = torch.matmul(a, b.to(a.dtype))
    return constrain_gemm(out=out)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def _freqs(half: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    freqs = _freqs(head_dim // 2, theta, positions.device)
    ang = positions[..., None].float() * freqs                # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Half-rotation (llama)
    convention."""
    cos, sin = _rope_cos_sin(positions, x.shape[-1], theta)   # (B, S, half)
    return _rotate(x, cos, sin)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: tuple,
                theta: float) -> torch.Tensor:
    """Qwen2-VL M-RoPE.  positions3: (B, S, 3) = (t, h, w) ids; ``sections``
    split head_dim//2 among the three.  For text, t == h == w == position."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = _freqs(half, theta, x.device)
    # per-frequency section id → which of (t, h, w) drives it (the output
    # size given, so that a meta tensor traces too)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device), output_size=half)
    pos = positions3.float()[..., sec_id]                     # (B, S, half)
    ang = pos * freqs
    return _rotate(x, torch.cos(ang), torch.sin(ang))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int | torch.Tensor = 0,
                    q_block: int = 512, kv_block: int = 1024) -> torch.Tensor:
    """q: (B, Hq, Sq, D), k/v: (B, Hk, Sk, D) with Hq % Hk == 0 (GQA by
    grouping: query head ``j·rep + r`` reads KV head ``j``).

    One softmax a ``q_block`` of queries over all keys, O(q_block · Sk)
    live memory; the reference's online softmax over ``kv_block`` blocks
    computes the same.  The keys are padded to a multiple of ``kv_block``
    as there, so a query whose every key is masked averages V over the
    padded length, as the reference's does.  ``window > 0`` adds
    sliding-window masking (local layers); ``q_offset`` is the absolute
    position of q[0] (prefill continuation / decode)."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    rep = hq // hk
    scale = 1.0 / math.sqrt(d)
    # pinned to pure batch sharding, as the reference (``:106-111``)
    q = constrain(q, ("batch", None, None, None))
    k = constrain(k, ("batch", None, None, None))
    v = constrain(v, ("batch", None, None, None))
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    sk_p = -(-sk // kv_block) * kv_block
    kf = F.pad(k.float(), (0, 0, 0, sk_p - sk))
    vf = F.pad(v.float(), (0, 0, 0, sk_p - sk))
    k_pos = torch.arange(sk_p, device=q.device)
    outs = []
    for q0 in range(0, sq, q_block):
        qb = q[:, :, q0:q0 + q_block]
        nq = qb.shape[2]
        qg = qb.reshape(b, hk, rep, nq, d).float() * scale
        q_pos = q_offset + q0 + torch.arange(nq, device=q.device)
        s = torch.einsum("bhrqd,bhkd->bhrqk", qg, kf)
        mask = (k_pos < sk)[None, :].expand(nq, sk_p)         # kv padding
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, MASKED)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhrqk,bhkd->bhrqd", p, vf)
                    .reshape(b, hq, nq, d))
    return torch.cat(outs, dim=2).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, length, window: int = 0,
                     offset: int = 0, seq_axes: tuple = ()) -> torch.Tensor:
    """Single-token attention against a cache.  q: (B, Hq, 1, D),
    k/v_cache: (B, Hk, L, D); ``length`` = #valid cache entries (the new
    token is already written at length-1): an int, a 0-d tensor (all lanes
    in lockstep) or a (B,) tensor (each lane its own).

    A cache whose sequence is split over ``seq_axes`` (decode on placed
    parameters) is this position's slots ``offset …``, masked by their
    numbers in the whole cache: the shards' softmax statistics are merged
    over the axes (the split-KV merge: the max by ``pmax``, the sum and
    the weighted values by ``psum``).  A row with every key masked
    averages V over the whole cache, as unsplit."""
    b, hq, _, d = q.shape
    hk, lmax = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hk
    q = constrain(q, ("batch", None, None, None))
    qg = q.reshape(b, hk, rep, d).float() / math.sqrt(d)
    s = torch.einsum("bhrd,bhld->bhrl", qg, k_cache.float())
    pos = offset + torch.arange(lmax, device=q.device)
    length = torch.as_tensor(length, device=q.device)
    lens = length.reshape(-1, 1)                               # (1|B, 1)
    mask = pos[None, :] < lens
    if window > 0:
        mask = mask & (pos[None, :] >= lens - window)
    s = torch.where(mask[:, None, None, :], s, MASKED)
    if not seq_axes:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhrl,bhld->bhrd", p, v_cache.float())
        return out.reshape(b, hq, 1, d).to(q.dtype)
    m = pmax(s.amax(dim=-1, keepdim=True), seq_axes, "decode attention max")
    p = torch.exp(s - m)
    total = psum(p.sum(dim=-1, keepdim=True), seq_axes,
                 "decode attention sum")
    out = psum(torch.einsum("bhrl,bhld->bhrd", p, v_cache.float()), seq_axes,
               "decode attention values")
    return (out / total).reshape(b, hq, 1, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs — dense and sparse (the paper's feature)
# ---------------------------------------------------------------------------

def mlp_apply(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(dot(x, p["w_gate"])) * dot(x, p["w_up"])
    else:
        h = F.gelu(dot(x, p["w_up"]), approximate="tanh")
    return dot(h, p["w_down"])


@dataclasses.dataclass(frozen=True, eq=False)
class SparsePattern:
    """Frozen (non-trainable) sparsity pattern of one pruned weight matrix W
    (m, k) in the balanced layout: ``rows`` / ``cols`` ``(n_tiles, tile)``
    int32, row-major, the tail padded with ``rows == m``.  Its per-pattern
    prep (Wᵀ's slabs for the backward) is ``execute_pattern``'s, memoised on
    the ``rows`` tensor: built once while the pattern lives."""

    rows: torch.Tensor
    cols: torch.Tensor
    shape: tuple

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @staticmethod
    def random(seed: int, m: int, k: int, density: float, tile: int,
               device=None) -> "SparsePattern":
        """``max(m·k·density, 1)`` distinct positions drawn by
        ``numpy.random.default_rng(seed)`` — the reference's draw from the
        integer its key gives — sorted row-major and tiled.  ``device=None``
        is the card."""
        nnz = max(int(m * k * density), 1)
        rng = np.random.default_rng(int(seed))
        flat = rng.choice(m * k, size=nnz, replace=False)
        flat.sort()
        rows, cols = (flat // k).astype(np.int32), (flat % k).astype(np.int32)
        return SparsePattern.from_arrays(rows, cols, (m, k), tile, device)

    @staticmethod
    def from_arrays(rows, cols, shape, tile: int | None = None,
                    device=None) -> "SparsePattern":
        """A pattern from numpy ``rows`` / ``cols``: flat ones are tiled at
        ``tile`` (tail padded with ``rows == m``), ``(n_tiles, tile)`` slabs
        taken as they are.  ``device=None`` is the card."""
        rows, cols = np.array(rows, np.int32), np.array(cols, np.int32)
        if rows.ndim == 1:
            n_tiles = -(-len(rows) // tile)
            pad = n_tiles * tile - len(rows)
            rows = np.concatenate([rows, np.full(pad, shape[0], np.int32)])
            cols = np.concatenate([cols, np.zeros(pad, np.int32)])
            rows, cols = rows.reshape(n_tiles, tile), cols.reshape(n_tiles, tile)
        dev = resolve_device(device)
        return SparsePattern(torch.from_numpy(rows).to(dev),
                             torch.from_numpy(cols).to(dev), tuple(shape))

    @property
    def n_tiles(self) -> int:
        return int(self.rows.shape[0])

    def to_dense(self, vals: torch.Tensor) -> torch.Tensor:
        """W (m, k) with ``vals`` (one a slot) at the pattern's positions."""
        m, k = self.shape
        r, v = self.rows.reshape(-1), vals.reshape(-1)
        keep = r < m
        w = torch.zeros((m, k), dtype=vals.dtype, device=vals.device)
        return w.index_put((r[keep].long(), self.cols.reshape(-1)[keep].long()),
                           v[keep], accumulate=True)


def sparse_matmul(pattern: SparsePattern, vals, x: torch.Tensor, *,
                  mesh=None, shard_axis: str | None = None) -> torch.Tensor:
    """``x @ Wᵀ`` with W (m, k) sparse, as the SpMM ``W · xᵀ`` through
    ``pattern_matmul``: differentiable in ``vals`` and ``x``.  ``x`` is
    ``(..., k)``; the result ``(..., m)`` in ``x.dtype``.  With a ``mesh``
    (given, or installed by ``sharding_ctx.activation_sharding`` with the
    ``__sparse_shard_axis__`` marker) the SpMM runs on the sharded backend:
    the pattern's tiles split over the axis, the partials psum.  In a
    position's program ``vals`` is a placed leaf's local view: the pieces
    of the stream are the shards (``spmd.sparse_matmul``)."""
    flat = x.reshape(-1, x.shape[-1])                          # (T, k)
    if not isinstance(vals, torch.Tensor):
        y = spmd.sparse_matmul(pattern.rows, pattern.cols, pattern.shape,
                               vals, flat.T)
    else:
        if mesh is None:
            mesh, shard_axis = sparse_shard()
        y = execute_pattern(pattern.rows, pattern.cols, vals, pattern.shape,
                            flat.T, mesh=mesh, shard_axis=shard_axis)
    return y.T.reshape(x.shape[:-1] + (pattern.shape[0],)).to(x.dtype)


def sparse_mlp_apply(patterns: dict, p: dict, x: torch.Tensor,
                     act: str = "swiglu") -> torch.Tensor:
    """FFN with pruned weight matrices executed through the paper's SpMM:
    ``patterns`` and ``p`` keyed ``gate`` / ``up`` / ``down`` and
    ``v_gate`` / ``v_up`` / ``v_down``."""
    if act == "swiglu":
        h = (torch.nn.functional.silu(sparse_matmul(patterns["gate"],
                                                    p["v_gate"], x))
             * sparse_matmul(patterns["up"], p["v_up"], x))
    else:
        h = torch.nn.functional.gelu(
            sparse_matmul(patterns["up"], p["v_up"], x), approximate="tanh")
    return sparse_matmul(patterns["down"], p["v_down"], h)
