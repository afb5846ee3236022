"""Architecture assembly; counterpart of ``repro.models.transformer``: the
param specs of every family (dense, MoE, VLM, Gemma's local/global stack,
the Mamba-2 and RWKV-6 blocks, the Zamba2 hybrid's groups and shared
attention, Whisper's encoder and decoder), the block forwards
(``attn_apply`` with its caches, ``ffn_apply``, ``dense_block_apply``), the
block-sparse attention of DESIGN.md §10, and the sparse FFN as the module
``SparseFFN``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .layers import (SparsePattern, apply_mrope, apply_rope, decode_attention,
                     dot, flash_attention, mlp_apply, rmsnorm,
                     sparse_mlp_apply)
from .moe import moe_apply
from .params import ParamSpec, map_specs
from .sharding_ctx import (axes_extent, constrain, local, offset,
                           split_axes, tensor_parallel)

P = ParamSpec


# ---------------------------------------------------------------------------
# param specs
# ---------------------------------------------------------------------------

def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def attn_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    del cross
    d, hd = cfg.d_model, cfg.head_dim
    h, hk = cfg.num_heads, cfg.num_kv_heads
    return {
        "ln": P((d,), ("embed",), _dt(cfg), "zeros"),
        "wq": P((d, h * hd), ("embed", "heads"), _dt(cfg)),
        "wk": P((d, hk * hd), ("embed", "heads"), _dt(cfg)),
        "wv": P((d, hk * hd), ("embed", "heads"), _dt(cfg)),
        "wo": P((h * hd, d), ("heads", "embed"), _dt(cfg)),
    }


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.sparse_ffn is not None:
        sp = cfg.sparse_ffn
        tiles = lambda m, k: -(-max(int(m * k * sp.density), 1) // sp.tile)
        return {
            "ln": P((d,), ("embed",), _dt(cfg), "zeros"),
            "v_gate": P((tiles(f, d), sp.tile), ("tiles", "nnz"), _dt(cfg), scale=0.02),
            "v_up": P((tiles(f, d), sp.tile), ("tiles", "nnz"), _dt(cfg), scale=0.02),
            "v_down": P((tiles(d, f), sp.tile), ("tiles", "nnz"), _dt(cfg), scale=0.02),
        }
    s = {
        "ln": P((d,), ("embed",), _dt(cfg), "zeros"),
        "w_up": P((d, f), ("embed", "ff"), _dt(cfg)),
        "w_down": P((f, d), ("ff", "embed"), _dt(cfg)),
    }
    if cfg.act == "swiglu":
        s["w_gate"] = P((d, f), ("embed", "ff"), _dt(cfg))
    return s


def moe_specs(cfg: ModelConfig) -> dict:
    d, m = cfg.d_model, cfg.moe
    return {
        "ln": P((d,), ("embed",), _dt(cfg), "zeros"),
        "w_router": P((d, m.num_experts), ("embed", None), torch.float32, scale=0.02),
        "w_gate": P((m.num_experts, d, m.d_ff_expert), ("experts", "embed", "ff"), _dt(cfg)),
        "w_up": P((m.num_experts, d, m.d_ff_expert), ("experts", "embed", "ff"), _dt(cfg)),
        "w_down": P((m.num_experts, m.d_ff_expert, d), ("experts", "ff", "embed"), _dt(cfg)),
    }


def mamba_specs(cfg: ModelConfig) -> dict:
    d, s = cfg.d_model, cfg.ssm
    di = s.expand * d
    n = s.d_state
    h = di // s.head_dim
    zdim = 2 * di + 2 * n + h
    return {
        "ln": P((d,), ("embed",), _dt(cfg), "zeros"),
        "w_in": P((d, zdim), ("embed", "ssm_in"), _dt(cfg)),
        "w_conv": P((s.conv_width, di + 2 * n), (None, "ssm_in"), _dt(cfg), scale=0.5),
        "dt_bias": P((h,), (None,), torch.float32, "zeros"),
        "a_log": P((h,), (None,), torch.float32, "zeros"),
        "d_skip": P((h,), (None,), torch.float32, "ones"),
        "norm_w": P((di,), ("ssm_in",), _dt(cfg), "zeros"),
        "w_out": P((di, d), ("ssm_in", "embed"), _dt(cfg)),
    }


def rwkv_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    r = 64  # decay-LoRA rank
    mus = {f"mu_{k}": P((d,), ("embed",), _dt(cfg), "zeros") for k in "rkvwg"}
    return {
        "ln1": P((d,), ("embed",), _dt(cfg), "zeros"),
        **mus,
        "w_r": P((d, d), ("embed", "heads"), _dt(cfg)),
        "w_k": P((d, d), ("embed", "heads"), _dt(cfg)),
        "w_v": P((d, d), ("embed", "heads"), _dt(cfg)),
        "w_g": P((d, d), ("embed", "heads"), _dt(cfg)),
        "w_decay_a": P((d, r), ("embed", None), _dt(cfg), scale=0.02),
        "w_decay_b": P((r, d), (None, "heads"), _dt(cfg), scale=0.02),
        "w0": P((d,), ("heads",), torch.float32, "zeros"),
        "u_bonus": P((d,), ("heads",), torch.float32, "zeros"),
        "ln_w": P((d,), ("heads",), torch.float32, "ones"),
        "ln_b": P((d,), ("heads",), torch.float32, "zeros"),
        "w_o": P((d, d), ("heads", "embed"), _dt(cfg)),
        "ln2": P((d,), ("embed",), _dt(cfg), "zeros"),
        "mu_ck": P((d,), ("embed",), _dt(cfg), "zeros"),
        "mu_cr": P((d,), ("embed",), _dt(cfg), "zeros"),
        "w_ck": P((d, f), ("embed", "ff"), _dt(cfg)),
        "w_cv": P((f, d), ("ff", "embed"), _dt(cfg)),
        "w_cr": P((d, d), ("embed", None), _dt(cfg)),
    }


def block_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    """One decoder block for the family."""
    if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        return rwkv_specs(cfg)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm and cfg.ssm.kind == "mamba2":
        return mamba_specs(cfg)
    s = {"attn": attn_specs(cfg)}
    if cross:
        s["xattn"] = attn_specs(cfg, cross=True)
    s["ffn"] = moe_specs(cfg) if cfg.moe else mlp_specs(cfg)
    return s


def _stack(specs: dict, n: int, axis_name: str) -> dict:
    return map_specs(lambda p: P((n,) + p.shape, (axis_name,) + p.logical,
                                 p.dtype, p.init, p.scale), specs)


def model_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs: dict = {
        "embed": P((v, d), ("vocab", "embed"), _dt(cfg), scale=0.02),
        "final_ln": P((d,), ("embed",), _dt(cfg), "zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P((d, v), ("embed", "vocab"), _dt(cfg), scale=0.02)
    if cfg.family == "audio":  # whisper enc-dec
        specs["enc_blocks"] = _stack(
            {"attn": attn_specs(cfg), "ffn": mlp_specs(cfg)},
            cfg.encoder_layers, "layers")
        specs["enc_final_ln"] = P((d,), ("embed",), _dt(cfg), "zeros")
        specs["dec_blocks"] = _stack(block_specs(cfg, cross=True),
                                     cfg.num_layers, "layers")
        return specs
    if cfg.attn_pattern == "local_global":  # gemma3 grouped
        inner = cfg.local_per_global + 1
        groups = cfg.num_layers // inner
        specs["blocks"] = _stack(_stack(block_specs(cfg), inner, "inner"),
                                 groups, "groups")
        return specs
    if cfg.family == "hybrid":  # zamba2: shared_every mamba + shared attn
        groups = cfg.num_layers // cfg.shared_every
        specs["blocks"] = _stack(_stack(mamba_specs(cfg), cfg.shared_every,
                                        "inner"), groups, "groups")
        specs["shared_attn"] = {"attn": attn_specs(cfg), "ffn": mlp_specs(cfg)}
        return specs
    specs["blocks"] = _stack(block_specs(cfg), cfg.num_layers, "layers")
    return specs


#: the sparse FFN's matrices: (pattern name, value parameter, W is (d_ff,
#: d_model) or (d_model, d_ff))
_SPARSE_FFN = (("gate", "v_gate", "ff"), ("up", "v_up", "ff"),
               ("down", "v_down", "model"))


def _pattern_shape(cfg: ModelConfig, out: str) -> tuple[int, int]:
    d, f = cfg.d_model, cfg.d_ff
    return (f, d) if out == "ff" else (d, f)


def sparse_patterns(cfg: ModelConfig, seed: int = 17, device=None):
    """Static pruning patterns of the sparse FFN, one set a layer: ``{"gate":
    [...], "up": [...], "down": [...]}`` with ``cfg.num_layers`` patterns
    each, drawn from integer seeds that ``numpy.random.default_rng(seed)``
    gives (the reference splits a JAX key).  None without ``sparse_ffn``."""
    if cfg.sparse_ffn is None:
        return None
    sp = cfg.sparse_ffn
    seeds = np.random.default_rng(seed).integers(0, 2**31 - 1,
                                                 size=3 * cfg.num_layers)
    pats = {name: [] for name, _, _ in _SPARSE_FFN}
    for i in range(cfg.num_layers):
        for j, (name, _, out) in enumerate(_SPARSE_FFN):
            m, k = _pattern_shape(cfg, out)
            pats[name].append(SparsePattern.random(
                int(seeds[3 * i + j]), m, k, sp.density, sp.tile, device))
    return pats


class SparseFFN(torch.nn.Module):
    """One sparse-FFN layer, ``mlp_specs``' sparse branch: parameters ``ln``
    (d_model, zeros) and the value streams ``v_gate`` / ``v_up`` /
    ``v_down`` (n_tiles, tile), N(0, 0.02²) from ``seed``; the frozen
    patterns as buffers (``<name>_rows`` / ``<name>_cols``).  ``patterns``
    defaults to ``sparse_patterns(cfg, seed)``'s first layer; ``dtype``
    to ``cfg.param_dtype``; ``device=None`` is the card."""

    def __init__(self, cfg: ModelConfig, *, patterns: dict | None = None,
                 seed: int = 17, dtype=None, device=None):
        super().__init__()
        if cfg.sparse_ffn is None:
            raise ValueError("SparseFFN needs a config with sparse_ffn")
        self.cfg = cfg
        if patterns is None:
            patterns = {k: v[0] for k, v in sparse_patterns(
                cfg.scaled(num_layers=1), seed, device).items()}
        dtype = dtype or getattr(torch, cfg.param_dtype)
        dev = patterns["gate"].rows.device
        gen = torch.Generator().manual_seed(seed)
        self.ln = torch.nn.Parameter(torch.zeros(cfg.d_model, dtype=dtype,
                                                 device=dev))
        self._shapes = {}
        for name, vname, out in _SPARSE_FFN:
            pat = patterns[name]
            if pat.shape != _pattern_shape(cfg, out):
                raise ValueError(f"pattern {name!r} of shape {pat.shape}; "
                                 f"expected {_pattern_shape(cfg, out)}")
            self.register_buffer(f"{name}_rows", pat.rows)
            self.register_buffer(f"{name}_cols", pat.cols)
            v = torch.randn(pat.rows.shape, generator=gen) * 0.02
            setattr(self, vname, torch.nn.Parameter(v.to(dev, dtype)))
            self._shapes[name] = pat.shape

    @property
    def patterns(self) -> dict:
        """The ``SparsePattern`` of each matrix over the current buffers
        (their prep is memoised on the buffers, so it is rebuilt only after
        they move)."""
        return {name: SparsePattern(getattr(self, f"{name}_rows"),
                                    getattr(self, f"{name}_cols"), shape)
                for name, shape in self._shapes.items()}

    def params(self) -> dict:
        """The parameters as the dict ``ffn_apply`` and the train step take."""
        return dict(self.named_parameters())

    def forward(self, x: torch.Tensor, params: dict | None = None
                ) -> torch.Tensor:
        """``x + mlp(rmsnorm(x))`` with this module's parameters, or with
        ``params`` (the functional form a train step differentiates)."""
        return ffn_apply(self.params() if params is None else params, x,
                         self.cfg, self.patterns)[0]


def _block_sparse_spec(cfg: ModelConfig, seq: int, causal: bool):
    """The attention mask spec a block_sparse config implies at this
    sequence length: token window → block band (BigBird when global/random
    blocks are configured), dense-fallback blocks when no window is set.
    Specs are frozen and hashable, so every layer/head/call at one seq
    shares a single PlanCache entry."""
    from ..attention import bigbird, dense_attention, sliding_window
    block = cfg.attn_block or 64
    if cfg.window > 0:
        wb = -(-cfg.window // block)  # token window, ceil to blocks
        if cfg.attn_global_blocks or cfg.attn_random_blocks:
            return bigbird(seq, wb, cfg.attn_global_blocks,
                           cfg.attn_random_blocks, block=block, causal=causal)
        return sliding_window(seq, wb, block=block, causal=causal)
    return dense_attention(seq, block=block, causal=causal)


def _block_sparse_attention(qt, kt, vt, cfg: ModelConfig, causal: bool):
    """Train/prefill attention through the sparse-softmax chain (DESIGN.md
    §10).  qt (B, H, S, hd), kt/vt (B, Hk, S, hd) → (B, H, S, hd); GQA
    repeats each KV head in place (``jnp.repeat(..., axis=1)`` in the
    reference, so ``repeat_interleave`` here), and the spec's plan is built
    once and shared across the whole (B, H) fan-out."""
    from ..attention import sparse_attention
    b, h, s, hd = qt.shape
    hk = kt.shape[1]
    if h != hk:
        rep = h // hk
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    spec = _block_sparse_spec(cfg, s, causal)
    out = sparse_attention(spec, qt.to(torch.float32), kt.to(torch.float32),
                           vt.to(torch.float32))
    return out.to(qt.dtype)


# ---------------------------------------------------------------------------
# block forwards
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _write_decode(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
                  lmax: int | None = None, first: int = 0) -> torch.Tensor:
    """A copy of ``cache`` (B, Hk, L, hd) with ``new`` (B, Hk, 1, hd)
    written at slot ``idx``: a 0-d index for every lane, or a (B,) index a
    lane.  The slot is clamped into ``[0, lmax)``, as
    ``dynamic_update_slice`` clamps its start; no host sync.  A shard of a
    sequence-split cache (``lmax`` slots in all, this one holding slots
    ``first …``) writes the lanes whose slot it holds."""
    lmax = cache.shape[2] if lmax is None else lmax
    idx = idx.clamp(0, lmax - 1).long()
    new = new.to(cache.dtype)
    if cache.shape[2] < lmax:
        slots = first + torch.arange(cache.shape[2], device=cache.device)
        hit = slots[None, :] == idx.reshape(-1, 1)             # (1|B, L)
        return torch.where(hit[:, None, :, None], new, cache)
    if idx.ndim == 0:
        return cache.index_copy(2, idx.reshape(1), new)
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), :, idx] = new[:, :, 0]
    return out


def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions,
               cache=None, window: int = 0, causal: bool = True,
               memory=None, rope: bool = True):
    """Self- or cross-attention with optional KV cache.

    cache: dict(k, v, length) with k/v (B, Hk, L, hd) and ``length`` a 0-d
    or (B,) int tensor; returns the updated cache (new tensors: the given
    ones are not written).  Decode (one token) writes at ``length`` (at
    ``length % L`` on a window cache, a rolling write) and attends to the
    valid entries; prefill writes the last ``min(S, L)`` keys rolled so
    that position p sits at slot ``p % L``.  memory: (B, Sm, D) for
    cross-attention (keys/values from memory, no cache).

    Decode on placed parameters (tensor-parallel ``dot``): a
    cross-attention whose heads split whole over the positions runs on the
    position's heads; every other attention gathers q, k and v for all
    heads, and a cache whose sequence is split (local views of k / v) is
    written by the shard holding the slot and attended with the split-KV
    merge (``decode_attention``).  ``wo`` is row-parallel either way."""
    b, s, _ = x.shape
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    whole = memory is None or not _heads_split(p, hk)
    q = dot(xn, p["wq"], whole)
    kv_src = memory if memory is not None else xn
    k, v = dot(kv_src, p["wk"], whole), dot(kv_src, p["wv"], whole)
    q = _split_heads(q, q.shape[-1] // hd, hd)
    k = _split_heads(k, k.shape[-1] // hd, hd)
    v = _split_heads(v, v.shape[-1] // hd, hd)

    if rope and memory is None:
        if cfg.mrope_sections:
            pos3 = positions[..., None].expand(positions.shape + (3,))
            q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)

    if memory is not None:
        # cross-attention: no cache, full (non-causal) memory attention
        if s == 1:
            out = decode_attention(qt, kt, vt, length=kt.shape[2])
        else:
            out = flash_attention(qt, kt, vt, causal=False)
    elif cache is not None:
        lmax = cache["k"].shape[2]                 # every shard's slots
        length = cache["length"]
        if s == 1:  # decode: rolling write for window caches
            idx = length % lmax if window > 0 else length
            seq, first = split_axes(cache["k"], 2), offset(cache["k"], 2)
            newk = _write_decode(local(cache["k"]), kt, idx, lmax, first)
            newv = _write_decode(local(cache["v"]), vt, idx, lmax, first)
            length = length + 1
            valid = torch.clamp(length, max=lmax) if window > 0 else length
            out = decode_attention(qt, newk, newv, length=valid, window=0,
                                   offset=first, seq_axes=seq)
            cache = dict(k=newk, v=newv, length=length)
        else:       # prefill: write the (rolled) suffix; slot of pos p = p % lmax
            keep = min(s, lmax)
            tail_k, tail_v = kt[:, :, s - keep:], vt[:, :, s - keep:]
            shift = (s - keep) % lmax
            if shift:
                tail_k = torch.roll(tail_k, shift, dims=2)
                tail_v = torch.roll(tail_v, shift, dims=2)
            newk, newv = cache["k"].clone(), cache["v"].clone()
            newk[:, :, :keep] = tail_k
            newv[:, :, :keep] = tail_v
            cache = dict(k=newk, v=newv, length=length + s)
            if cfg.attn_pattern == "block_sparse":
                out = _block_sparse_attention(qt, kt, vt, cfg, causal)
            else:
                out = flash_attention(qt, kt, vt, causal=causal, window=window)
    elif cfg.attn_pattern == "block_sparse":
        out = _block_sparse_attention(qt, kt, vt, cfg, causal)
    else:
        out = flash_attention(qt, kt, vt, causal=causal, window=window)

    out = out.transpose(1, 2).reshape(b, s, -1)
    return x + dot(out, p["wo"]), cache


def _heads_split(p: dict, hk: int) -> bool:
    """``wq``, ``wk`` and ``wv`` are tensor-parallel, their output features
    split alike over positions that each hold whole heads of both q and
    k / v (the KV heads divide by the positions, so a position's q heads
    read its own KV heads)."""
    if not tensor_parallel(p["wq"]):
        return False
    axes = split_axes(p["wq"], -1)
    return bool(axes) and all(split_axes(p[n], -1) == axes
                              for n in ("wk", "wv")) \
        and hk % axes_extent(axes) == 0

def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, patterns=None):
    """The FFN block with its residual: ``(x + ffn(rmsnorm(x)), aux)`` —
    the MoE (``aux`` its load-balancing loss), the sparse FFN
    (``cfg.sparse_ffn`` with ``patterns``) or the dense MLP."""
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    if cfg.moe is not None and "w_router" in p:
        y, aux = moe_apply(p, xn, cfg.moe)
        return x + y, aux
    if cfg.sparse_ffn is not None and patterns is not None:
        return x + sparse_mlp_apply(patterns, p, xn, cfg.act), 0.0
    return x + mlp_apply(p, xn, cfg.act), 0.0


def dense_block_apply(p: dict, x, cfg, *, positions, cache=None, window=0,
                      causal=True, patterns=None):
    x = constrain(x, ("batch", None, None))
    x, cache = attn_apply(p["attn"], x, cfg, positions=positions,
                          cache=cache, window=window, causal=causal)
    x = constrain(x, ("batch", None, None))
    x, aux = ffn_apply(p["ffn"], x, cfg, patterns=patterns)
    return x, cache, aux
