"""Transformer blocks; counterpart of ``repro.models.transformer``.  Ported
so far: the block-sparse attention of the ``block_sparse`` pattern
(DESIGN.md §10), ``_block_sparse_spec`` and ``_block_sparse_attention``; and
the sparse FFN — ``mlp_specs``' sparse branch as the module ``SparseFFN``,
``sparse_patterns`` and the sparse branch of ``ffn_apply``."""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .layers import SparsePattern, rmsnorm, sparse_mlp_apply

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


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, patterns=None):
    """The FFN block with its residual: ``(x + mlp(rmsnorm(x)), aux)``.
    Ported: the sparse branch (``cfg.sparse_ffn`` with ``patterns``)."""
    if cfg.sparse_ffn is None or patterns is None or cfg.moe is not None:
        raise NotImplementedError("ffn_apply: only the sparse FFN branch is "
                                  "ported; the dense and MoE FFNs are not")
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + sparse_mlp_apply(patterns, p, xn, cfg.act), 0.0


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
