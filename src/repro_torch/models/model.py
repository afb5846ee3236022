"""Model: turns a ModelConfig into train/prefill/decode functions;
counterpart of ``repro.models.model`` for the attention families (dense,
MoE, VLM, Gemma's local/global stack, ``block_sparse`` and the sparse FFN).

All functions are pure (params and caches in, values out; a cache given is
not written).  The reference's ``lax.scan`` over the stacked leading axis is
a Python loop here; its ``_remat`` is ``torch.utils.checkpoint`` around each
block when ``cfg.remat != "none"`` and autograd records.  Cache layout:

  dense/moe/vlm  {"kv": {k,v: (L, B, Hk, Lmax, hd)}, length}
  gemma3         {"local": {k,v: (G, inner-1, B, Hk, min(window, Lmax), hd)},
                  "global": {k,v: (G, 1, B, Hk, Lmax, hd)}, length}

``length`` is a 0-d int32 tensor, or (B,) for lanes at their own positions.
The SSM, hybrid and audio backbones are not ported yet.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..core import registry
from .config import ModelConfig
from .layers import rmsnorm
from .model_loss import lm_loss
from .params import init_params
from .transformer import (NOT_PORTED, dense_block_apply, model_specs,
                          sparse_patterns)


def _tree_idx(tree, *i):
    """The leaves of a nested dict indexed at ``i`` along their leading
    axes."""
    if isinstance(tree, dict):
        return {k: _tree_idx(v, *i) for k, v in tree.items()}
    return tree[i]


def _stack_caches(caches: list, shape: tuple) -> dict:
    """Per-layer ``{k, v}`` caches stacked back to ``shape + (B, Hk, L, hd)``."""
    return {name: torch.stack([c[name] for c in caches]).reshape(
        shape + caches[0][name].shape) for name in ("k", "v")}


class Model:
    """The model of ``cfg``.  ``patterns``: the sparse FFN's per-layer
    patterns (``{"gate" | "up" | "down": [SparsePattern, ...]}``, one a
    layer), by default ``sparse_patterns(cfg)`` on the device of the first
    call's activations."""

    def __init__(self, cfg: ModelConfig, patterns: dict | None = None):
        self.cfg = cfg
        self.specs = model_specs(cfg)
        self.patterns = patterns

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator | None = None, device=None):
        """The parameter tree from ``generator`` (``init_params``); the
        device is ``device``, else the generator's, else the card."""
        return init_params(self.specs, generator, device)

    def _patterns_on(self, device):
        if self.cfg.sparse_ffn is None:
            return None
        if self.patterns is None:
            self.patterns = sparse_patterns(self.cfg, device=device)
        return self.patterns

    # ------------------------------------------------------------- embedding
    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.attn_pattern == "local_global":        # gemma convention
            x = x * float(torch.tensor(math.sqrt(self.cfg.d_model),
                                       dtype=x.dtype))
        return x.to(getattr(torch, self.cfg.compute_dtype))

    def _unembed_w(self, params):
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    # ------------------------------------------------------------- backbones
    def _block(self, p, x, positions, cache=None, window=0, patterns=None):
        """One decoder block, checkpointed when training with remat."""
        cfg = self.cfg
        if cache is None and cfg.remat != "none" and torch.is_grad_enabled():
            # the recompute runs in the backward, on autograd's thread for
            # CUDA tensors: it re-enters the forward's backend scope
            scoped = registry.scoped_backend()

            def run(p_, x_):
                with registry.backend_scope(scoped):
                    y, _, a = dense_block_apply(p_, x_, cfg,
                                                positions=positions,
                                                window=window,
                                                patterns=patterns)
                return y, torch.as_tensor(a, dtype=torch.float32,
                                          device=y.device)
            y, a = checkpoint(run, p, x, use_reentrant=False)
            return y, None, a
        return dense_block_apply(p, x, cfg, positions=positions, cache=cache,
                                 window=window, patterns=patterns)

    def _backbone_uniform(self, params, x, positions, caches=None):
        """dense/moe/vlm stack: one block a layer; the sparse FFN's
        patterns a layer where the config has them."""
        pats = self._patterns_on(x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_kv = []
        for i in range(self.cfg.num_layers):
            cache = None
            if caches is not None:
                cache = dict(_tree_idx(caches["kv"], i),
                             length=caches["length"])
            patd = None if pats is None else {k: v[i] for k, v in pats.items()}
            x, cache, a = self._block(_tree_idx(params["blocks"], i), x,
                                      positions, cache, patterns=patd)
            aux = aux + a
            if cache is not None:
                new_kv.append(cache)
        if caches is None:
            return x, None, aux
        return x, dict(caches, kv=_stack_caches(new_kv, (len(new_kv),)),
                       length=caches["length"] + x.shape[1]), aux

    def _backbone_gemma(self, params, x, positions, caches=None):
        """Gemma-3's groups of ``local_per_global`` sliding-window layers
        and one global layer; local caches hold ``min(window, max_len)``
        entries, written rolling."""
        cfg = self.cfg
        inner = cfg.local_per_global + 1
        groups = cfg.num_layers // inner
        new_lc, new_gc = [], []
        for g in range(groups):
            for i in range(inner):
                is_global = i == inner - 1
                cache = None
                if caches is not None:
                    src = (_tree_idx(caches["global"], g, 0) if is_global
                           else _tree_idx(caches["local"], g, i))
                    cache = dict(src, length=caches["length"])
                x, cache, _ = self._block(
                    _tree_idx(params["blocks"], g, i), x, positions, cache,
                    window=0 if is_global else cfg.window)
                if cache is not None:
                    (new_gc if is_global else new_lc).append(cache)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if caches is None:
            return x, None, zero
        new = dict(caches, local=_stack_caches(new_lc, (groups, inner - 1)),
                   length=caches["length"] + x.shape[1])
        new["global"] = _stack_caches(new_gc, (groups, 1))
        return x, new, zero

    def _backbone(self, params, x, positions, caches=None):
        cfg = self.cfg
        if cfg.family in ("audio", "hybrid", "ssm"):
            raise NotImplementedError(f"{cfg.family} backbone: {NOT_PORTED}")
        if cfg.attn_pattern == "local_global":
            return self._backbone_gemma(params, x, positions, caches)
        return self._backbone_uniform(params, x, positions, caches)

    # ------------------------------------------------------------ public fns
    def loss_fn(self, params, batch):
        """batch: tokens (B, S), labels (B, S) [-1 = pad] → (loss,
        {"ce_loss", "aux_loss", "tokens"})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[
            None].expand(tokens.shape)
        h, _, aux = self._backbone(params, x, positions)
        h = rmsnorm(h, params["final_ln"], cfg.norm_eps)
        loss, ntok = lm_loss(h, self._unembed_w(params), batch["labels"])
        aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
        total = loss + aux_w * aux / max(cfg.num_layers, 1)
        return total, {"ce_loss": loss, "aux_loss": aux, "tokens": ntok}

    def _logits(self, params, h):
        h = rmsnorm(h, params["final_ln"], self.cfg.norm_eps)
        return (h.float() @ self._unembed_w(params).float())[:, 0]

    def prefill(self, params, batch, max_len: int):
        """tokens (B, S) → (last-position logits (B, V), caches of
        ``max_len``)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        caches = self.init_cache(b, max_len, device=tokens.device)
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        h, caches, _ = self._backbone(params, x, positions, caches=caches)
        return self._logits(params, h[:, -1:]), caches

    def decode_step(self, params, caches, tokens):
        """tokens (B, 1) → (logits (B, V), caches).  ``caches["length"]``
        may be 0-d (all lanes in lockstep) or (B,) (each lane at its own
        position, masked to its own length in attention)."""
        b = tokens.shape[0]
        x = self._embed(params, tokens)
        lens = caches["length"]
        positions = (lens.reshape(1, 1).expand(b, 1) if lens.ndim == 0
                     else lens[:, None])
        h, caches, _ = self._backbone(params, x, positions, caches=caches)
        return self._logits(params, h), caches

    # ---------------------------------------------------------------- caches
    def init_cache(self, batch: int, max_len: int, device=None):
        """Zeroed caches for ``batch`` lanes of ``max_len`` positions, in
        the compute type; ``device=None`` is the card."""
        cfg = self.cfg
        dev = registry.resolve_device(device)
        dt = getattr(torch, cfg.compute_dtype)
        hk, hd = cfg.num_kv_heads, cfg.head_dim
        length = torch.zeros((), dtype=torch.int32, device=dev)

        def kv(n_lead, lmax):
            shape = tuple(n_lead) + (batch, hk, lmax, hd)
            return dict(k=torch.zeros(shape, dtype=dt, device=dev),
                        v=torch.zeros(shape, dtype=dt, device=dev))

        if cfg.family in ("audio", "hybrid", "ssm"):
            raise NotImplementedError(f"{cfg.family} caches: {NOT_PORTED}")
        if cfg.attn_pattern == "local_global":
            inner = cfg.local_per_global + 1
            groups = cfg.num_layers // inner
            return {"local": kv((groups, inner - 1), min(cfg.window, max_len)),
                    "global": kv((groups, 1), max_len), "length": length}
        return {"kv": kv((cfg.num_layers,), max_len), "length": length}
