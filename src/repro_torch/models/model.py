"""Model: turns a ModelConfig into train/prefill/decode functions;
counterpart of ``repro.models.model`` for every family: dense, MoE, VLM,
Gemma's local/global stack, ``block_sparse`` and the sparse FFN, the Zamba2
hybrid (Mamba-2 groups and one shared attention block), RWKV-6 and the
Whisper encoder-decoder.

All functions are pure (params and caches in, values out; a cache given is
not written).  The reference's ``lax.scan`` over the stacked leading axis is
a Python loop here; its ``_remat`` is ``torch.utils.checkpoint`` around each
block (a Zamba2 group, an RWKV block) when ``cfg.remat != "none"`` and
autograd records.  Cache layout:

  dense/moe/vlm  {"kv": {k,v: (L, B, Hk, Lmax, hd)}, length}
  gemma3         {"local": {k,v: (G, inner-1, B, Hk, min(window, Lmax), hd)},
                  "global": {k,v: (G, 1, B, Hk, Lmax, hd)}, length}
  hybrid(zamba2) {"ssm": (G, inner, B, H, N, P) f32, "conv": (G, inner, B,
                  W-1, C), "kv": {k,v: (G, B, Hk, Lmax, hd)}, length}
  ssm(rwkv6)     {"wkv": (L, B, H, N, N) f32, "tm_prev" / "cm_prev": (L, B,
                  D), length}
  audio(whisper) {"kv": decoder self-attention (L, ...), "memory": (B, Sm,
                  D) (set by prefill), length}

``length`` is a 0-d int32 tensor, or (B,) for lanes at their own positions.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import registry
from ..dist.placement import (block_index, device_get, device_put, dim_axes,
                              is_placed)
from ..dist.sharding_rules import PartitionSpec
from . import sharding_ctx, spmd
from .config import ModelConfig
from .layers import rmsnorm
from .model_loss import lm_loss, lm_loss_vocab_parallel
from .params import init_params
from .rwkv import rwkv6_channel_mix, rwkv6_time_mix
from .ssm import mamba2_mix
from .transformer import (attn_apply, dense_block_apply, ffn_apply,
                          model_specs, sparse_patterns)


def _leaves(tree, keys=()):
    """``(path keys, leaf)`` of each leaf of a nested dict."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _leaves(v, keys + (k,))]
    return [(keys, tree)]


def _tree_at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


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
        emb = params["embed"]
        if sharding_ctx.tensor_parallel(emb):        # decode on placed params
            x = spmd.embed_lookup(emb, tokens)
        else:
            x = sharding_ctx.gathered(emb)[tokens]
        if self.cfg.attn_pattern == "local_global":        # gemma convention
            x = x * float(torch.tensor(math.sqrt(self.cfg.d_model),
                                       dtype=x.dtype))
        return sharding_ctx.constrain(
            x.to(getattr(torch, self.cfg.compute_dtype)), ("batch", None, None))

    def _unembed_w(self, params):
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    # ------------------------------------------------------------- backbones
    def _remat(self, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint`` when training
        with remat.  The recompute runs in the backward, on autograd's
        thread for CUDA tensors: it re-enters the forward's backend scope
        and its sharding scopes (a placed step's position gathers its
        weights again there)."""
        if self.cfg.remat == "none" or not torch.is_grad_enabled():
            return fn(*args)
        scoped = registry.scoped_backend()
        scopes = sharding_ctx.capture()

        def run(*a):
            with registry.backend_scope(scoped), sharding_ctx.restore(scopes):
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False)

    def _block(self, p, x, positions, cache=None, window=0, patterns=None):
        """One decoder block, checkpointed when training with remat."""
        cfg = self.cfg
        if cache is None:
            def run(p_, x_):
                y, _, a = dense_block_apply(p_, x_, cfg, positions=positions,
                                            window=window, patterns=patterns)
                return y, torch.as_tensor(a, dtype=torch.float32,
                                          device=y.device)
            y, a = self._remat(run, p, x)
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

    def _backbone_zamba(self, params, x, positions, caches=None):
        """Zamba2: groups of ``shared_every`` Mamba-2 layers, each group
        closed by the one shared attention block.  Every group reads the
        same ``shared_attn`` tensors, so their gradient is the sum over the
        groups."""
        cfg = self.cfg
        inner = cfg.shared_every
        groups = cfg.num_layers // inner
        decode = x.shape[1] == 1 and caches is not None
        shared_p = params["shared_attn"]

        def group(pg, shared, x, ssm_g=None, conv_g=None, kv=None):
            states, convs = [], []
            for i in range(inner):
                pi = _tree_idx(pg, i)
                y, (st, cv) = mamba2_mix(
                    pi, rmsnorm(x, pi["ln"], cfg.norm_eps), cfg.ssm,
                    cfg.d_model, state=None if ssm_g is None else ssm_g[i],
                    conv_cache=None if conv_g is None else conv_g[i],
                    decode=decode)
                x = x + y
                states.append(st)
                convs.append(cv)
            x, kv, _ = dense_block_apply(shared, x, cfg, positions=positions,
                                         cache=kv)
            return x, states, convs, kv

        new_ssm, new_conv, new_kv = [], [], []
        for g in range(groups):
            pg = _tree_idx(params["blocks"], g)
            if caches is None:
                x = self._remat(lambda p_, s_, x_: group(p_, s_, x_)[0],
                                pg, shared_p, x)
                continue
            kv = dict(_tree_idx(caches["kv"], g), length=caches["length"])
            x, states, convs, kv = group(pg, shared_p, x, caches["ssm"][g],
                                         caches["conv"][g], kv)
            new_ssm.append(torch.stack(states))
            new_conv.append(torch.stack(convs))
            new_kv.append(kv)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if caches is None:
            return x, None, zero
        return x, dict(caches, ssm=torch.stack(new_ssm),
                       conv=torch.stack(new_conv),
                       kv=_stack_caches(new_kv, (groups,)),
                       length=caches["length"] + x.shape[1]), zero

    def _backbone_rwkv(self, params, x, positions, caches=None):
        """RWKV-6: time mix and channel mix a layer, each carrying its state
        (the WKV matrix, the last normed token) in the cache."""
        cfg = self.cfg

        def block(p, x, wkv=None, tm_prev=None, cm_prev=None):
            xn = rmsnorm(x, p["ln1"], cfg.norm_eps)
            y, (wkv, tm_prev) = rwkv6_time_mix(p, xn, cfg.num_heads,
                                               state=wkv, x_prev=tm_prev)
            x = x + y
            xn = rmsnorm(x, p["ln2"], cfg.norm_eps)
            y, cm_prev = rwkv6_channel_mix(p, xn, x_prev=cm_prev)
            return x + y, wkv, tm_prev, cm_prev

        new = {"wkv": [], "tm_prev": [], "cm_prev": []}
        for i in range(cfg.num_layers):
            p = _tree_idx(params["blocks"], i)
            if caches is None:
                x = self._remat(lambda p_, x_: block(p_, x_)[0], p, x)
                continue
            x, *state = block(p, x, *(caches[k][i] for k in new))
            for k, v in zip(new, state):
                new[k].append(v)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if caches is None:
            return x, None, zero
        return x, dict(caches, **{k: torch.stack(v) for k, v in new.items()},
                       length=caches["length"] + x.shape[1]), zero

    def _encode_audio(self, params, frames):
        """Whisper encoder over the frame embeddings (B, Sm, D): the
        sinusoid added, then non-causal blocks with RoPE, as the
        reference."""
        cfg = self.cfg
        x = frames.to(getattr(torch, cfg.compute_dtype))
        pos = torch.arange(x.shape[1], device=x.device)[None]
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        for i in range(cfg.encoder_layers):
            x, _, _ = dense_block_apply(_tree_idx(params["enc_blocks"], i), x,
                                        cfg, positions=pos, causal=False)
        return rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)

    def _backbone_whisper(self, params, x, positions, caches=None,
                          memory=None):
        """Whisper decoder: causal self-attention (cached), cross-attention
        on ``memory`` (its K/V recomputed at every call, as the reference),
        the MLP; sinusoidal positions, no RoPE."""
        cfg = self.cfg
        x = x + _sinusoid_at(positions, cfg.d_model, x.dtype)
        new_kv = []
        for i in range(cfg.num_layers):
            p = _tree_idx(params["dec_blocks"], i)
            kv = None
            if caches is not None:
                kv = dict(_tree_idx(caches["kv"], i), length=caches["length"])
            x, kv = attn_apply(p["attn"], x, cfg, positions=positions,
                               cache=kv, rope=False)
            x, _ = attn_apply(p["xattn"], x, cfg, positions=positions,
                              memory=memory, rope=False)
            x, _ = ffn_apply(p["ffn"], x, cfg)
            if caches is not None:
                new_kv.append(kv)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if caches is None:
            return x, None, zero
        return x, dict(caches, kv=_stack_caches(new_kv, (len(new_kv),)),
                       length=caches["length"] + x.shape[1]), zero

    def _backbone(self, params, x, positions, caches=None, memory=None):
        cfg = self.cfg
        if cfg.family == "audio":
            return self._backbone_whisper(params, x, positions, caches,
                                          memory)
        if cfg.attn_pattern == "local_global":
            return self._backbone_gemma(params, x, positions, caches)
        if cfg.family == "hybrid":
            return self._backbone_zamba(params, x, positions, caches)
        if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
            return self._backbone_rwkv(params, x, positions, caches)
        return self._backbone_uniform(params, x, positions, caches)

    # ------------------------------------------------------------ public fns
    def _hidden(self, params, batch):
        """The final-normed hidden states (B, S, D) of the batch's tokens
        and the backbone's aux loss."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)[
            None].expand(tokens.shape)
        memory = None
        if cfg.family == "audio":
            memory = self._encode_audio(params, batch["frames"])
        h, _, aux = self._backbone(params, x, positions, memory=memory)
        return rmsnorm(h, params["final_ln"], cfg.norm_eps), aux

    def loss_fn(self, params, batch):
        """batch: tokens (B, S), labels (B, S) [-1 = pad]; audio adds frames
        (B, Sm, D) → (loss, {"ce_loss", "aux_loss", "tokens"}).  On placed
        parameters (``dist.placement``) the weight-gathered SPMD runtime
        runs it (``_loss_placed``): every value is then a replicated
        ``Placed``."""
        if is_placed(params):
            return self._loss_placed(params, batch)
        cfg = self.cfg
        h, aux = self._hidden(params, batch)
        loss, ntok = lm_loss(h, self._unembed_w(params), batch["labels"])
        aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
        total = loss + aux_w * aux / max(cfg.num_layers, 1)
        return total, {"ce_loss": loss, "aux_loss": aux, "tokens": ntok}

    def _prefill_hidden(self, params, batch, max_len: int):
        """The final-normed hidden state of the last position (B, 1, D) and
        the caches of ``max_len`` that prefill hands on."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        caches = self.init_cache(b, max_len, device=tokens.device)
        memory = None
        if self.cfg.family == "audio":
            memory = self._encode_audio(params, batch["frames"])
            caches["memory"] = memory
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        h, caches, _ = self._backbone(params, x, positions, caches=caches,
                                      memory=memory)
        return rmsnorm(h[:, -1:], params["final_ln"], self.cfg.norm_eps), caches

    def prefill(self, params, batch, max_len: int):
        """tokens (B, S) (audio: and frames (B, Sm, D), whose encoding the
        caches keep as ``memory``) → (last-position logits (B, V), caches of
        ``max_len``).  On placed parameters the SPMD runtime runs it
        (``_prefill_placed``: logits and caches placed)."""
        if is_placed(params):
            return self._prefill_placed(params, batch, max_len)
        h, caches = self._prefill_hidden(params, batch, max_len)
        return (h.float() @ self._unembed_w(params).float())[:, 0], caches

    def _decode_hidden(self, params, caches, tokens):
        """The final-normed hidden state (B, 1, D) of one decode step and
        the caches it hands on."""
        b = tokens.shape[0]
        x = self._embed(params, tokens)
        lens = caches["length"]
        positions = (lens.reshape(1, 1).expand(b, 1) if lens.ndim == 0
                     else lens[:, None])
        memory = caches.get("memory") if self.cfg.family == "audio" else None
        h, caches, _ = self._backbone(params, x, positions, caches=caches,
                                      memory=memory)
        return rmsnorm(h, params["final_ln"], self.cfg.norm_eps), caches

    def decode_step(self, params, caches, tokens):
        """tokens (B, 1) → (logits (B, V), caches).  ``caches["length"]``
        may be 0-d (all lanes in lockstep) or (B,) (each lane at its own
        position, masked to its own length in attention).  On placed
        parameters the SPMD runtime runs it tensor-parallel
        (``_decode_placed``: logits and caches placed)."""
        if is_placed(params):
            return self._decode_placed(params, caches, tokens)
        h, caches = self._decode_hidden(params, caches, tokens)
        return (h.float() @ self._unembed_w(params).float())[:, 0], caches

    # ------------------------------------------------ on placed parameters
    def _vocab_axes(self, params) -> tuple:
        """The mesh axes the unembedding's vocab dim is sharded over
        (placed params, or a position's views of them)."""
        tied = self.cfg.tie_embeddings
        leaf = params["embed"] if tied else params["lm_head"]
        placed = leaf.placed if isinstance(leaf, spmd.LocalView) else leaf
        return dim_axes(placed.spec[0 if tied else 1])

    def _unembed_shard(self, views) -> tuple:
        """This position's vocab shard of the unembedding, ``(w (D, V_l),
        its first vocab id)``: the tied embedding's or ``lm_head``'s local
        view gathered over every axis but the vocab dim's."""
        tied = self.cfg.tie_embeddings
        vaxes = self._vocab_axes(views)
        view = views["embed"] if tied else views["lm_head"]
        w = view.gather(keep=vaxes)
        w = w.T if tied else w
        return w, block_index(view.placed.mesh, view.pos, vaxes) * w.shape[1]

    def _loss_placed(self, params, batch):
        """``loss_fn`` on placed parameters: each position's program
        (``spmd.Runtime``) takes its rows of the batch, the vocab-parallel
        loss combines them; ``(loss, metrics)``, each a replicated
        ``Placed`` 0-d value whose positions' tensors lie in one autograd
        graph."""
        spmd.refuse(self.cfg, "train")
        batch = device_get(batch)
        rt = spmd.Runtime.of(params, batch["tokens"].shape[0])
        hs, ws, v0, ys = {}, {}, {}, {}
        for pos in rt.positions:
            with rt.at(pos):
                views = rt.views(params, pos)
                rows = {k: rt.rows(v, pos) for k, v in batch.items()}
                hs[pos], _ = self._hidden(views, rows)
                ws[pos], v0[pos] = self._unembed_shard(views)
                ys[pos] = rows["labels"]
        ce, cnt = lm_loss_vocab_parallel(hs, ws, ys, v0, rt,
                                         self._vocab_axes(params))
        zero = {p: torch.zeros((), dtype=torch.float32, device=rt.device(p))
                for p in rt.positions}
        return rt.rep(ce, "loss"), {"ce_loss": rt.rep(ce),
                                    "aux_loss": rt.rep(zero),
                                    "tokens": rt.rep(cnt)}

    def _prefill_placed(self, params, batch, max_len: int):
        """``prefill`` on placed parameters: ``(logits, caches)`` placed,
        the last position's logits ``(B, V)`` over the batch and vocab axes,
        the caches by the spec the rules give them."""
        spmd.refuse(self.cfg, "prefill")
        batch = device_get(batch)
        rt = spmd.Runtime.of(params, batch["tokens"].shape[0])
        logits, caches = {}, {}
        for pos in rt.positions:
            with rt.at(pos):
                views = rt.views(params, pos)
                rows = {k: rt.rows(v, pos) for k, v in batch.items()}
                h, caches[pos] = self._prefill_hidden(views, rows, max_len)
                w, _ = self._unembed_shard(views)
                logits[pos] = (h.float() @ w.float())[:, 0]
        spec = PartitionSpec(spmd.spec_dim(rt.batch_axes),
                             spmd.spec_dim(self._vocab_axes(params)))
        return (rt.placed(logits, spec, name="logits"),
                rt.place_local(caches, cache_logical))

    def _decode_placed(self, params, caches, tokens):
        """``decode_step`` on placed parameters, under rules without
        ``__gather_weights__`` (the installed ones, else ``TRAIN_RULES``):
        each position's program (``spmd.Runtime.run``) takes its rows of
        the tokens, keeps the weights' pieces over ``model`` and merges the
        sequence-split caches' attention; ``(logits, caches)`` placed, the
        logits ``(B, V)`` over the batch and vocab axes, each cache leaf as
        it came (unplaced caches are placed by ``cache_shardings``)."""
        spmd.refuse(self.cfg, "decode")
        tokens = device_get(tokens)
        rt = spmd.Runtime.of(params, tokens.shape[0], decode=True)
        if not is_placed(caches):
            caches = device_put(caches, self.cache_shardings(caches, rt.mesh,
                                                             rt.rules))
        length = caches["length"]
        state = {k: v for k, v in caches.items() if k != "length"}

        def program(pos):
            views = rt.views(params, pos)
            lens = length.local(pos)
            local = dict(rt.cache_views(state, pos, SPLIT_CACHES),
                         length=rt.rows(lens, pos) if lens.ndim else lens)
            h, new = self._decode_hidden(views, local,
                                         rt.rows(tokens, pos))
            w, _ = self._unembed_shard(views)
            return (h.float() @ w.float())[:, 0], new
        outs = rt.run(program)
        spec = PartitionSpec(spmd.spec_dim(rt.batch_axes),
                             spmd.spec_dim(self._vocab_axes(params)))
        logits = rt.placed({p: o[0] for p, o in outs.items()}, spec,
                           name="logits")

        def place(tree, keys=()):
            if isinstance(tree, dict):
                return {k: place(v, keys + (k,)) for k, v in tree.items()}
            by_pos = {p: _tree_at(o[1], keys) for p, o in outs.items()}
            if not rt.reads_split(tree, SPLIT_CACHES):
                by_pos = {p: rt.cut(t, tree.spec, p) for p, t in
                          by_pos.items()}
            return rt.placed(by_pos, tree.spec, tree.shape, tree.name)
        return logits, dict(place(state), length=length.map(lambda t: t + 1))

    def cache_shardings(self, caches, mesh, rules=None) -> dict:
        """The ``NamedSharding`` of each cache leaf on ``mesh``: the spec
        ``rules`` (default: decode's, ``TRAIN_RULES``) give its
        ``cache_logical`` axes, the batch over the batch axes where they
        divide it and a dim its axes do not divide kept whole — the layout
        ``decode_step`` on placed parameters keeps."""
        rules = spmd.gather_rules(mesh, decode=True) if rules is None \
            else {k: v for k, v in rules.items() if k != "__gather_weights__"}
        batch = None
        for keys, leaf in _leaves(caches):
            logical = cache_logical(keys, leaf.ndim)
            if "batch" in logical:
                batch = leaf.shape[logical.index("batch")]
                break
        rt = spmd.Runtime(mesh, rules, batch, decode=True)
        return rt.shardings(caches, cache_logical)

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

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if cfg.family == "audio":
            return {"kv": kv((cfg.num_layers,), max_len), "length": length}
        if cfg.attn_pattern == "local_global":
            inner = cfg.local_per_global + 1
            groups = cfg.num_layers // inner
            return {"local": kv((groups, inner - 1), min(cfg.window, max_len)),
                    "global": kv((groups, 1), max_len), "length": length}
        if cfg.family == "hybrid":
            s = cfg.ssm
            di = s.expand * cfg.d_model
            groups = cfg.num_layers // cfg.shared_every
            lead = (groups, cfg.shared_every, batch)
            return {
                "ssm": zeros(lead + (di // s.head_dim, s.d_state, s.head_dim),
                             torch.float32),
                "conv": zeros(lead + (s.conv_width - 1, di + 2 * s.d_state),
                              dt),
                "kv": kv((groups,), max_len),
                "length": length,
            }
        if cfg.family == "ssm":  # rwkv6
            n = cfg.d_model // cfg.num_heads
            lead = (cfg.num_layers, batch)
            return {"wkv": zeros(lead + (cfg.num_heads, n, n), torch.float32),
                    "tm_prev": zeros(lead + (cfg.d_model,), dt),
                    "cm_prev": zeros(lead + (cfg.d_model,), dt),
                    "length": length}
        return {"kv": kv((cfg.num_layers,), max_len), "length": length}


#: the cache leaves decode reads split beyond the batch (``LocalView``s):
#: a KV cache along its sequence (``attn_apply``), a Mamba-2 conv cache
#: along its channels and its state along its heads (``mamba2_mix``)
SPLIT_CACHES = ("k", "v", "conv", "ssm")


def cache_logical(path_keys: tuple, ndim: int) -> tuple:
    """The logical axes of the cache leaf at ``path_keys`` (``ndim`` dims),
    which the sharding rules map onto a mesh."""
    last = path_keys[-1]
    if last in ("k", "v"):
        if ndim == 6:
            return ("groups", "inner", "batch", "kv_heads", "cache_seq", "head_dim")
        return ("layers", "batch", "kv_heads", "cache_seq", "head_dim")
    if last == "ssm":
        return ("groups", "inner", "batch", "heads", None, None)
    if last == "conv":
        return ("groups", "inner", "batch", None, "ssm_in")
    if last == "wkv":
        # rwkv6's 40 heads divide no model axis: heads replicated, batch
        # sharded
        return ("layers", "batch", None, None, None)
    if last in ("tm_prev", "cm_prev"):
        return ("layers", "batch", "embed")
    if last == "memory":
        return ("batch", None, "embed")
    if last == "length":
        return ()
    raise ValueError(f"unknown cache leaf {path_keys}")


def _sinusoid(s: int, d: int, dtype, device) -> torch.Tensor:
    """The (s, d) sinusoidal table, [sin | cos], computed in float64 on the
    host and cast, as the reference; on the meta device its shape only
    (the dry run's trace), with no table on the host."""
    if torch.device(device).type == "meta":
        return torch.empty((s, d), dtype=dtype, device=device)
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return torch.as_tensor(np.concatenate([np.sin(ang), np.cos(ang)], -1),
                           dtype=dtype, device=device)


def _sinusoid_at(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """The sinusoid at ``positions`` (B, S) → (B, S, d), in f32, cast."""
    i = torch.arange(d // 2, device=positions.device)[None, None, :]
    ang = positions[..., None] / (10000 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)
