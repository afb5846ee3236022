"""Analytic FLOP / HBM-byte model per (architecture x shape cell); the
port's own copy of ``repro.launch.cost_model`` on its ``ModelConfig``,
``ShapeCell``, ``model_specs``, ``param_count`` and ``param_bytes``, giving
the reference's numbers exactly.

Backend-independent first-order roofline inputs; the dry run records a FLOP
count traced on meta tensors beside them as a diagnostic (``dryrun.py``).

Conventions
-----------
* FLOPs are global (all chips), multiply-add = 2 FLOPs.
* train = fwd + bwd = 3x forward matmul FLOPs (dots-saveable remat policy
  recomputes only elementwise ops — matmul recompute ≈ 0).
* HBM bytes are global per step; the model counts the dominant streams and
  documents what it ignores (small norms, biases, indices).
* decode counts one token step against a ``seq_len``-deep cache.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, ShapeCell
from ..models.params import param_bytes, param_count
from ..models.transformer import model_specs


@dataclasses.dataclass
class CellCost:
    flops: float                 # global FLOPs for the step
    hbm_bytes: float             # global HBM traffic for the step
    model_flops: float           # 6·N_active·D (train) / 2·N_active·D (infer)
    n_params: int
    n_active: int
    breakdown: dict

    def to_dict(self):
        return dataclasses.asdict(self)


def _active_params(cfg: ModelConfig) -> int:
    n = param_count(model_specs(cfg))
    if cfg.moe is None:
        return n
    m = cfg.moe
    all_experts = 3 * cfg.d_model * m.d_ff_expert * m.num_experts * cfg.num_layers
    active = 3 * cfg.d_model * m.d_ff_expert * m.top_k * cfg.num_layers
    return n - all_experts + active


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_every      # shared-attn sites
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers


def _attn_ctx_tokens(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Mean attended context length per query token."""
    s = cell.seq_len
    if cell.kind == "decode":
        full = s                                       # one q vs full cache
        local = min(cfg.window, s) if cfg.window else s
    else:
        full = s / 2                                   # causal mean
        local = min(cfg.window, s) / 1 if cfg.window else s / 2
        if cfg.window:
            local = min(cfg.window, s)                 # window cap per query
    if cfg.attn_pattern == "local_global":
        g = 1.0 / (cfg.local_per_global + 1)
        return g * full + (1 - g) * local
    return full


def forward_flops(cfg: ModelConfig, cell: ShapeCell) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, hk, f, v = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size
    bsz = cell.global_batch
    new_tokens = bsz * (1 if cell.kind == "decode" else cell.seq_len)
    out: dict[str, float] = {}

    # attention projections + scores (qkvo on new tokens; scores vs context)
    n_attn = _attn_layers(cfg)
    if n_attn:
        proj = 2 * new_tokens * (d * h * hd + 2 * d * hk * hd + h * hd * d)
        ctx = _attn_ctx_tokens(cfg, cell)
        scores = 2 * new_tokens * ctx * h * hd * 2     # QK^T and PV
        out["attn"] = n_attn * (proj + scores)

    # FFN
    if cfg.moe is not None:
        m = cfg.moe
        router = 2 * new_tokens * d * m.num_experts
        experts = 2 * new_tokens * m.top_k * 3 * d * m.d_ff_expert
        out["moe"] = cfg.num_layers * (router + experts)
    elif cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
        pass                                           # ffn inside rwkv below
    elif cfg.family in ("dense", "vlm", "moe"):
        nmat = 3 if cfg.act == "swiglu" else 2
        out["mlp"] = cfg.num_layers * 2 * new_tokens * nmat * d * f
    elif cfg.family == "audio":
        nmat = 3 if cfg.act == "swiglu" else 2
        enc_tokens = bsz * cfg.num_frames if cell.kind != "decode" else 0
        out["mlp"] = cfg.num_layers * 2 * new_tokens * nmat * d * f
        out["encoder"] = cfg.encoder_layers * (
            2 * enc_tokens * (4 * d * d + nmat * d * f)
            + 2 * enc_tokens * (bsz and cfg.num_frames) * d * 2)
        out["cross"] = cfg.num_layers * (
            2 * new_tokens * 2 * d * d                  # q, o proj
            + 2 * (enc_tokens or bsz * cfg.num_frames) * 2 * d * d  # k, v
            + 2 * new_tokens * cfg.num_frames * d * 2)
    if cfg.family in ("hybrid",):
        nmat = 3 if cfg.act == "swiglu" else 2
        out["shared_mlp"] = n_attn * 2 * new_tokens * nmat * d * f

    # SSM mixers
    if cfg.ssm is not None and cfg.ssm.kind == "mamba2":
        s = cfg.ssm
        di = s.expand * d
        n = s.d_state
        heads = di // s.head_dim
        zdim = 2 * di + 2 * n + heads
        lc = min(s.chunk, cell.seq_len) if cell.kind != "decode" else 1
        per_tok = (2 * d * zdim + 2 * di * d              # in/out proj
                   + 2 * s.conv_width * (di + 2 * n)      # conv
                   + 2 * lc * (n + di)                    # intra-chunk scores
                   + 2 * 2 * n * di)                      # state update + C·h
        out["mamba"] = cfg.num_layers * new_tokens * per_tok
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        n = d // cfg.num_heads
        per_tok = (2 * 5 * d * d + 2 * d * 64 * 2          # r,k,v,g,o + lora
                   + cfg.num_heads * 4 * n * n             # wkv recurrence
                   + 2 * (2 * d * f + d * d))              # channel mix
        out["rwkv"] = cfg.num_layers * new_tokens * per_tok

    out["lm_head"] = 2 * new_tokens * d * v
    return out


def hbm_bytes(cfg: ModelConfig, cell: ShapeCell, flops_total: float) -> dict:
    bsz = cell.global_batch
    s = cell.seq_len
    d = cfg.d_model
    pb = param_bytes(model_specs(cfg))
    new_tokens = bsz * (1 if cell.kind == "decode" else s)
    act_bytes = 2                                       # bf16 activations
    out: dict[str, float] = {}

    if cell.kind == "train":
        mdt = 2 if cfg.name in ("kimi-k2-1t-a32b", "qwen2-vl-72b") else 4
        # params: read fwd + read bwd + grad write + update rw
        out["params"] = pb * 4
        out["optimizer"] = param_count(model_specs(cfg)) * mdt * 4  # m,v rw
        # saved activations: block I/O per layer (dots-saveable ≈ 4 resident
        # tensors per block of size T·D) written fwd + read bwd
        out["activations"] = cfg.num_layers * new_tokens * d * act_bytes * 4 * 2
        out["logits"] = 2 * new_tokens * cfg.vocab_size * 4 / 8  # chunked f32
    elif cell.kind == "prefill":
        out["params"] = pb
        out["activations"] = cfg.num_layers * new_tokens * d * act_bytes * 4
        out["kv_write"] = _cache_bytes(cfg, cell)
    else:  # decode
        out["params"] = pb
        out["kv_read"] = _cache_bytes(cfg, cell)
        out["activations"] = cfg.num_layers * new_tokens * d * act_bytes * 4
    # arithmetic working set lower bound: every FLOP pair touches operands in
    # cache, not HBM — ignored by design (documented).
    return out


def _cache_bytes(cfg: ModelConfig, cell: ShapeCell) -> float:
    bsz, s = cell.global_batch, cell.seq_len
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.family == "ssm":
        n = cfg.d_model // cfg.num_heads
        return cfg.num_layers * bsz * (cfg.num_heads * n * n * 4 + 2 * cfg.d_model * 2)
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        di = ssm.expand * cfg.d_model
        heads = di // ssm.head_dim
        sites = cfg.num_layers // cfg.shared_every
        return (cfg.num_layers * bsz * heads * ssm.d_state * ssm.head_dim * 4
                + sites * 2 * bsz * hk * s * hd * 2)
    n_attn = cfg.num_layers
    if cfg.attn_pattern == "local_global":
        inner = cfg.local_per_global + 1
        g = cfg.num_layers // inner
        return (g * 2 * bsz * hk * s * hd * 2                     # global
                + g * cfg.local_per_global * 2 * bsz * hk
                * min(cfg.window, s) * hd * 2)                    # local
    return n_attn * 2 * bsz * hk * s * hd * 2


def cell_cost(cfg: ModelConfig, cell: ShapeCell) -> CellCost:
    fwd = forward_flops(cfg, cell)
    fwd_total = float(sum(fwd.values()))
    mult = 3.0 if cell.kind == "train" else 1.0
    flops = fwd_total * mult
    hb = hbm_bytes(cfg, cell, flops)
    n = param_count(model_specs(cfg))
    na = _active_params(cfg)
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    mf = (6.0 if cell.kind == "train" else 2.0) * na * tokens
    return CellCost(flops=flops, hbm_bytes=float(sum(hb.values())),
                    model_flops=mf, n_params=n, n_active=na,
                    breakdown={"fwd_flops": fwd, "hbm": hb})
