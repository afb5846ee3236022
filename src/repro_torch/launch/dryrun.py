"""Dry run of every (architecture x shape-cell) on the production meshes,
on meta tensors; counterpart of ``repro.launch.dryrun``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --multipod
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --all --multipod

Artifacts: results/dryrun/<arch>__<shape>__<mesh>.json, with the
reference's keys.  Nothing is allocated: the stand-ins are meta tensors
(``input_specs.build_cell``) and the mesh's positions are meta devices
(``mesh.make_production_mesh``), so it runs anywhere, the CPU included.

Where the reference compiles the step for 512 fake devices and reads XLA's
analyses, the port derives each term from the stand-ins and the rules:

* ``memory_analysis`` (bytes a device): the arguments (params, moments,
  batch, caches), exact from each stand-in's shape, type and spec (a dim
  its axes do not divide is rounded up); the outputs (train: the state;
  prefill: logits and caches; decode: logits and caches), none of them
  aliased: the port's step returns a new state (and decode new caches)
  while the old is alive, where the reference's compiled step donates
  it; ``temp`` is the analytic activation term,
  ``cost_model.hbm_bytes``' activations (train: half of them, written
  forward and read backward, plus the gradients; prefill and decode: one
  layer's share) over the batch's axes; no code size.  ``fits`` compares
  the peak with the card's HBM (80 GiB).
* ``collectives``: for every cell of the families the runtime runs (all
  but MoE: Llama, Phi, Gemma, Qwen2-VL, Zamba2, RWKV-6, Whisper; train and
  prefill weight-gathered, decode tensor-parallel), the log of one
  position's program (``models/spmd.py``; ``runtime_collectives``): the
  step run on the meta mesh for position ``(0, 0)`` alone, the SPMD
  symmetry making one position enough.  Every other cell takes the plan's
  collectives, counted from the rules and each leaf's spec, and so does a
  runtime cell whose trace passes ``TRACE_BUDGET_S`` (RWKV-6's token loop
  at 4,096 and 32,768; ``collectives["runtime_reason"]`` says so).
  ``collectives["source"]`` names which.  The plan (``plan_collectives``)
  agrees with the runtime's log on its cells byte for byte
  (``tests/test_torch_tp.py``, ``tests/test_torch_tp_sparse.py``); its
  assumptions:
    - train and prefill gather every sharded weight where it is used
      (``__gather_weights__``), hierarchically, the ``data`` / ``pod`` axes
      first, so that the slow link carries the smaller share; a block's
      weights once a layer (a Zamba2 group's layers and its shared block's
      weights once a group), again in the recompute of a rematted block
      (Whisper's blocks are not rematted); the
      embedding whole for the lookup and, tied, over its non-vocab axes for
      the unembedding (``lm_head`` likewise), each once; expert weights stay
      sharded over their ``experts`` axis (EP: the tokens move) and are
      gathered over their other axes only;
    - a sparse FFN's value stream is never gathered: each of its matmuls
      broadcasts the position's columns to the shards along its tile axes
      and reduces their partials onto it, backward the cotangent out and
      dX back, in the compute type (``_sparse_moves``);
    - the gradient of a gathered weight is reduce-scattered over the batch
      axes it was gathered over (the last gathered first) and *sliced* over
      the others: the ``model`` positions compute the same rows, so each
      holds the whole gradient of its rows (no reduce-scatter over
      ``model``); a leaf the batch axes replicate has its gradient
      all-reduced over them, in the parameter's type;
    - the vocab-sharded loss (dense families): a chunk's logsumexp max,
      exp-sum and gold logit all-reduced over the vocab axes, and in the
      backward the chunk's hidden-state gradient (B, chunk, d_model) f32;
      the token loss and count over the batch axes; the global norm's
      squares over the mesh;
    - decode keeps TP over ``model``; a leaf sharded over ``data`` / ``pod``
      (FSDP kept for the archs whose weights do not fit the model axis) is
      gathered over those axes at each use (``_plan_decode``, the
      runtime's decode): q, k and v all-gathered over ``model`` (Whisper's
      cross-attention runs on its heads where they split whole), the
      sequence-split cache's softmax merge (max, sum, values) over the
      cache's sequence axes, the row-parallel outputs (in f32, as the
      reference's f32 product) and the embedding's lookup all-reduced, Mamba-2's in-projection and conv channels
      gathered and its gated norm's sum all-reduced, RWKV-6's r / k / v /
      g / decay gathered and its per-head vectors read whole; the MoE's
      decode (the plan, not run) all-reduces each block's residual
      branches over ``model``;
    - the grouped MoE (``moe.moe_sort``, one group a device) runs one
      all-to-all over ``model`` for the dispatch and one for the combine
      of a layer, train both again in the backward; one-hot dispatch moves
      nothing beyond the MLP all-reduce;
    - not counted outside the runtime's cells: the vocab-sharded loss's
      statistics, norms' and router's small all-reduces.
* ``cost_analysis``: a diagnostic, the FLOPs that ``FlopCounterMode``
  counts over the step traced on the stand-ins (global: one trace of the
  whole step), and the bytes its ops read and write (every non-view op
  reads its inputs and writes its outputs: an eager, unfused count).  The
  reference's ``cost_analysis`` is XLA's over the compiled module.  Where
  the trace reaches an op whose result depends on values (no meta
  implementation) or runs past the per-cell budget ``TRACE_BUDGET_S``,
  ``flops`` is null and ``reason`` says why.  A short trace is not scaled
  up.
* ``roofline``: from ``cost_model`` and the collective count, on the H100's
  datasheet constants (``mesh.H100``): plan numbers, not card times.

``lower_s`` is the stand-ins' build and ``compile_s`` the trace (seconds).
Skipped cells (``long_500k`` on pure full-attention archs) emit a skip
artifact so the 40-cell table stays complete.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_NAMES, get
from ..models import SHAPES, Model
from ..models.config import ShapeCell
from ..models.model import SPLIT_CACHES
from ..models.moe import capacity, select_dispatch
from .analysis import Collective, collective_bytes, roofline_terms, summarize
from .cost_model import cell_cost, hbm_bytes
from .input_specs import build_cell, cache_specs
from .mesh import H100, make_production_mesh
from ..dist.placement import device_put
from ..models import spmd
from .sharding_rules import check_divisibility, make_sharding_fn

RESULTS = os.path.join(os.getcwd(), "results", "dryrun")
#: seconds a cell's trace may take before its diagnostic is given up
TRACE_BUDGET_S = 120.0


def cell_by_name(name: str) -> ShapeCell:
    return next(c for c in SHAPES if c.name == name)


def should_skip(cfg, cell: ShapeCell) -> str | None:
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 500k-token cache per layer is "
                "quadratic-prefill territory; skipped per spec, see DESIGN.md §6")
    return None


# --------------------------------------------------------------- per device

def _axes(dim) -> tuple:
    if dim is None:
        return ()
    return (dim,) if isinstance(dim, str) else tuple(dim)


def _extent(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def shard_bytes(t: torch.Tensor, sharding) -> int:
    """Bytes of ``t``'s share on one device under ``sharding`` (a dim its
    axes do not divide is rounded up, as a padded shard)."""
    mesh, spec = sharding
    spec = tuple(spec) + (None,) * (t.ndim - len(spec))
    n = 1
    for size, dim in zip(t.shape, spec):
        n *= -(-size // _extent(mesh, _axes(dim)))
    return n * t.element_size()


def tree_bytes(tree, shardings) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(tree[k], shardings[k]) for k in tree)
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(a, s) for a, s in zip(tree, shardings))
    return shard_bytes(tree, shardings)


def _batch_extent(mesh, rules) -> int:
    return _extent(mesh, [a for a in rules.get("batch", ())
                          if a in mesh.axis_names])


def memory_analysis(model: Model, cell: ShapeCell, built, mesh,
                    hw=H100) -> dict:
    cfg = model.cfg
    sfn = make_sharding_fn(mesh, built.rules)
    args = tree_bytes(built.args, built.shardings)
    hb = hbm_bytes(cfg, cell, 0.0)
    bext = _batch_extent(mesh, built.rules)
    if cell.kind == "train":
        params = tree_bytes(built.args[0]["params"],
                            built.shardings[0]["params"])
        outputs = tree_bytes(built.args[0], built.shardings[0])
        temp = hb["activations"] / 2 / bext + params     # + the gradients
    else:
        logits = torch.empty((cell.global_batch, cfg.vocab_size),
                             dtype=torch.float32, device="meta")
        outputs = shard_bytes(logits, sfn(("batch", "vocab")))
        caches, caches_sh = cache_specs(model, cell.global_batch,
                                        cell.seq_len, sfn)
        outputs += tree_bytes(caches, caches_sh)
        temp = hb["activations"] / max(cfg.num_layers, 1) / bext
    peak = args + outputs + temp
    return {"argument_size_in_bytes": args,
            "output_size_in_bytes": outputs,
            "temp_size_in_bytes": temp,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": 0,
            "peak_memory_in_bytes": peak,
            "hbm_capacity_bytes": hw.hbm_bytes,
            "fits": bool(peak <= hw.hbm_bytes)}


# -------------------------------------------------------------- collectives

def _residual_branches(cfg) -> int:
    """Residual branches a decode step all-reduces over ``model``."""
    if cfg.family == "hybrid":
        return cfg.num_layers + 2 * (cfg.num_layers // cfg.shared_every)
    if cfg.family == "audio":
        return 3 * cfg.num_layers                 # self, cross, MLP
    return 2 * cfg.num_layers


def _param_paths(specs, prefix=""):
    out = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{path}.{k}" if path else k)
        else:
            out.append((path, tree))
    walk(specs, prefix)
    return out


def _gathers(mesh, spec, keep, batch_axes, full, gathers, scatters, what,
             rule) -> list:
    """A weight of ``full`` bytes gathered over its sharded axes but
    ``keep`` (``gathers`` times; the slow axes first) and its gradient
    reduce-scattered over the batch axes among them (``scatters`` times;
    the last gathered first)."""
    gathered = [a for dim in spec for a in _axes(dim) if a not in keep]
    order = ([a for a in gathered if a != "model"]
             + [a for a in gathered if a == "model"])
    out_bytes = full // _extent(mesh, keep)
    recs, left = [], _extent(mesh, order)
    for a in order:
        left //= mesh.shape[a]
        recs.append(Collective("all-gather", out_bytes // left, (a,),
                               mesh.shape[a], gathers, what, rule))
    cur = out_bytes
    for a in reversed(order):
        if a in batch_axes and scatters:
            recs.append(Collective("reduce-scatter", cur, (a,),
                                   mesh.shape[a], scatters, what, rule))
        cur //= mesh.shape[a]
    return recs


#: the sparse FFN's value streams: W is (d_ff, d_model) or (d_model, d_ff)
_SPARSE_W = {"v_gate": "ff", "v_up": "ff", "v_down": "model"}


def _sparse_moves(cfg, mesh, path, ps, layers, tokens, again, train,
                  rule) -> list:
    """The moves of one value stream's sparse matmul in each of ``layers``
    (``spmd.sparse_matmul``): the position's ``x`` (k, tokens) broadcast to
    the shards along the stream's tile axes and their partials (m, tokens)
    reduced onto it, in the compute type; in the backward the cotangent
    (m, tokens) broadcast and the shards' dX (k, tokens) reduced.  A
    replicated stream moves nothing."""
    axes = _axes(ps[-2])
    n = _extent(mesh, axes)
    if n == 1:
        return []
    d, f = cfg.d_model, cfg.d_ff
    m, k = (f, d) if _SPARSE_W[path.rsplit(".", 1)[-1]] == "ff" else (d, f)
    act = getattr(torch, cfg.compute_dtype).itemsize
    # a rematted block's recompute stops at its last saved tensor (torch's
    # early stop): the down projection's reduce, which saves nothing, runs
    # once
    last = path.endswith("v_down")
    recs = [Collective("broadcast", k * tokens * act, axes, n,
                       layers * again, path, rule),
            Collective("reduce", m * tokens * act, axes, n,
                       layers * (1 if last else again), path, rule)]
    if train:
        recs += [Collective("broadcast", m * tokens * act, axes, n, layers,
                            path, rule),
                 Collective("reduce", k * tokens * act, axes, n, layers,
                            path, rule)]
    return recs


def _plan_runtime(model: Model, cell: ShapeCell, mesh, rules) -> list:
    """The collectives of one position's program under the weight-gathered
    runtime (``models/spmd.py``), counted from the specs: what its log
    records, record for record in bytes."""
    cfg = model.cfg
    sfn = make_sharding_fn(mesh, rules)
    train = cell.kind == "train"
    bax = tuple(a for a in rules.get("batch", ()) if a in mesh.axis_names)
    if cell.global_batch % _extent(mesh, bax):
        bax = ()
    b_local = cell.global_batch // _extent(mesh, bax)
    # a rematted block (a Zamba2 group, an RWKV block) runs its forward
    # again in the recompute; Whisper's blocks are not rematted
    again = 2 if train and cfg.remat != "none" else 1
    recs = []
    for path, spec in _param_paths(model.specs):
        ps = tuple(sfn(spec.logical).spec) + (None,) * len(spec.shape)
        ps = ps[:len(spec.shape)]
        full = math.prod(spec.shape) * spec.dtype.itemsize
        stream = path.rsplit(".", 1)[-1].startswith("v_")
        if stream and not check_divisibility(spec.shape, ps, mesh):
            ps = (None,) * len(spec.shape)       # replicated, as placed
        rule = f"{spec.logical} -> {ps}"
        if stream:
            recs += _sparse_moves(cfg, mesh, path, ps, spec.shape[0],
                                  b_local * cell.seq_len, again, train, rule)
        elif path.startswith("blocks."):
            lead = 2 if cfg.attn_pattern == "local_global" or \
                cfg.family == "hybrid" else 1
            layers = math.prod(spec.shape[:lead])
            # a layer a use, again in a rematted block's recompute
            recs += _gathers(mesh, ps[lead:], (), bax, full // layers,
                             layers * again, layers * train, path, rule)
        elif path.startswith(("enc_blocks.", "dec_blocks.")):
            layers = spec.shape[0]
            recs += _gathers(mesh, ps[1:], (), bax, full // layers, layers,
                             layers * train, path, rule)
        elif path.startswith("shared_attn."):
            # Zamba2's shared block: gathered at each group's use
            groups = cfg.num_layers // cfg.shared_every
            recs += _gathers(mesh, ps, (), bax, full, groups * again,
                             groups * train, path, rule)
        elif path in ("embed", "lm_head"):
            vdim = 0 if path == "embed" else 1
            if path == "embed":
                recs += _gathers(mesh, ps, (), bax, full, 1, int(train),
                                 path, rule)
            if path == "lm_head" or cfg.tie_embeddings:
                recs += _gathers(mesh, ps, _axes(ps[vdim]), bax, full, 1,
                                 int(train), f"{path} (unembedding)", rule)
        else:
            recs += _gathers(mesh, ps, (), bax, full, 1, int(train), path,
                             rule)
        if train:
            dp = tuple(a for a in bax if a not in
                       [x for d in ps for x in _axes(d)])
            if dp:
                local = full // _extent(mesh, [x for d in ps for x in _axes(d)])
                recs.append(Collective("all-reduce", local, dp,
                                       _extent(mesh, dp), 1, path, rule))
    if not train:
        return recs
    # the vocab-parallel loss
    emb = "embed" if cfg.tie_embeddings else "lm_head"
    espec = tuple(sfn(model.specs[emb].logical).spec)
    vax = _axes(espec[0 if cfg.tie_embeddings else 1] if espec else None)
    chunk = min(512, cell.seq_len)
    n_chunks = -(-cell.seq_len // chunk)
    if _extent(mesh, vax) > 1:
        n = _extent(mesh, vax)
        stat = b_local * chunk * 4
        for what, nbytes in (("loss max (B, chunk)", stat),
                             ("loss sum (B, chunk)", stat),
                             ("loss gold (B, chunk)", stat),
                             ("loss dh (B, chunk, D)",
                              b_local * chunk * cfg.d_model * 4)):
            recs.append(Collective("all-reduce", nbytes, vax, n, n_chunks,
                                   what, "vocab-parallel loss"))
    if _extent(mesh, bax) > 1:
        for what in ("loss total", "loss count"):
            recs.append(Collective("all-reduce", 4, bax, _extent(mesh, bax),
                                   1, what, "vocab-parallel loss"))
    axes = tuple(mesh.axis_names)
    recs.append(Collective("all-reduce", 4, axes, mesh.size, 1,
                           "global norm", "clip"))
    return recs


#: leaves a decode step reads whole (``sharding_ctx.gathered``): the norms,
#: RWKV-6's token-shift mixes, decay base, bonus and group norm, Mamba-2's
#: dt bias; every other leaf keeps its pieces over ``model``
_READ_WHOLE = ("ln", "ln1", "ln2", "final_ln", "mu_r", "mu_k", "mu_v",
               "mu_w", "mu_g", "mu_ck", "mu_cr", "w0", "u_bonus", "ln_w",
               "ln_b", "dt_bias")


def _tp(dim) -> tuple:
    """The axes of a weight dim that decode keeps split (``spmd.TP_AXES``)."""
    axes = _axes(dim)
    return axes if any(a in spmd.TP_AXES for a in axes) else ()


def _plan_decode(model: Model, cell: ShapeCell, mesh, rules,
                 memory: int) -> list:
    """The collectives of one position's decode program under the
    tensor-parallel runtime (``models/spmd.py``), counted from the specs:
    what its log records, record for record in bytes.  ``memory``: the
    frames of an audio model's encoder memory in the caches (0: none)."""
    cfg = model.cfg
    sfn = make_sharding_fn(mesh, rules)
    bax = tuple(a for a in rules.get("batch", ()) if a in mesh.axis_names)
    if cell.global_batch % _extent(mesh, bax):
        bax = ()
    b = cell.global_batch // _extent(mesh, bax)
    act = getattr(torch, cfg.compute_dtype).itemsize
    d, hd = cfg.d_model, cfg.head_dim
    specs = dict(_param_paths(model.specs))
    recs = []

    def spec(path):
        shape = specs[path].shape
        ps = (tuple(sfn(specs[path].logical).spec)
              + (None,) * len(shape))[:len(shape)]
        if path.rsplit(".", 1)[-1].startswith("v_") and \
                not check_divisibility(shape, ps, mesh):
            ps = (None,) * len(shape)          # replicated, as placed
        return ps

    def coll(kind, nbytes, axes, count, what):
        n = _extent(mesh, axes)
        if n > 1 and count:
            recs.append(Collective(kind, nbytes, tuple(axes), n, count, what,
                                   "runtime"))

    # the weights: pieces over data / pod (FSDP kept) gathered at each use
    groups = cfg.num_layers // cfg.shared_every if cfg.family == "hybrid" \
        else 1
    for path, ps_spec in specs.items():
        if path.startswith(("enc_blocks.", "enc_final_ln")):
            continue                           # the encoder ran at prefill
        ps = spec(path)
        full = math.prod(ps_spec.shape) * ps_spec.dtype.itemsize
        name = path.rsplit(".", 1)[-1]
        rule = f"{ps_spec.logical} -> {ps}"
        if name.startswith("v_"):
            recs += _sparse_moves(cfg, mesh, path, ps, ps_spec.shape[0], b,
                                  1, False, rule)
            continue
        lead, uses = 0, 1
        if path.startswith("blocks."):
            lead = 2 if cfg.attn_pattern == "local_global" or \
                cfg.family == "hybrid" else 1
        elif path.startswith("dec_blocks."):
            lead = 1
        elif path.startswith("shared_attn."):
            uses = groups
        layers = math.prod(ps_spec.shape[:lead])
        sharded = [a for dim in ps[lead:] for a in _axes(dim)]
        keep = () if name in _READ_WHOLE else \
            tuple(a for a in spmd.TP_AXES if a in sharded)
        if path in ("embed", "lm_head"):
            vaxes = _axes(ps[0 if path == "embed" else 1])
            reads = (1 if path == "embed" else 0) + \
                (1 if path == "lm_head" or cfg.tie_embeddings else 0)
            recs += _gathers(mesh, ps, vaxes, bax, full, reads, 0, path, rule)
            continue
        recs += _gathers(mesh, ps[lead:], keep, bax, full // layers,
                         layers * uses, 0, path, rule)

    # the activations' collectives
    vaxes = _axes(spec("embed")[0])
    coll("all-reduce", b * d * specs["embed"].dtype.itemsize, vaxes, 1,
         "embedding (vocab-parallel lookup)")
    caches = model.init_cache(cell.global_batch, cell.seq_len, device="meta")
    csh = model.cache_shardings(caches, mesh, rules)
    # a cache leaf read whole, split beyond its batch (FSDP kept at batch 1)
    for (path, leaf), (_, sh) in zip(_param_paths(caches),
                                     _param_paths(csh)):
        if path.rsplit(".", 1)[-1] not in SPLIT_CACHES:
            recs += _gathers(mesh, tuple(sh.spec), bax, bax,
                             math.prod(leaf.shape) * leaf.element_size(), 1,
                             0, path, "cache leaf read whole")

    def attention(prefix, count, cache=None, cross=0):
        wq, wk, wv, wo = (spec(f"{prefix}.{w}") for w in ("wq", "wk", "wv",
                                                          "wo"))
        q_ax, k_ax, v_ax = _tp(wq[-1]), _tp(wk[-1]), _tp(wv[-1])
        split = bool(q_ax) and k_ax == v_ax == q_ax and \
            cfg.num_kv_heads % _extent(mesh, q_ax) == 0
        if not (cross and split):
            kv_len = cross or 1
            coll("all-gather", b * cfg.num_heads * hd * act, q_ax, count,
                 f"{prefix}.wq (column-parallel)")
            for w, ax in (("wk", k_ax), ("wv", v_ax)):
                coll("all-gather", b * kv_len * cfg.num_kv_heads * hd * act,
                     ax, count, f"{prefix}.{w} (column-parallel)")
        if cache is not None:
            seq = _axes(tuple(cache.spec)[-2])
            stat = b * cfg.num_heads * 4
            coll("all-reduce", stat, seq, count, "decode attention max")
            coll("all-reduce", stat, seq, count, "decode attention sum")
            coll("all-reduce", stat * hd, seq, count,
                 "decode attention values")
        coll("all-reduce", b * d * 4, _tp(wo[-2]), count,
             f"{prefix}.wo (row-parallel)")

    def mlp(prefix, count):
        if cfg.sparse_ffn is None:
            coll("all-reduce", b * d * 4, _tp(spec(f"{prefix}.w_down")[-2]),
                 count, f"{prefix}.w_down (row-parallel)")

    layers = cfg.num_layers
    if cfg.family == "audio":
        attention("dec_blocks.attn", layers, csh["kv"]["k"])
        attention("dec_blocks.xattn", layers, cross=memory)
        mlp("dec_blocks.ffn", layers)
    elif cfg.attn_pattern == "local_global":
        inner = cfg.local_per_global + 1
        g = layers // inner
        attention("blocks.attn", g * (inner - 1), csh["local"]["k"])
        attention("blocks.attn", g, csh["global"]["k"])
        mlp("blocks.ffn", layers)
    elif cfg.family == "hybrid":
        s_ = cfg.ssm
        di = s_.expand * d
        zdim = 2 * di + 2 * s_.d_state + di // s_.head_dim
        coll("all-gather", b * zdim * act, _tp(spec("blocks.w_in")[-1]),
             layers, "blocks.w_in (column-parallel)")
        cax = _axes(tuple(csh["conv"].spec)[-1])
        coll("all-gather", b * (di + 2 * s_.d_state) * act, cax, layers,
             "mamba2 conv channels")
        hax = _axes(tuple(csh["ssm"].spec)[3])
        coll("all-reduce", b * 4, hax, layers, "mamba2 gated norm")
        coll("all-reduce", b * d * 4, _tp(spec("blocks.w_out")[-2]), layers,
             "blocks.w_out (row-parallel)")
        attention("shared_attn.attn", groups, csh["kv"]["k"])
        mlp("shared_attn.ffn", groups)
    elif cfg.family == "ssm":
        for w in ("w_r", "w_k", "w_v", "w_g", "w_decay_b"):
            coll("all-gather", b * d * act, _tp(spec(f"blocks.{w}")[-1]),
                 layers, f"blocks.{w} (column-parallel)")
        for w in ("w_o", "w_cv"):
            coll("all-reduce", b * d * 4, _tp(spec(f"blocks.{w}")[-2]),
                 layers, f"blocks.{w} (row-parallel)")
    else:
        attention("blocks.attn", layers, csh["kv"]["k"])
        mlp("blocks.ffn", layers)
    return recs


def plan_collectives(model: Model, cell: ShapeCell, mesh, rules, *,
                     memory: int = 0) -> list:
    """The step's collectives a device takes part in (``analysis.
    Collective`` records), under the assumptions of the module docstring.
    ``memory``: at an audio model's decode, the frames of the encoder
    memory its caches hold (after a prefill; the dry run's cell starts
    from ``init_cache``, without)."""
    cfg = model.cfg
    gather = bool(rules.get("__gather_weights__"))
    if spmd.supports(cfg) and gather == (cell.kind != "decode"):
        if cell.kind == "decode":
            return _plan_decode(model, cell, mesh, rules, memory)
        return _plan_runtime(model, cell, mesh, rules)
    sfn = make_sharding_fn(mesh, rules)
    train = cell.kind == "train"
    batch_axes = [a for a in rules.get("batch", ()) if a in mesh.axis_names]
    recs = []
    for path, spec in _param_paths(model.specs):
        ps = sfn(spec.logical).spec
        full = math.prod(spec.shape) * spec.dtype.itemsize
        rule = f"{spec.logical} -> {tuple(ps)}"
        sharded = [a for dim in ps for a in _axes(dim)]
        # expert weights stay sharded over their axes (EP): the tokens move
        ep = [a for name, dim in zip(spec.logical, ps) if name == "experts"
              for a in _axes(dim)]
        # the axes a leaf is gathered over, slow link first
        slow = [a for a in sharded if a != "model" and a not in ep]
        fast = [a for a in sharded if a == "model" and a not in ep]
        order = slow + fast if gather else slow
        left = _extent(mesh, sharded)
        for a in order:
            n = mesh.shape[a]
            left //= n
            # all-gather output after gathering ``a``: full / what is left
            recs.append(Collective("all-gather", full / left, (a,), n,
                                   2 if train else 1, path, rule))
        if not train:
            continue
        # the gradient: sliced over the axes that compute the same rows,
        # reduce-scattered over the batch axes (the last gathered first)
        cur = full / _extent(mesh, ep)
        for a in reversed(order):
            n = mesh.shape[a]
            if a in batch_axes:
                recs.append(Collective("reduce-scatter", cur, (a,), n, 1,
                                       path, rule))
            cur /= n
        dp = tuple(a for a in batch_axes if a not in sharded)
        if dp:
            recs.append(Collective("all-reduce", cur, dp,
                                   _extent(mesh, dp), 1, path, rule))
    act = getattr(torch, cfg.compute_dtype).itemsize
    m = mesh.shape.get("model", 1)
    if cell.kind == "decode" and m > 1:
        b_local = -(-cell.global_batch // _extent(mesh, batch_axes))
        recs.append(Collective("all-reduce", b_local * cfg.d_model * act,
                               ("model",), m, _residual_branches(cfg),
                               "block outputs (B, 1, d_model)",
                               "TP over model"))
    if cfg.moe is not None and m > 1:
        tokens = cell.global_batch * (1 if cell.kind == "decode"
                                      else cell.seq_len)
        g = max(1, min(int(rules.get("__moe_groups__", 1)), tokens))
        while tokens % g:
            g //= 2
        if select_dispatch(tokens, cfg.moe) == "sort" and g > 1:
            e = cfg.moe.num_experts
            cap = capacity(tokens // g, cfg.moe)
            per_dev = g * (e * cap) * cfg.d_model * act / mesh.size
            recs.append(Collective(
                "all-to-all", per_dev, ("model",), m,
                cfg.num_layers * (4 if train else 2),
                f"MoE dispatch / combine buffer ({g} groups, capacity {cap})",
                "__moe_groups__, experts -> model"))
    return recs


def runtime_collectives(model: Model, cell: ShapeCell, mesh, built):
    """The collectives of position ``(0, …, 0)``'s program, one step of
    the runtime (``models/spmd.py``) run on the meta mesh for that position
    alone: train and prefill weight-gathered, decode tensor-parallel; None
    for a cell it does not run.  A run past ``TRACE_BUDGET_S`` raises
    ``_OverBudget`` (RWKV-6's token loop)."""
    decode = cell.kind == "decode"
    if not spmd.supports(model.cfg) or \
            bool(built.rules.get("__gather_weights__")) == decode:
        return None
    pos = (0,) * len(mesh.axis_names)
    placed = 2 if decode else 1                # params (and caches) placed
    args = tuple(device_put(a, s) for a, s in
                 zip(built.args[:placed], built.shardings)) + \
        built.args[placed:]
    meter = _Meter(time.monotonic() + TRACE_BUDGET_S)
    with spmd.only_position(pos), spmd.collective_log() as log, meter:
        built.fn(*args)
    return log.program(pos)


# --------------------------------------------------------------- the trace

class _OverBudget(RuntimeError):
    pass


class _Meter(TorchDispatchMode):
    """Bytes that non-view ops read and write, tensors made off ``meta``,
    and the deadline of the trace."""

    def __init__(self, deadline: float):
        super().__init__()
        self.deadline = deadline
        self.bytes = 0
        self.ops = 0
        self.off_meta = 0
        self.over = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if time.monotonic() > self.deadline:
            self.over = True
            raise _OverBudget(f"past the budget after {self.ops} ops")
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.off_meta += sum(t.nbytes for t in outs if t.device.type != "meta")
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.nbytes for t in ins + outs)
        return out


def _where(err: BaseException) -> str:
    """The innermost frame of the port in ``err``'s traceback."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if f"{os.sep}repro_torch{os.sep}" in f.filename
              and f"{os.sep}launch{os.sep}" not in f.filename]
    if not frames:
        return "?"
    f = frames[-1]
    tail = f.filename.split(f"{os.sep}repro_torch{os.sep}")[-1]
    return f"repro_torch/{tail}:{f.lineno} ({f.name})"


def trace_flops(fn, args, budget_s: float = TRACE_BUDGET_S) -> dict:
    """Run ``fn(*args)`` on meta tensors under ``FlopCounterMode``: the
    FLOPs and bytes of the step, or ``flops`` None and the ``reason``."""
    t0 = time.monotonic()
    meter = _Meter(t0 + budget_s)
    out = {"source": "FlopCounterMode over the step traced on meta tensors",
           "budget_s": budget_s}
    try:
        with FlopCounterMode(display=False) as fc, meter:
            fn(*args)
    except Exception as err:            # the diagnostic only, never the cell
        if meter.over:
            reason = (f"trace passed the per-cell budget of {budget_s:g} s "
                      f"after {meter.ops} ops (in {_where(err)})")
        else:
            msg = str(err).strip().splitlines()[0][:240] if str(err) else ""
            reason = (f"{type(err).__name__} at {_where(err)}: {msg} "
                      "(an op whose result depends on values has no meta "
                      "implementation)")
        out.update(flops=None, bytes_accessed=None, reason=reason,
                   ops=meter.ops, trace_s=time.monotonic() - t0,
                   off_meta_bytes=meter.off_meta)
        return out
    out.update(flops=float(fc.get_total_flops()),
               bytes_accessed=float(meter.bytes), ops=meter.ops,
               trace_s=time.monotonic() - t0, off_meta_bytes=meter.off_meta)
    return out


# ---------------------------------------------------------------- the cell

def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str = RESULTS,
             tag: str = "") -> dict:
    cfg = get(arch)
    cell = cell_by_name(shape)
    mesh_name = ("multi" if multi_pod else "single") + (f"-{tag}" if tag else "")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")

    skip = should_skip(cfg, cell)
    if skip:
        artifact = {"arch": arch, "cell": shape, "mesh": mesh_name,
                    "status": "skipped", "reason": skip}
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"SKIP {arch} {shape}: {skip}")
        return artifact

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    model = Model(cfg)
    t0 = time.monotonic()
    built = build_cell(model, cell, mesh)
    t_build = time.monotonic() - t0

    mem = memory_analysis(model, cell, built, mesh)
    print("memory_analysis:", mem)
    plan = plan_collectives(model, cell, mesh, built.rules)
    over = None
    try:
        ran = runtime_collectives(model, cell, mesh, built)
    except _OverBudget as err:
        ran, over = None, (f"the runtime's trace passed the per-cell budget "
                           f"of {TRACE_BUDGET_S:g} s ({err}); the plan "
                           "equals its log at a short sequence "
                           "(tests/test_torch_tp_sparse.py)")
    coll = collective_bytes(plan if ran is None else ran)
    coll["source"] = (
        "plan: dryrun.plan_collectives, counted from the rules" if ran is None
        else "runtime: the log of position (0, 0)'s program, one step of "
        "models/spmd.py on the meta mesh")
    if over:
        coll["runtime_reason"] = over
    coll["plan_total_wire_bytes"] = collective_bytes(plan)["total_wire_bytes"]
    cost = trace_flops(built.fn, built.args)
    print("cost_analysis[flops]:", cost["flops"],
          " bytes:", cost["bytes_accessed"],
          *(["reason:", cost["reason"]] if cost["flops"] is None else []))

    cm = cell_cost(cfg, cell)
    roof = roofline_terms(cm.flops, cm.hbm_bytes, coll["wire_bytes_by_link"],
                          chips, cm.model_flops,
                          hlo_flops=(cost["flops"] or 0.0) / chips,
                          hlo_bytes=(cost["bytes_accessed"] or 0.0) / chips)
    artifact = {
        "arch": arch, "cell": shape, "mesh": mesh_name, "status": "ok",
        "chips": chips,
        "lower_s": round(t_build, 2), "compile_s": round(cost["trace_s"], 2),
        "memory_analysis": mem,
        "cost_analysis": cost,
        "collectives": coll,
        "cost_model": cm.to_dict(),
        "roofline": roof.to_dict(),
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(summarize(artifact))
    return artifact


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry run of the port on meta tensors (no allocation).")
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=[c.name for c in SHAPES])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have artifacts")
    ap.add_argument("--tag", default="",
                    help="artifact suffix (e.g. opt1) for before/after runs")
    args = ap.parse_args(argv)

    if args.all:
        failures = []
        mesh_name = "multi" if args.multipod else "single"
        for arch in ARCH_NAMES:
            for cell in SHAPES:
                path = os.path.join(args.out,
                                    f"{arch}__{cell.name}__{mesh_name}.json")
                if os.path.exists(path) and not args.force:
                    print(f"CACHED {arch} {cell.name} {mesh_name}")
                    continue
                print(f">>> {arch} {cell.name} {mesh_name}", flush=True)
                try:
                    run_cell(arch, cell.name, args.multipod, args.out)
                except Exception:
                    traceback.print_exc()
                    failures.append((arch, cell.name))
                sys.stdout.flush()
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("ALL CELLS OK")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    run_cell(args.arch, args.shape, args.multipod, args.out, tag=args.tag)


if __name__ == "__main__":
    main()
