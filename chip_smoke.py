#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--scale 20] [--seed 0]

Run from the repository root on a machine with a CUDA card and ``nvcc``.  It
uses neither JAX nor the reference package.  Phases, each fatal on failure:

1. card    — the card's name and power limit, as nvidia-smi gives them;
2. build   — compile the kernels from ``src/repro_torch/csrc`` (seconds and
             the ptxas register lines);
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
             at the shapes of the main path: relative inf-norm error at most
             1e-4 in float32 (hub rows of ~40k terms summed in another
             order, atomics in no fixed order) and 2e-2 in bfloat16;
4. main    — ``repro_torch.sparse(csr) @ x`` for two Graph500-scale R-MAT
             graphs (scale 20, edge factor 16: Graph500 Kronecker a,b,c =
             .57,.19,.19, and uniform .25,.25,.25) at N = 1, 4, 32, 128:
             the selector's pick, the launch counter of the kernel it maps
             to, agreement with the plain "torch" backend, a cache hit with
             new values, and a small graph against a dense float64 product;
             then a GAT attention layer on both graphs,
             ``repro_torch.sparse_chain(csr, a, b, x, alpha=0.125)`` with a,
             b of width d = 64 and N = 1, 32, 128, and
             ``repro_torch.sddmm(csr, a, b)``: K6, K7 and K8 launched,
             agreement with the "torch" backend, empty rows exactly 0, and
             one call with the fuse gate shut (K6, K7, K1); then block-sparse
             attention at full model widths, random Q/K/V from the seed:
             (a) Gemma-3-12B's local layer (``configs/gemma3_12b.py`` with
             ``attn_pattern="block_sparse"``: 16 query heads, 8 KV heads,
             head_dim 256, window 1024 → a causal band of 16 blocks of 64)
             at batch 1, seq 8192, through the model's
             ``_block_sparse_attention`` (no bias: 16 launches each of K7
             and K8); (b) the same layer through
             ``repro_torch.sparse_attention`` with an ALiBi bias
             −2⁻⁶·(i − j) (16 launches each of K9 and K10); (c) a BigBird
             encoder, ``bigbird(4096, 1, 2, 3, block=64)``, 12 heads of
             d = 64 with the bias (K9's merge of the 8-tile global rows);
             each against the "torch" backend on one head, Gemma and BigBird
             through the block design of K9/K10 (the per-design counters),
             a block mask with an empty block row giving rows of exactly 0,
             and one call with ``attn_fuse_min_seq`` above the sequence
             (K6, K9, K1, and no plain version); then the block-granule backend on a
             block-pruned Gemma-3-12B FFN up-projection — W of shape
             (d_ff 15360, d_model 3840), (8, 128) blocks each kept with
             probability 0.25 (numpy ``default_rng(seed)``), kept values
             N(0, 1/3840) — as ``repro_torch.sparse(w, backend="bsr") @ x``
             for X (3840, N) at N = 1, 4, 32, 128 (one K11 launch a call,
             agreement with the "torch" backend, the default "hopper" plan
             and a dense float64 product, a cache hit with new values, a
             second plan at ``bsr_block=(16, 64)``); then the spill path of
             the uniform graph (``spill=True`` in the ``nb_pr`` opts: K5 at
             N = 1, K4 above) against the fused K1/K2, the same opt on the
             Graph500 graph refused (its window is past ``max_win``), and
             ``spmm_as_n_spmv_hopper`` at N = 4 (four K2 launches);
5. times   — per (graph, N): the kernel, its plain version and
             ``torch.sparse.mm`` (cuSPARSE, the paper's baseline) by CUDA
             events, median of 20 runs after a warm-up, beside the bound:
             max(bytes / 3.35 TB/s, 2·nnz·N / 165 TFLOP/s) with bytes =
             12·nnz (8·nnz for ELL) + 4·K·N + 4·M·N; per (graph, transform,
             N) of the chain: K6, K7 and K8 alone, the fused call, the
             unfused pair and the plain version, beside each kernel's bound
             (each input read once, each output written once) and, for K6,
             ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM); per attention
             case, one head: K9 (K7) and K10 (K8) alone, the fused call,
             the unfused pair, the plain version and
             ``scaled_dot_product_attention`` with a dense (S, S) mask
             (boolean, or float holding −inf and the bias), and the whole
             layer's call beside SDPA over all heads; K9 and K10 in both
             designs (block, slot-tile) at the Gemma head in float32 and
             bfloat16 beside SDPA, each design's bound counting the pattern
             bytes it reads (block: 12 B a (block, row) of masks and
             starts, 4 B a block, 16 B a work chunk and 4 B of bias a kept
             entry; slot-tile: 12 B a slab slot); per N of the pruned
             FFN weight: K11, its plain version, the facade's call,
             ``torch.sparse.mm`` on the CSR, ``to_sparse_bsr((8, 128)) @ x``
             where PyTorch takes it, and the dense ``torch.matmul`` of W,
             beside K11's bound: max(bytes / 3.35 TB/s, 2·nblocks·bm·bk·N /
             165 TFLOP/s) with bytes = 4·nblocks·bm·bk + 4·nblocks + 4·(Mb+1)
             + 4·K·N + 4·M·N; per N of the uniform graph's spill path: K4
             (K5) alone, the ``index_add_`` combine, the spill call, the
             fused K1 (K2), the plain version and ``torch.sparse.mm``, each
             bound counting the partials written;
6. summary — one JSON line of the kernels, the card line, then the result.

Without a CUDA device it prints no result and exits 2.  ``--scale`` below 20
runs smaller graphs for a quick look; the graph statistics published with
the slice are checked at scale 20 only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA data sheet (SXM)
#: float32 flops at the 3×TF32 tensor-core rate (495 TFLOP/s TF32 over three
#: products), the fastest route to f32 accuracy; 67 TFLOP/s outside the
#: tensor cores would let a tensor-core kernel beat its "least time"
H100_F32_FLOP_PER_S = 495e12 / 3
H100_BF16_FLOP_PER_S = 989e12   # bfloat16 on the tensor cores (dense)
RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
NS = (1, 4, 32, 128)
GRAPHS = {"g500": (0.57, 0.19, 0.19), "unif": (0.25, 0.25, 0.25)}
#: the selector's pick per (graph, N) at the default thresholds
PICKS = {"g500": {1: "nb_pr", 4: "nb_pr", 32: "nb_sr", 128: "nb_sr"},
         "unif": {1: "nb_pr", 4: "nb_pr", 32: "rs_sr", 128: "rs_sr"}}
#: statistics of the scale-20 graphs (seed 0) from the reference package's
#: host code, which the port's generator must reproduce
STATS_S20 = {"g500": {"nnz": 16086387, "max_row": 39642, "empty_rows": 501549,
                      "span": 6453},
             "unif": {"nnz": 16777094, "max_row": 39, "empty_rows": 0,
                      "span": 39}}
KERNELS = {
    "vsr_spmm": {"route": "cuda", "source": "src/repro_torch/csrc/vsr.cu",
                 "replaces": "src/repro/kernels/vsr.py:141"},
    "vsr_spmv": {"route": "cuda", "source": "src/repro_torch/csrc/spmv.cu",
                 "replaces": "src/repro/kernels/spmv.py:131"},
    "csc_spmm": {"route": "cuda", "source": "src/repro_torch/csrc/csc.cu",
                 "replaces": "src/repro/kernels/csc.py:36"},
    "sddmm": {"route": "cuda", "source": "src/repro_torch/csrc/sddmm.cu",
              "replaces": "src/repro/kernels/fused_chain.py:81"},
    "chain_stats": {"route": "cuda", "source": "src/repro_torch/csrc/chain.cu",
                    "replaces": "src/repro/kernels/fused_chain.py:123"},
    "chain": {"route": "cuda", "source": "src/repro_torch/csrc/chain.cu",
              "replaces": "src/repro/kernels/fused_chain.py:196"},
}
#: the (graph, N) whose times stand for each kernel in the summary line
SUMMARY_SHAPE = {"vsr_spmm": ("g500", 128), "vsr_spmv": ("g500", 1),
                 "csc_spmm": ("unif", 128)}
#: a GAT attention layer: feature width d of the scores, alpha = 1/sqrt(d)
CHAIN_D = 64
CHAIN_ALPHA = 0.125
CHAIN_NS = (1, 32, 128)
#: (graph, transform, N) of the chain's kernel checks and times
CHAIN_CASES = (("g500", "softmax", 1), ("g500", "softmax", 32),
               ("g500", "softmax", 128), ("g500", "identity", 32),
               ("g500", "scale", 32), ("unif", "softmax", 128))
#: the chain case whose times stand for K8 in the summary line
CHAIN_SUMMARY = ("g500", "softmax", 128)
KERNELS.update({
    "attn_stats": {"route": "cuda", "source": "src/repro_torch/csrc/attention.cu",
                   "replaces": "src/repro/kernels/attention.py:43"},
    "attn_chain": {"route": "cuda", "source": "src/repro_torch/csrc/attention.cu",
                   "replaces": "src/repro/kernels/attention.py:112"},
})
#: block-sparse attention: Gemma-3-12B's local layer at prefill, and a
#: BigBird encoder at BigBird-RoBERTa-base widths (12 heads of 64)
ATTN_SEQ = 8192
BIGBIRD = dict(seq=4096, window=1, n_global=2, n_random=3, block=64, seed=0)
BIGBIRD_HEADS, BIGBIRD_D = 12, 64
#: ALiBi slope of the per-edge bias stream (one stream for all heads)
ALIBI_SLOPE = 2.0 ** -6
#: the patterns' shapes at these sizes, from the reference's build_mask
ATTN_STATS = {"gemma": {"nnz": 8097792, "tiles": 15816, "max_row": 1088},
              "bigbird": {"nnz": 2547712, "tiles": 4976, "max_row": 4096}}
#: the head whose output is held against the "torch" backend
CHECK_HEAD = 5
KERNELS.update({
    "bsr_spmm": {"route": "cuda", "source": "src/repro_torch/csrc/bsr.cu",
                 "replaces": "src/repro/kernels/bsr.py:48"},
    "vsr_spmm_spill": {"route": "cuda", "source": "src/repro_torch/csrc/vsr.cu",
                       "replaces": "src/repro/kernels/vsr.py:225"},
    "vsr_spmv_spill": {"route": "cuda", "source": "src/repro_torch/csrc/spmv.cu",
                       "replaces": "src/repro/kernels/spmv.py:35"},
})
#: the block-pruned FFN weight of the "bsr" backend: Gemma-3-12B's
#: up-projection at the default bsr_block, a quarter of the blocks kept
BSR_BLOCK = (8, 128)
BSR_KEEP = 0.25
#: the second plan's block shape, and the small ragged matrix's
BSR_BLOCK_ALT = (16, 64)
#: the N whose times stand for each new kernel in the summary line
BSR_SUMMARY_N, SPILL_SUMMARY_N = 128, {"vsr_spmm_spill": 128, "vsr_spmv_spill": 1}


def pruned_ffn_weight(d_ff: int, d_model: int, seed: int):
    """A block-pruned FFN up-projection W (d_ff, d_model), dense float32:
    each ``BSR_BLOCK`` block kept with probability ``BSR_KEEP``, kept values
    N(0, 1/d_model), all drawn from ``numpy.random.default_rng(seed)``.
    Returns W and the number of kept blocks."""
    bm, bk = BSR_BLOCK
    rng = np.random.default_rng(seed)
    mb, kb = d_ff // bm, d_model // bk
    kept = rng.random((mb, kb)) < BSR_KEEP
    bi, bj = np.nonzero(kept)
    vals = rng.standard_normal((len(bi), bm, bk)) * d_model ** -0.5
    w = np.zeros((mb, bm, kb, bk), np.float32)
    w[bi, :, bj, :] = vals.astype(np.float32)
    return w.reshape(d_ff, d_model), len(bi)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def kernel_of(pick: str, n: int) -> str:
    if pick.startswith("rs_"):
        return "csc_spmm"
    return "vsr_spmv" if n == 1 else "vsr_spmm"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import interop
    from repro_torch.attention import patterns
    from repro_torch.configs import gemma3_12b
    from repro_torch.core import formats, registry, stats
    from repro_torch.core.plan import _stream_to_balanced, execute_attention
    from repro_torch.core.rmat import rmat
    from repro_torch.kernels import (_build, attention, bsr, csc, fused_chain,
                                     launch_counts, reset_launch_counts, spmv,
                                     vsr)
    from repro_torch.models import transformer

    t_start = time.perf_counter()

    def phase(name):
        print(f"[phase] {name} at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def errors(got, want):
        diff = float((got.float() - want.float()).abs().max())
        return diff / max(float(want.float().abs().max()), 1e-30), diff

    def time_ms(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    # -- 1. card ------------------------------------------------------------
    phase("card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # -- 2. build -----------------------------------------------------------
    phase("build")
    built = _build.build()
    _build.lib()
    print(f"[build] {built.path.name}: {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if line.startswith("==") or "registers" in line or "Compiling" in line:
            print(f"[build] {line}")
    sys.stdout.flush()

    # -- the graphs ---------------------------------------------------------
    phase("graphs")
    graphs = {}
    for name, (a, b, c) in GRAPHS.items():
        t0 = time.perf_counter()
        csr = rmat(args.scale, 16, a, b, c, seed=args.seed, device=dev)
        st = stats.matrix_stats(csr)
        span = stats.balanced_tile_span(csr, 512)
        print(f"[graph] {name}_s{args.scale}_e16: M=K={st.m} nnz={st.nnz} "
              f"avg_row={st.avg_row:.2f} cv={st.cv:.2f} max_row={st.max_row} "
              f"empty_rows={st.empty_rows} span={span} "
              f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)
        if args.scale == 20:
            got = {"nnz": st.nnz, "max_row": st.max_row,
                   "empty_rows": st.empty_rows, "span": span}
            if got != STATS_S20[name]:
                fail(f"{name}: graph statistics {got} != {STATS_S20[name]}")
        graphs[name] = csr

    # -- 3. kernels against their plain versions ------------------------------
    phase("kernels")
    max_abs = {k: 0.0 for k in KERNELS}     # over the float32 checks

    def hold(kernel, label, got, want, dtype):
        rel, diff = errors(got, want)
        if dtype == "float32":
            max_abs[kernel] = max(max_abs[kernel], diff)
        ok = rel <= RTOL[dtype]
        print(f"[check] {kernel} {label} {dtype}: rel_inf_err={rel:.3e} "
              f"max_abs_err={diff:.3e} tol={RTOL[dtype]:g} "
              f"{'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"{kernel} {label} {dtype} disagrees with its plain version")

    default_th = repro_torch.SelectorThresholds()
    g500_bal = formats.csr_to_balanced(graphs["g500"], 512)
    unif_bal = formats.csr_to_balanced(graphs["unif"], 512)
    unif_ell = formats.csr_to_ell(graphs["unif"])
    k_dim = graphs["g500"].shape[1]
    for n, dtype in ((4, torch.float32), (32, torch.float32),
                     (128, torch.float32), (32, torch.bfloat16)):
        x = randn(k_dim, n, dtype=dtype)
        hold("vsr_spmm", f"g500 N={n}", vsr.spmm_vsr_fused(g500_bal, x),
             vsr.spmm_vsr_plain(g500_bal, x), str(dtype).split(".")[1])
    for name, bal in (("g500", g500_bal), ("unif", unif_bal)):
        x = randn(k_dim)
        hold("vsr_spmv", f"{name} N=1", spmv.spmv_vsr_fused(bal, x),
             spmv.spmv_vsr_plain(bal, x), "float32")
    for n in (32, 128):
        x = randn(k_dim, n)
        hold("csc_spmm", f"unif N={n}", csc.spmm_csc(unif_ell, x),
             csc.spmm_csc_plain(unif_ell, x), "float32")
    # the spill path on the uniform graph's windows: K5 at N = 1, K4 above,
    # their partials and the combined product
    base, win = vsr.SpillWindows(default_th.max_win)(unif_bal)
    print(f"[check] spill windows unif: n_tiles={unif_bal.n_tiles} win={win}",
          flush=True)
    for n, dtype in ((1, torch.float32), (4, torch.float32),
                     (32, torch.float32), (128, torch.float32),
                     (32, torch.bfloat16)):
        dt = str(dtype).split(".")[1]
        kw = dict(row_base=base, win=win)
        if n == 1:
            x = randn(k_dim, dtype=dtype)
            hold("vsr_spmv_spill", f"unif N=1 partials",
                 spmv.spmv_vsr_partials(unif_bal, x, base, win),
                 vsr.spill_partials_plain(unif_bal, x[:, None], base, win)[..., 0], dt)
            hold("vsr_spmv_spill", "unif N=1", spmv.spmv_vsr(unif_bal, x, **kw),
                 spmv.spmv_vsr_spill_plain(unif_bal, x, **kw), dt)
        else:
            x = randn(k_dim, n, dtype=dtype)
            hold("vsr_spmm_spill", f"unif N={n} partials",
                 vsr.spmm_vsr_partials(unif_bal, x, base, win),
                 vsr.spill_partials_plain(unif_bal, x, base, win), dt)
            hold("vsr_spmm_spill", f"unif N={n}", vsr.spmm_vsr(unif_bal, x, **kw),
                 vsr.spmm_vsr_spill_plain(unif_bal, x, **kw), dt)
        torch.cuda.empty_cache()

    # the chain's kernels: a GAT layer's scores A·Bᵀ, A and B (2^20, 64)
    feats = {name: (0.3 * randn(csr.shape[0], CHAIN_D),
                    0.3 * randn(csr.shape[1], CHAIN_D))
             for name, csr in graphs.items()}
    bals = {"g500": g500_bal, "unif": unif_bal}
    for name, bal in bals.items():
        pat = (bal.rows, bal.cols, *feats[name])
        hold("sddmm", name, fused_chain.sddmm_fused(*pat, shape=bal.shape),
             fused_chain.sddmm_plain(*pat, shape=bal.shape), "float32")
    pat = (g500_bal.rows, g500_bal.cols, *feats["g500"])
    rm, rs = fused_chain.chain_stats_fused(*pat, shape=g500_bal.shape,
                                           alpha=CHAIN_ALPHA)
    pm, ps = fused_chain.chain_stats_plain(*pat, shape=g500_bal.shape,
                                           alpha=CHAIN_ALPHA)
    empty = torch.diff(graphs["g500"].indptr) == 0
    if not ((rm[empty] == -1e30).all() and (rs[empty] == 0).all()):
        fail("chain_stats: empty rows of g500 are not exactly (-1e30, 0)")
    hold("chain_stats", "g500 row max", rm[~empty], pm[~empty], "float32")
    hold("chain_stats", "g500 row sum", rs, ps, "float32")
    del rm, rs, pm, ps
    for name, transform, n, dtype in (
            [case + (torch.float32,) for case in CHAIN_CASES]
            + [("g500", "softmax", 32, torch.bfloat16)]):
        x = randn(k_dim, n, dtype=dtype) if n > 1 else randn(k_dim)
        bal = bals[name]
        kw = dict(shape=bal.shape, transform=transform, alpha=CHAIN_ALPHA)
        pat = (bal.rows, bal.cols, *feats[name], x)
        hold("chain", f"{name} {transform} N={n}",
             fused_chain.chain_fused(*pat, **kw),
             fused_chain.chain_plain(*pat, **kw), str(dtype).split(".")[1])
    # attention with a bias over the GAT graph: the slot-tile design of K9
    # and K10 (the graph keeps ~1/4096 of each 64×64 block it touches, so
    # the routing rule builds no block layout)
    gslab = 0.1 * randn(*g500_bal.rows.shape)
    xg = randn(k_dim, CHAIN_D)
    pat = (g500_bal.rows, g500_bal.cols, *feats["g500"], gslab)
    kw = dict(shape=g500_bal.shape, scale=CHAIN_ALPHA)
    reset_launch_counts()
    gblocks = attention.AttnBlocks()
    rm, rs = attention.attn_stats_fused(*pat, blocks=gblocks, **kw)
    pm, ps = attention.attn_stats_plain(*pat, **kw)
    y = attention.attn_chain_fused(*pat, xg, stats=(pm, ps), blocks=gblocks,
                                   **kw)
    torch.cuda.synchronize()
    ran = {kk: dict(vv) for kk, vv in attention.DESIGN_LAUNCHES.items()}
    print(f"[check] attention g500 d={CHAIN_D}: designs={ran} "
          f"layout={gblocks(g500_bal.rows, g500_bal.cols, g500_bal.shape)}",
          flush=True)
    if ran != {"attn_stats": {"block": 0, "slot": 1},
               "attn_chain": {"block": 0, "slot": 1}}:
        fail(f"attention over g500 did not take the slot-tile design: {ran}")
    hold("attn_stats", f"g500 slot d={CHAIN_D} row max", rm[~empty], pm[~empty],
         "float32")
    hold("attn_stats", f"g500 slot d={CHAIN_D} row sum", rs, ps, "float32")
    hold("attn_chain", f"g500 slot d=N={CHAIN_D}", y,
         attention.attn_chain_plain(*pat, xg, stats=(pm, ps), **kw), "float32")
    torch.cuda.synchronize()
    del g500_bal, unif_bal, unif_ell, bals, pat, gslab, xg, y, rm, rs, pm, ps
    torch.cuda.empty_cache()

    # block-sparse attention: the patterns, a bias stream each, and K9/K10
    # (K7/K8 at d = 256 too) on one head, freed before the next
    gemma = dataclasses.replace(gemma3_12b.CONFIG, attn_pattern="block_sparse")
    attn = {}
    for name, spec in (("gemma", transformer._block_sparse_spec(
                            gemma, ATTN_SEQ, True)),
                       ("bigbird", patterns.bigbird(**BIGBIRD))):
        t0 = time.perf_counter()
        csr = patterns.build_mask(spec).csr
        got = {"nnz": csr.nnz, "tiles": -(-csr.nnz // 512),
               "max_row": int(torch.diff(csr.indptr).max())}
        print(f"[pattern] {name}: {spec} {got} "
              f"({time.perf_counter() - t0:.2f} s on the host)", flush=True)
        if got != ATTN_STATS[name]:
            fail(f"{name}: pattern shape {got} != {ATTN_STATS[name]}")
        csr = csr.to(dev)
        bal = formats.csr_to_balanced(csr, 512)
        bias = torch.from_numpy(interop.alibi_bias(csr, ALIBI_SLOPE)).to(dev)
        attn[name] = {"spec": spec, "csr": csr, "bal": bal, "bias": bias,
                      "slab": _stream_to_balanced(bias, bal),
                      "blocks": attention.AttnBlocks()}
        t0 = time.perf_counter()
        layout = attn[name]["blocks"](bal.rows, bal.cols, csr.shape)
        torch.cuda.synchronize()
        split = int(layout.work[:, 3].sum())
        print(f"[pattern] {name} block layout: {layout.n_blocks} blocks of "
              f"64x64, fill {layout.fill:.4f}, {layout.work.shape[0]} chunks "
              f"({split} of split row blocks), "
              f"{(layout.masks.numel() + layout.starts.numel()) * 4 / 1e6:.2f}"
              f" MB of masks and starts; built in "
              f"{time.perf_counter() - t0:.3f} s (host clock)", flush=True)
    for name, d, dtype in (("gemma", 256, torch.float32),
                           ("gemma", 256, torch.bfloat16),
                           ("bigbird", BIGBIRD_D, torch.float32)):
        a = attn[name]
        dt = str(dtype).split(".")[1]
        q, k, v = (randn(a["spec"].seq, d, dtype=dtype) for _ in range(3))
        pat = (a["bal"].rows, a["bal"].cols, q, k)
        kw = dict(shape=a["csr"].shape, scale=d ** -0.5)
        pm, ps = attention.attn_stats_plain(*pat, a["slab"], **kw)
        yp = attention.attn_chain_plain(*pat, a["slab"], v, stats=(pm, ps), **kw)
        for design in ("block", "slot"):
            dkw = dict(kw, blocks=a["blocks"])
            reset_launch_counts()
            rm, rs = attention._launch_stats(design, *pat, a["slab"], **dkw)
            y = attention._launch_chain(design, *pat, a["slab"], v,
                                        stats=(pm, ps), **dkw)
            torch.cuda.synchronize()
            if (attention.DESIGN_LAUNCHES["attn_stats"][design],
                    attention.DESIGN_LAUNCHES["attn_chain"][design]) != (1, 1):
                fail(f"{name}: the {design} design did not launch "
                     f"({attention.DESIGN_LAUNCHES})")
            hold("attn_stats", f"{name} {design} d={d} row max", rm, pm, dt)
            hold("attn_stats", f"{name} {design} d={d} row sum", rs, ps, dt)
            hold("attn_chain", f"{name} {design} d=N={d}", y, yp, dt)
            del y
        del yp
        if name == "gemma":        # K7 and K8 at the new width d = N = 256
            ckw = dict(shape=a["csr"].shape, alpha=d ** -0.5)
            rm, rs = fused_chain.chain_stats_fused(*pat, **ckw)
            pm, ps = fused_chain.chain_stats_plain(*pat, **ckw)
            hold("chain_stats", f"{name} d={d} row max", rm, pm, dt)
            hold("chain_stats", f"{name} d={d} row sum", rs, ps, dt)
            ckw.update(transform="softmax", stats=(pm, ps))
            hold("chain", f"{name} softmax d=N={d}",
                 fused_chain.chain_fused(*pat, v, **ckw),
                 fused_chain.chain_plain(*pat, v, **ckw), dt)
        del q, k, v, pat, kw, rm, rs, pm, ps
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # K11 on a block-pruned Gemma-3-12B FFN up-projection W (d_ff, d_model),
    # the activations X (d_model, N) as models/layers.py::sparse_matmul
    # computes W·Xᵀ; and on a small ragged matrix with an empty block row
    t0 = time.perf_counter()
    w_dense, w_kept = pruned_ffn_weight(gemma3_12b.CONFIG.d_ff,
                                        gemma3_12b.CONFIG.d_model, args.seed)
    rows_w, cols_w = np.nonzero(w_dense)
    indptr_w = np.zeros(w_dense.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows_w, minlength=w_dense.shape[0]), out=indptr_w[1:])
    w_csr = interop.csr_from_arrays(indptr_w, cols_w, w_dense[rows_w, cols_w],
                                    w_dense.shape, device=dev)
    t_w = time.perf_counter() - t0
    del rows_w, cols_w, indptr_w
    t0 = time.perf_counter()
    w_bsr = formats.csr_to_bsr(w_csr, *BSR_BLOCK)
    torch.cuda.synchronize()
    t_bsr = time.perf_counter() - t0
    d_ff, d_model = w_dense.shape
    max_row_blocks = int(torch.diff(w_bsr.indptr).max())
    print(f"[bsr] gemma3-12b ffn_up W {d_ff}x{d_model} block {BSR_BLOCK}: "
          f"kept {w_kept} of {(d_ff // BSR_BLOCK[0]) * (d_model // BSR_BLOCK[1])} "
          f"blocks, nnz={w_csr.nnz}, up to {max_row_blocks} blocks a block "
          f"row, {w_bsr.blocks.numel() * 4 / 1e6:.1f} MB of f32 blocks; "
          f"W and its CSR {t_w:.2f} s, csr_to_bsr {t_bsr:.3f} s (host clock)",
          flush=True)
    if w_bsr.nblocks != w_kept or w_csr.nnz != w_kept * BSR_BLOCK[0] * BSR_BLOCK[1]:
        fail(f"bsr: {w_bsr.nblocks} blocks and {w_csr.nnz} nonzeros for "
             f"{w_kept} kept blocks")
    w_bsr16 = formats.BSR(w_bsr.indptr, w_bsr.indices, w_bsr.blocks.bfloat16(),
                          w_bsr.shape, w_bsr.block_shape)
    for dtype, wb in ((torch.float32, w_bsr), (torch.bfloat16, w_bsr16)):
        dt = str(dtype).split(".")[1]
        for n in NS:
            x = randn(d_model, n, dtype=dtype) if n > 1 else randn(d_model, dtype=dtype)
            hold("bsr_spmm", f"gemma ffn_up N={n}", bsr.spmm_bsr(wb, x),
                 bsr.spmm_bsr_plain(wb, x), dt)
    del w_bsr16
    rng = np.random.default_rng(args.seed)
    ragged = ((rng.random((203, 333)) < 0.05)
              * rng.standard_normal((203, 333))).astype(np.float32)
    ragged[16:48] = 0.0                 # block rows 1 and 2 of (16, 64) empty
    ragged_bsr = formats.csr_to_bsr(formats.csr_from_dense(ragged, device=dev),
                                    *BSR_BLOCK_ALT)
    for n in (1, 37):
        x = randn(333, n) if n > 1 else randn(333)
        y = bsr.spmm_bsr(ragged_bsr, x)
        if not (y[16:48] == 0).all():
            fail("bsr_spmm: the empty block rows of the ragged matrix are not 0")
        hold("bsr_spmm", f"ragged 203x333 {BSR_BLOCK_ALT} N={n}", y,
             bsr.spmm_bsr_plain(ragged_bsr, x), "float32")
    torch.cuda.synchronize()

    # -- 4. the main path through the facade -----------------------------------
    phase("main")
    launches = {k: 0 for k in KERNELS}
    #: K9/K10 launches by design on the main path
    designs = {kk: {"block": 0, "slot": 0} for kk in attention.DESIGN_LAUNCHES}

    def drive(call):
        """One user call, with the launch counts set to 0 just before and
        read just after."""
        reset_launch_counts()
        y = call()
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            launches[k] += v
        for k, by_design in attention.DESIGN_LAUNCHES.items():
            for design, v in by_design.items():
                designs[k][design] += v
        return y, counts

    for name, csr in graphs.items():
        for n in NS:
            x = randn(csr.shape[1], n) if n > 1 else randn(csr.shape[1])
            t0 = time.perf_counter()
            A = repro_torch.sparse(csr)
            t1 = time.perf_counter()
            pick = A.plan.select(n)
            y, counts = drive(lambda: A @ x)
            t2 = time.perf_counter()
            kernel = kernel_of(pick, n)
            if A.backend != "hopper":
                fail(f"{name} N={n}: backend {A.backend!r}, expected 'hopper'")
            if pick != PICKS[name][n]:
                fail(f"{name} N={n}: selector picked {pick}, expected {PICKS[name][n]}")
            if counts[kernel] < 1:
                fail(f"{name} N={n}: {kernel} was not launched ({counts})")
            if y.shape != ((csr.shape[0], n) if n > 1 else (csr.shape[0],)) \
                    or not torch.isfinite(y).all():
                fail(f"{name} N={n}: output of shape {tuple(y.shape)} is not "
                     "finite or has the wrong shape")
            rel, _ = errors(y, A.matmul(x, backend="torch"))
            # a second matrix on the same pattern: a cache hit, live values
            hits = repro_torch.cache_stats()["hits"]
            B = repro_torch.sparse(formats.CSR(csr.indptr, csr.indices,
                                               randn(csr.nnz), csr.shape))
            y2, counts2 = drive(lambda: B @ x)
            rel2, _ = errors(y2, B.matmul(x, backend="torch"))
            hit = repro_torch.cache_stats()["hits"] == hits + 1 and B.plan is A.plan
            print(f"[main] {name} N={n}: pick={pick} kernel={kernel} "
                  f"launches={counts} rel_err_vs_torch={rel:.3e} "
                  f"sparse_s={t1 - t0:.3f} first_call_s={t2 - t1:.3f} "
                  f"(host clock) | new values: cache_hit={hit} "
                  f"launches={counts2} rel_err={rel2:.3e}", flush=True)
            if max(rel, rel2) > RTOL["float32"]:
                fail(f"{name} N={n}: the main path disagrees with the torch backend")
            if not hit or counts2[kernel] < 1:
                fail(f"{name} N={n}: new values missed the plan cache or the kernel")
    for name, (a, b, c) in GRAPHS.items():
        small = rmat(10, 8, a, b, c, seed=args.seed, device=dev)
        for n in NS:
            x = randn(small.shape[1], n) if n > 1 else randn(small.shape[1])
            y, _ = drive(lambda: repro_torch.sparse(small) @ x)
            want = small.to_dense().double() @ x.double()
            rel, _ = errors(y, want)
            print(f"[main] {name}_s10_e8 N={n}: rel_err_vs_dense_f64={rel:.3e}")
            if rel > RTOL["float32"]:
                fail(f"{name}_s10_e8 N={n}: disagrees with the dense product")
    # the GAT layer: sparse_chain (K7 + K8) and sddmm (K6) through the facade
    for name, csr in graphs.items():
        a, b = feats[name]
        empty = torch.diff(csr.indptr) == 0
        for n in CHAIN_NS:
            x = randn(csr.shape[1], n) if n > 1 else randn(csr.shape[1])
            t0 = time.perf_counter()
            y, counts = drive(lambda: repro_torch.sparse_chain(
                csr, a, b, x, transform="softmax", alpha=CHAIN_ALPHA))
            t1 = time.perf_counter()
            A = repro_torch.sparse(csr, chain_op="softmax")
            if A.backend != "hopper":
                fail(f"chain {name} N={n}: backend {A.backend!r}")
            if counts["chain_stats"] < 1 or counts["chain"] < 1:
                fail(f"chain {name} N={n}: K7/K8 were not launched ({counts})")
            if y.shape != ((csr.shape[0], n) if n > 1 else (csr.shape[0],)) \
                    or not torch.isfinite(y).all():
                fail(f"chain {name} N={n}: output of shape {tuple(y.shape)} "
                     "is not finite or has the wrong shape")
            if name == "g500" and not (y[empty] == 0).all():
                fail(f"chain {name} N={n}: empty rows are not exactly 0")
            rel, _ = errors(y, A.chain(a, b, x, alpha=CHAIN_ALPHA,
                                       backend="torch"))
            print(f"[main] chain {name} softmax N={n}: launches={counts} "
                  f"rel_err_vs_torch={rel:.3e} call_s={t1 - t0:.3f} "
                  "(host clock, plan included)", flush=True)
            if rel > RTOL["float32"]:
                fail(f"chain {name} N={n}: disagrees with the torch backend")
        e, counts = drive(lambda: repro_torch.sddmm(csr, a, b))
        rel, _ = errors(e, repro_torch.sparse(csr).sddmm(a, b, backend="torch"))
        print(f"[main] sddmm {name}: launches={counts} shape={tuple(e.shape)} "
              f"rel_err_vs_torch={rel:.3e}", flush=True)
        if counts["sddmm"] < 1 or e.shape != (csr.nnz,) or rel > RTOL["float32"]:
            fail(f"sddmm {name}: not launched, misshapen or wrong")
    # the fuse gate shut: the unfused pair of the port's own kernels
    csr = graphs["g500"]
    a, b = feats["g500"]
    x = randn(csr.shape[1], 32)
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               chain_fuse_min_n=1 << 30)
    y, counts = drive(lambda: repro_torch.sparse_chain(
        csr, a, b, x, alpha=CHAIN_ALPHA, thresholds=shut))
    rel, _ = errors(y, repro_torch.sparse_chain(csr, a, b, x, alpha=CHAIN_ALPHA))
    print(f"[main] chain g500 softmax N=32, fuse gate shut: launches={counts} "
          f"rel_err_vs_fused={rel:.3e}", flush=True)
    if (counts["sddmm"], counts["chain_stats"], counts["vsr_spmm"],
            counts["chain"]) != (1, 1, 1, 0) or rel > RTOL["float32"]:
        fail("the shut fuse gate did not run K6, K7 and K1 alone, or disagrees")
    # block-sparse attention at full model widths, through the entry points
    # a model and a user call
    rep = gemma.num_heads // gemma.num_kv_heads
    gq = randn(1, gemma.num_heads, ATTN_SEQ, gemma.head_dim)
    gk, gv = (randn(1, gemma.num_kv_heads, ATTN_SEQ, gemma.head_dim)
              for _ in range(2))
    gkr, gvr = gk.repeat_interleave(rep, dim=1), gv.repeat_interleave(rep, dim=1)
    bq, bk, bv = (randn(1, BIGBIRD_HEADS, BIGBIRD["seq"], BIGBIRD_D)
                  for _ in range(3))
    g, bb = attn["gemma"], attn["bigbird"]
    #: name -> (the call, pattern, per-head q/k/v, bias, the kernels it runs)
    attn_cases = {
        "gemma_local": (
            lambda: transformer._block_sparse_attention(gq, gk, gv, gemma, True),
            g, (gq, gkr, gvr), None, ("chain_stats", "chain")),
        "gemma_local_alibi": (
            lambda: repro_torch.sparse_attention(g["spec"], gq, gkr, gvr,
                                                 bias=g["bias"]),
            g, (gq, gkr, gvr), g["bias"], ("attn_stats", "attn_chain")),
        "bigbird_alibi": (
            lambda: repro_torch.sparse_attention(bb["spec"], bq, bk, bv,
                                                 bias=bb["bias"]),
            bb, (bq, bk, bv), bb["bias"], ("attn_stats", "attn_chain")),
    }
    h = CHECK_HEAD
    for cname, (call, a, (q, k, v), bias, kernels) in attn_cases.items():
        t0 = time.perf_counter()
        y, counts = drive(call)
        t1 = time.perf_counter()
        ran = {kk: dict(vv) for kk, vv in attention.DESIGN_LAUNCHES.items()}
        want = {kk: (q.shape[1] if kk in kernels else 0) for kk in counts}
        if counts != want:
            fail(f"attention {cname}: launches {counts}, expected {want}")
        if bias is not None:
            # Gemma's band and BigBird keep most of each 64x64 block they
            # touch: both must take the block design
            want_d = {kk: {"block": q.shape[1], "slot": 0} for kk in ran}
            if ran != want_d:
                fail(f"attention {cname}: designs {ran}, expected {want_d}")
        if y.shape != q.shape or not torch.isfinite(y).all():
            fail(f"attention {cname}: output of shape {tuple(y.shape)} is "
                 "not finite or has the wrong shape")
        ref = repro_torch.sparse_attention(a["spec"], q[0, h], k[0, h],
                                           v[0, h], bias=bias, backend="torch")
        rel, _ = errors(y[0, h], ref)
        print(f"[main] attention {cname}: shape={tuple(y.shape)} "
              f"launches={ {kk: counts[kk] for kk in kernels} } designs={ran} "
              f"rel_err_vs_torch(head {h})={rel:.3e} call_s={t1 - t0:.3f} "
              "(host clock, plan included)", flush=True)
        if rel > RTOL["float32"]:
            fail(f"attention {cname}: disagrees with the torch backend")
        del y, ref
        torch.cuda.empty_cache()
    # a block mask with an empty block row: those rows exactly 0
    bm = patterns.build_mask(g["spec"]).block_mask.copy()
    bm[5, :] = False
    espec = patterns.from_block_mask(bm, ATTN_SEQ, block=64, causal=True)
    ecsr = patterns.build_mask(espec).csr
    empty = (torch.diff(ecsr.indptr) == 0).to(dev)
    ebias = torch.from_numpy(interop.alibi_bias(ecsr, ALIBI_SLOPE)).to(dev)
    q1, k1, v1 = gq[0, h], gkr[0, h], gvr[0, h]
    for b in (None, ebias):
        y, counts = drive(lambda: repro_torch.sparse_attention(espec, q1, k1, v1,
                                                               bias=b))
        rel, _ = errors(y, repro_torch.sparse_attention(espec, q1, k1, v1, bias=b,
                                                        backend="torch"))
        zero = bool((y[empty] == 0).all())
        print(f"[main] attention empty block row, bias={b is not None}: "
              f"{int(empty.sum())} empty rows exactly 0: {zero}; "
              f"rel_err_vs_torch={rel:.3e}", flush=True)
        if not zero or not torch.isfinite(y).all() or rel > RTOL["float32"]:
            fail("attention: an empty block row is not exactly 0, or wrong")
    # the fuse gate shut: K6 → K9 → K1, and never the plain version
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               attn_fuse_min_seq=1 << 30)
    plain_entry = registry.resolve("attn_chain", "torch")
    plain_calls = []

    def counted_plain(*args, **kw):
        plain_calls.append(1)
        return plain_entry.fn(*args, **kw)
    registry.register("attn_chain", "torch", "balanced", counted_plain)
    try:
        y, counts = drive(lambda: repro_torch.sparse_attention(
            g["spec"], q1, k1, v1, bias=g["bias"], thresholds=shut))
    finally:
        registry.register("attn_chain", "torch", "balanced", plain_entry.fn)
    rel, _ = errors(y, repro_torch.sparse_attention(g["spec"], q1, k1, v1,
                                                    bias=g["bias"]))
    ran = {kk: counts[kk] for kk in ("sddmm", "attn_stats", "vsr_spmm",
                                     "attn_chain", "chain_stats", "chain")}
    print(f"[main] attention gemma_local_alibi head {h}, fuse gate shut: "
          f"launches={ran} plain_calls={len(plain_calls)} "
          f"rel_err_vs_fused={rel:.3e}", flush=True)
    if list(ran.values()) != [1, 1, 1, 0, 0, 0] or plain_calls \
            or rel > RTOL["float32"]:
        fail("the shut attention gate did not run K6, K9 and K1 alone, or "
             "disagrees")
    del y, empty
    torch.cuda.empty_cache()

    # the block-granule backend: the pruned FFN weight times N activations
    w_gpu = torch.from_numpy(w_dense).to(dev)
    only_k11 = {kk: int(kk == "bsr_spmm") for kk in KERNELS}
    for n in NS:
        x = randn(d_model, n) if n > 1 else randn(d_model)
        t0 = time.perf_counter()
        W = repro_torch.sparse(w_csr, backend="bsr")
        t1 = time.perf_counter()
        y, counts = drive(lambda: W @ x)
        t2 = time.perf_counter()
        if W.backend != "bsr" or W.plan.bsr_block != BSR_BLOCK:
            fail(f"bsr N={n}: plan {W.backend!r} {W.plan.bsr_block}")
        if counts != only_k11:
            fail(f"bsr N={n}: launches {counts}, expected one of K11 alone")
        if y.shape != ((d_ff, n) if n > 1 else (d_ff,)) or not torch.isfinite(y).all():
            fail(f"bsr N={n}: output of shape {tuple(y.shape)} is not finite "
                 "or has the wrong shape")
        rel_t, _ = errors(y, W.matmul(x, backend="torch"))
        rel_h, _ = errors(y, repro_torch.sparse(w_csr) @ x)
        rel_d, _ = errors(y, w_gpu.double() @ x.double())
        print(f"[main] bsr gemma ffn_up N={n}: launches={counts['bsr_spmm']} "
              f"rel_err_vs_torch={rel_t:.3e} vs_hopper_plan={rel_h:.3e} "
              f"vs_dense_f64={rel_d:.3e} sparse_s={t1 - t0:.3f} "
              f"call_s={t2 - t1:.3f} (host clock; the first call builds the "
              "BSR substrate)", flush=True)
        if max(rel_t, rel_h, rel_d) > RTOL["float32"]:
            fail(f"bsr N={n}: disagrees with the torch backend, the hopper "
                 "plan or the dense product")
    hits = repro_torch.cache_stats()["hits"]
    W2 = repro_torch.sparse(formats.CSR(w_csr.indptr, w_csr.indices,
                                        randn(w_csr.nnz), w_csr.shape),
                            backend="bsr")
    y2, counts = drive(lambda: W2 @ x)
    rel2, _ = errors(y2, W2.matmul(x, backend="torch"))
    hit = repro_torch.cache_stats()["hits"] == hits + 1 and W2.plan is W.plan
    W3 = repro_torch.sparse(w_csr, backend="bsr", bsr_block=BSR_BLOCK_ALT)
    y3, counts3 = drive(lambda: W3 @ x)
    rel3, _ = errors(y3, y)
    print(f"[main] bsr new values: cache_hit={hit} launches={counts['bsr_spmm']} "
          f"rel_err_vs_torch={rel2:.3e} | bsr_block={BSR_BLOCK_ALT}: second "
          f"plan={W3.plan is not W.plan} nblocks="
          f"{W3.plan.substrate('bsr').nblocks} launches={counts3['bsr_spmm']} "
          f"rel_err_vs_{BSR_BLOCK}={rel3:.3e}", flush=True)
    if not hit or counts != only_k11 or rel2 > RTOL["float32"]:
        fail("bsr: new values missed the plan cache or K11, or disagree")
    if W3.plan is W.plan or counts3 != only_k11 or rel3 > RTOL["float32"]:
        fail(f"bsr: bsr_block={BSR_BLOCK_ALT} did not give its own plan, or "
             "disagrees")
    del y, y2, y3, W2, W3
    torch.cuda.empty_cache()
    # the spill path (the fused path's parity reference) on the uniform graph
    unif = graphs["unif"]
    S = repro_torch.sparse(unif, cache=False)
    spill_opts = S.plan.kernel_opts(S.plan.entry("nb_pr"))
    spill_opts["spill"] = True
    F = repro_torch.sparse(unif)
    for n in NS:
        x = randn(unif.shape[1], n) if n > 1 else randn(unif.shape[1])
        kernel = "vsr_spmv_spill" if n == 1 else "vsr_spmm_spill"
        y, counts = drive(lambda: S.matmul(x, impl="nb_pr"))
        rel, _ = errors(y, F.matmul(x, impl="nb_pr"))
        print(f"[main] spill unif N={n}: launches={counts} "
              f"rel_err_vs_fused={rel:.3e}", flush=True)
        if counts != {kk: int(kk == kernel) for kk in KERNELS}:
            fail(f"spill unif N={n}: launches {counts}, expected one {kernel}")
        if y.shape != ((unif.shape[0], n) if n > 1 else (unif.shape[0],)) \
                or not torch.isfinite(y).all() or rel > RTOL["float32"]:
            fail(f"spill unif N={n}: misshapen, not finite or disagrees with "
                 "the fused kernels")
    spill_base, spill_win = spill_opts["windows"](S.plan.substrate("balanced"))
    # g500's empty-row gaps: at scale 20 a tile spans 6,453 rows, a window
    # past max_win, and the spill call must refuse it
    g_win = -(-stats.balanced_tile_span(graphs["g500"], 512) // 8) * 8
    if g_win > default_th.max_win:
        G = repro_torch.sparse(graphs["g500"], cache=False)
        G.plan.kernel_opts(G.plan.entry("nb_pr"))["spill"] = True
        reset_launch_counts()
        refusal = None
        try:
            G.matmul(randn(graphs["g500"].shape[1], 4), impl="nb_pr")
        except ValueError as err:
            refusal = str(err)
        if refusal is None or sum(launch_counts().values()):
            fail(f"spill g500: window {g_win} > max_win was not refused, or "
                 f"launched {launch_counts()}")
        print(f"[main] spill g500 refused: {refusal}", flush=True)
        del G
    else:
        print(f"[main] spill g500: window {g_win} <= max_win at scale "
              f"{args.scale}; no refusal to check", flush=True)
    x4 = randn(unif.shape[1], 4)
    y, counts = drive(lambda: vsr.spmm_as_n_spmv_hopper(
        F.plan.substrate("balanced"), x4))
    rel, _ = errors(y, F.matmul(x4, impl="nb_pr"))
    print(f"[main] spmm_as_n_spmv_hopper unif N=4: launches={counts} "
          f"rel_err_vs_fused={rel:.3e}", flush=True)
    if counts != {kk: 4 * int(kk == "vsr_spmv") for kk in KERNELS} \
            or rel > RTOL["float32"]:
        fail("spmm_as_n_spmv_hopper did not run K2 four times, or disagrees")
    del y
    torch.cuda.empty_cache()
    for k, v in launches.items():
        if v < 1:
            fail(f"{k} was never launched on the main path")
    print(f"[main] launches on the main path: {launches}; K9/K10 by design: "
          f"{designs}", flush=True)

    # -- 5. times ---------------------------------------------------------------
    phase("times")
    rows = {}
    for name, csr in graphs.items():
        m, k_dim = csr.shape
        lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                        size=csr.shape, check_invariants=False)
        for n in NS:
            x = randn(k_dim, n) if n > 1 else randn(k_dim)
            A = repro_torch.sparse(csr)
            pick = A.plan.select(n)
            kernel = kernel_of(pick, n)
            if kernel == "csc_spmm":
                sub = A.plan.substrate("ell")
                run, plain = csc.spmm_csc, csc.spmm_csc_plain
                sub_bytes = 8 * csr.nnz
            else:
                sub = A.plan.substrate("balanced")
                run = vsr.spmm_vsr_fused if n > 1 else spmv.spmv_vsr_fused
                plain = vsr.spmm_vsr_plain if n > 1 else spmv.spmv_vsr_plain
                sub_bytes = 12 * csr.nnz
            t_bytes = (sub_bytes + 4 * k_dim * n + 4 * m * n) / H100_BYTES_PER_S
            t_ops = 2 * csr.nnz * n / H100_F32_FLOP_PER_S
            row = {
                "kernel": kernel, "pick": pick,
                "kernel_ms": time_ms(lambda: run(sub, x)),
                "e2e_ms": time_ms(lambda: A @ x),
                "plain_ms": time_ms(lambda: plain(sub, x)),
                "library_ms": time_ms(lambda: lib_a @ x),
                "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            rows[(name, n)] = row
            print(f"[time] {name}_s{args.scale}_e16 N={n} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        del lib_a
        torch.cuda.empty_cache()

    # the chain: K6, K7, K8 alone, the fused call, the unfused pair, plain
    def bound(nbytes, flops, flop_rate=H100_F32_FLOP_PER_S):
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / flop_rate
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    #: kernel -> (the timed row that stands for it in the summary, its shape)
    summary_rows = {}
    for name, csr in graphs.items():
        m, k_dim = csr.shape
        a, b = feats[name]
        A = repro_torch.sparse(csr, chain_op="softmax")
        bal = A.plan.substrate("balanced")
        slots = bal.rows.numel()
        pat = (bal.rows, bal.cols, a, b)
        feat_bytes = (m + k_dim) * CHAIN_D * a.element_size()
        lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                        size=csr.shape, check_invariants=False)
        b_t = b.t()
        sd_bound = bound(8 * slots + feat_bytes + 4 * slots,
                         2 * csr.nnz * CHAIN_D)
        st_bound = bound(8 * slots + feat_bytes + 8 * m, 2 * csr.nnz * CHAIN_D)
        sddmm_row = {
            "kernel_ms": time_ms(lambda: fused_chain.sddmm_fused(*pat, shape=csr.shape)),
            "plain_ms": time_ms(lambda: fused_chain.sddmm_plain(*pat, shape=csr.shape)),
            "library_ms": time_ms(lambda: torch.sparse.sampled_addmm(
                lib_a, a, b_t, beta=0.0)),
            "bound_ms": sd_bound[0], "bound_by": sd_bound[1]}
        stats_row = {
            "kernel_ms": time_ms(lambda: fused_chain.chain_stats_fused(
                *pat, shape=csr.shape, alpha=CHAIN_ALPHA)),
            "plain_ms": time_ms(lambda: fused_chain.chain_stats_plain(
                *pat, shape=csr.shape, alpha=CHAIN_ALPHA)),
            "library_ms": None, "bound_ms": st_bound[0], "bound_by": st_bound[1]}
        for label, row in (("sddmm", sddmm_row), ("chain_stats", stats_row)):
            print(f"[time] {label} {name}_s{args.scale}_e16 d={CHAIN_D} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        if name == CHAIN_SUMMARY[0]:
            summary_rows["sddmm"] = (sddmm_row, f"{name}_s{args.scale}_e16 d={CHAIN_D}")
            summary_rows["chain_stats"] = (stats_row, f"{name}_s{args.scale}_e16 d={CHAIN_D}")
        del lib_a, b_t
        stats = fused_chain.chain_stats_fused(*pat, shape=csr.shape, alpha=CHAIN_ALPHA)
        for cname, transform, n in CHAIN_CASES:
            if cname != name:
                continue
            x = randn(k_dim, n) if n > 1 else randn(k_dim)
            kw = dict(shape=csr.shape, transform=transform, alpha=CHAIN_ALPHA)
            if transform == "softmax":
                kw["stats"] = stats
            stats_in = 8 * m if transform == "softmax" else 0
            ch_bound = bound(8 * slots + feat_bytes + stats_in
                             + (k_dim + m) * n * x.element_size(),
                             2 * csr.nnz * (CHAIN_D + n))
            row = {
                "kernel_ms": time_ms(lambda: fused_chain.chain_fused(*pat, x, **kw)),
                "plain_ms": time_ms(lambda: fused_chain.chain_plain(*pat, x, **kw)),
                "library_ms": None,
                "bound_ms": ch_bound[0], "bound_by": ch_bound[1],
                "fused_call_ms": time_ms(lambda: A.chain(
                    a, b, x, transform=transform, alpha=CHAIN_ALPHA)),
                "unfused_pair_ms": time_ms(lambda: fused_chain.chain_unfused(
                    *pat, x, shape=csr.shape, transform=transform,
                    alpha=CHAIN_ALPHA)),
                "plain_call_ms": time_ms(lambda: A.chain(
                    a, b, x, transform=transform, alpha=CHAIN_ALPHA,
                    backend="torch")),
            }
            print(f"[time] chain {name}_s{args.scale}_e16 {transform} N={n} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
            if (name, transform, n) == CHAIN_SUMMARY:
                summary_rows["chain"] = (row, f"{name}_s{args.scale}_e16 "
                                               f"{transform} N={n} d={CHAIN_D}")
        del stats
        torch.cuda.empty_cache()

    # block-sparse attention, one head of each case: K9 (K7) and K10 (K8)
    # alone, the fused call, the unfused pair, the plain version and SDPA on
    # a dense mask; then the whole layer's call beside SDPA over all heads
    def dense_mask(csr, bias):
        m = csr.shape[0]
        r = torch.repeat_interleave(torch.arange(m, device=dev),
                                    torch.diff(csr.indptr.long()))
        c = csr.indices.long()
        if bias is None:
            mask = torch.zeros((m, m), dtype=torch.bool, device=dev)
            mask[r, c] = True
        else:
            mask = torch.full((m, m), float("-inf"), device=dev)
            mask[r, c] = bias
        return mask

    def sdpa_ms(q, k, v, mask, reps=20):
        sdpa = torch.nn.functional.scaled_dot_product_attention
        try:
            return time_ms(lambda: sdpa(q, k, v, attn_mask=mask), reps)
        except (RuntimeError, torch.OutOfMemoryError) as err:
            print(f"[time] sdpa failed: {err}", flush=True)
            return None

    for cname, (call, a, (q, k, v), bias, kernels) in attn_cases.items():
        q1, k1, v1 = q[0, h], k[0, h], v[0, h]
        csr, bal = a["csr"], a["bal"]
        m, d, n = csr.shape[0], q1.shape[1], v1.shape[1]
        slots = bal.rows.numel()
        sc = d ** -0.5
        pat = (bal.rows, bal.cols, q1, k1)
        kw = dict(shape=csr.shape)
        if bias is None:
            kw.update(alpha=sc)
            stats_fn = lambda: fused_chain.chain_stats_fused(*pat, **kw)
            stats_plain = lambda: fused_chain.chain_stats_plain(*pat, **kw)
            st = stats_fn()
            ckw = dict(kw, transform="softmax")
            k10 = lambda: fused_chain.chain_fused(*pat, v1, stats=st, **ckw)
            k10_plain = lambda: fused_chain.chain_plain(*pat, v1, stats=st, **ckw)
            unfused = lambda: fused_chain.chain_unfused(*pat, v1, **ckw)
            pattern_bytes, bias_bytes = 8 * slots, 0
        else:
            kw.update(scale=sc)
            pat = pat + (a["slab"],)
            fkw = dict(kw, blocks=a["blocks"])     # the layout built once
            stats_fn = lambda: attention.attn_stats_fused(*pat, **fkw)
            stats_plain = lambda: attention.attn_stats_plain(*pat, **kw)
            st = stats_fn()
            k10 = lambda: attention.attn_chain_fused(*pat, v1, stats=st, **fkw)
            k10_plain = lambda: attention.attn_chain_plain(*pat, v1, stats=st,
                                                           **kw)
            unfused = lambda: attention.attn_unfused(*pat, v1, **fkw)
            # the block design reads the layout (a mask and a start per
            # (block, row), each block's column, the work list), not the
            # slab's (rows, cols), and the bias of the kept entries only
            lay = a["blocks"](bal.rows, bal.cols, csr.shape)
            pattern_bytes = (12 * attention.BLOCK * lay.n_blocks
                             + 4 * lay.n_blocks + 16 * lay.work.shape[0])
            bias_bytes = 4 * csr.nnz
            # the slot-tile design reads the slab's pattern and bias
            slot_bytes = 12 * slots - pattern_bytes - bias_bytes
        p = repro_torch.attention_plan(a["spec"])
        base_bytes = pattern_bytes + bias_bytes + 2 * m * d * 4 + 8 * m
        b9 = bound(base_bytes, 2 * csr.nnz * d)
        b10 = bound(base_bytes + 2 * m * n * 4, 2 * csr.nnz * (d + n))
        mask = dense_mask(csr, bias)
        head = lambda t: t[0, h][None, None]
        y1 = execute_attention(p, q1, k1, v1, bias=bias)
        sd = torch.nn.functional.scaled_dot_product_attention(
            head(q), head(k), head(v), attn_mask=mask)[0, 0]
        sdpa_rel, _ = errors(sd, y1)
        del y1, sd
        reset_launch_counts()
        k9_ms, k10_ms = time_ms(stats_fn), time_ms(k10)
        # the design the timed K9/K10 launches took
        took = {kk: [dd for dd, nn in vv.items() if nn]
                for kk, vv in attention.DESIGN_LAUNCHES.items()}
        if bias is not None and took != {"attn_stats": ["block"],
                                         "attn_chain": ["block"]}:
            fail(f"attention {cname}: the timed K9/K10 took {took}, "
                 "expected the block design")
        row9 = {"kernel_ms": k9_ms,
                "plain_ms": time_ms(stats_plain, reps=3), "library_ms": None,
                "bound_ms": b9[0], "bound_by": b9[1]}
        row10 = {"kernel_ms": k10_ms,
                 "plain_ms": time_ms(k10_plain, reps=3),
                 "library_ms": sdpa_ms(head(q), head(k), head(v), mask),
                 "bound_ms": b10[0], "bound_by": b10[1],
                 "fused_call_ms": time_ms(lambda: execute_attention(
                     p, q1, k1, v1, bias=bias)),
                 "unfused_pair_ms": time_ms(unfused),
                 "plain_call_ms": time_ms(lambda: execute_attention(
                     p, q1, k1, v1, bias=bias, backend="torch"), reps=3),
                 "sdpa_rel_err": sdpa_rel,
                 "layer_call_ms": time_ms(call, reps=3),
                 "layer_sdpa_ms": sdpa_ms(q, k, v, mask, reps=3)}
        if bias is not None:
            # kernel_ms is the routed design's; the slot-tile design beside
            # it, with its own bound
            row9["design"], row10["design"] = (took["attn_stats"][0],
                                               took["attn_chain"][0])
            row9["slot_ms"] = time_ms(lambda: attention._launch_stats(
                "slot", *pat, **fkw), reps=5)
            row9["slot_bound_ms"] = bound(base_bytes + slot_bytes,
                                          2 * csr.nnz * d)[0]
            row10["slot_ms"] = time_ms(lambda: attention._launch_chain(
                "slot", *pat, v1, stats=st, **fkw), reps=5)
            row10["slot_bound_ms"] = bound(
                base_bytes + slot_bytes + 2 * m * n * 4,
                2 * csr.nnz * (d + n))[0]
        shape = (f"{cname} seq={m} d=N={d} head {h} of {q.shape[1]}")
        for label, row in ((kernels[0], row9), (kernels[1], row10)):
            print(f"[time] {label} {shape} "
                  + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        if cname == "gemma_local_alibi":
            summary_rows["attn_stats"] = (row9, shape)
            summary_rows["attn_chain"] = (row10, shape)
            # both designs in bfloat16 at the same head, beside SDPA on the
            # bfloat16 operands and mask; bounds at the bf16 tensor-core rate
            q16, k16, v16 = (t.to(torch.bfloat16) for t in (q1, k1, v1))
            pat16 = (bal.rows, bal.cols, q16, k16, a["slab"])
            st16 = attention.attn_stats_fused(*pat16, **fkw)
            base16 = pattern_bytes + bias_bytes + 2 * m * d * 2 + 8 * m
            runs16 = {
                "attn_stats": (lambda dsg: attention._launch_stats(
                    dsg, *pat16, **fkw), 0, 2 * csr.nnz * d),
                "attn_chain": (lambda dsg: attention._launch_chain(
                    dsg, *pat16, v16, stats=st16, **fkw), 2 * m * n * 2,
                    2 * csr.nnz * (d + n))}
            mask16 = mask.to(torch.bfloat16)
            for label, (run16, yv_bytes, flops) in runs16.items():
                b16 = bound(base16 + yv_bytes, flops, H100_BF16_FLOP_PER_S)
                row = {"block_ms": time_ms(lambda: run16("block")),
                       "slot_ms": time_ms(lambda: run16("slot"), reps=5),
                       "bound_ms": b16[0], "bound_by": b16[1],
                       "slot_bound_ms": bound(base16 + slot_bytes + yv_bytes,
                                              flops, H100_BF16_FLOP_PER_S)[0],
                       "library_ms": (sdpa_ms(q16[None, None], k16[None, None],
                                              v16[None, None], mask16)
                                      if label == "attn_chain" else None)}
                print(f"[time] {label} {cname} bfloat16 seq={m} d=N={d} head "
                      f"{h} " + " ".join(f"{kk}={vv}" for kk, vv in row.items()),
                      flush=True)
            del q16, k16, v16, pat16, st16, mask16
        del st, mask, p
        torch.cuda.empty_cache()

    # K11 on the pruned FFN weight, beside the library calls the port never
    # makes: cuSPARSE on the CSR, PyTorch's BSR where it takes the block, and
    # the dense product of W
    def try_ms(label, fn, reps=20):
        try:
            return time_ms(fn, reps)
        except (RuntimeError, NotImplementedError, TypeError) as err:
            print(f"[time] {label} refused: {type(err).__name__}: "
                  f"{str(err).splitlines()[0][:200]}", flush=True)
            return None

    bm, bk = BSR_BLOCK
    mb = w_bsr.indptr.shape[0] - 1
    lib_w = torch.sparse_csr_tensor(w_csr.indptr, w_csr.indices, w_csr.data,
                                    size=w_csr.shape, check_invariants=False)
    try:
        lib_wb = w_gpu.to_sparse_bsr(BSR_BLOCK)
    except (RuntimeError, NotImplementedError) as err:
        lib_wb = None
        print(f"[time] to_sparse_bsr{BSR_BLOCK} refused: {err}", flush=True)
    W = repro_torch.sparse(w_csr, backend="bsr")
    for n in NS:
        x = randn(d_model, n)
        blk_bound = bound(4 * w_bsr.blocks.numel() + 4 * w_bsr.nblocks
                          + 4 * (mb + 1) + 4 * d_model * n + 4 * d_ff * n,
                          2 * w_bsr.blocks.numel() * n)
        row = {"kernel_ms": time_ms(lambda: bsr.spmm_bsr(w_bsr, x)),
               "plain_ms": time_ms(lambda: bsr.spmm_bsr_plain(w_bsr, x), reps=5),
               "library_ms": time_ms(lambda: lib_w @ x),
               "bound_ms": blk_bound[0], "bound_by": blk_bound[1],
               "e2e_ms": time_ms(lambda: W @ x),
               "bsr_library_ms": (None if lib_wb is None else
                                  try_ms("to_sparse_bsr @ x", lambda: lib_wb @ x)),
               "dense_ms": time_ms(lambda: w_gpu @ x)}
        print(f"[time] bsr_spmm gemma ffn_up {d_ff}x{d_model} N={n} "
              + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        if n == BSR_SUMMARY_N:
            summary_rows["bsr_spmm"] = (row, f"gemma3-12b ffn_up {d_ff}x"
                                         f"{d_model} {BSR_BLOCK} N={n}")
    # K11 with bf16 blocks and activations (bound at the bf16 tensor-core
    # rate), and on the second plan's (16, 64) blocks of the same W
    w_alt = formats.csr_to_bsr(w_csr, *BSR_BLOCK_ALT)
    for label, wb, dtype in (
            ("bf16", formats.BSR(w_bsr.indptr, w_bsr.indices,
                                 w_bsr.blocks.bfloat16(), w_bsr.shape,
                                 w_bsr.block_shape), torch.bfloat16),
            (f"f32 {BSR_BLOCK_ALT}", w_alt, torch.float32)):
        wmb = wb.indptr.shape[0] - 1
        rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_F32_FLOP_PER_S
        for n in NS:
            x = randn(d_model, n, dtype=dtype)
            el = x.element_size()
            b = bound(wb.blocks.element_size() * wb.blocks.numel()
                      + 4 * wb.nblocks + 4 * (wmb + 1) + el * (d_model + d_ff) * n,
                      2 * wb.blocks.numel() * n, rate)
            row = {"kernel_ms": time_ms(lambda: bsr.spmm_bsr(wb, x)),
                   "plain_ms": time_ms(lambda: bsr.spmm_bsr_plain(wb, x), reps=5),
                   "bound_ms": b[0], "bound_by": b[1],
                   "nblocks": wb.nblocks}
            print(f"[time] bsr_spmm gemma ffn_up {label} N={n} "
                  + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
    del lib_w, lib_wb, W, w_alt, wb
    torch.cuda.empty_cache()

    # the spill path on the uniform graph: K4 (K5) alone, the combine, the
    # spill call, the fused kernel, the plain version, cuSPARSE
    m, k_dim = unif.shape
    sbal = S.plan.substrate("balanced")
    lib_a = torch.sparse_csr_tensor(unif.indptr, unif.indices, unif.data,
                                    size=unif.shape, check_invariants=False)
    n_tiles = sbal.n_tiles
    for n in NS:
        x = randn(k_dim, n) if n > 1 else randn(k_dim)
        x2 = x if n > 1 else x[:, None]
        if n == 1:
            kernel = "vsr_spmv_spill"
            run = lambda: spmv.spmv_vsr_partials(sbal, x, spill_base, spill_win)
            fused = lambda: spmv.spmv_vsr_fused(sbal, x)
        else:
            kernel = "vsr_spmm_spill"
            run = lambda: vsr.spmm_vsr_partials(sbal, x, spill_base, spill_win)
            fused = lambda: vsr.spmm_vsr_fused(sbal, x)
        part = run()
        part_bytes = 4 * n_tiles * spill_win * n
        k_bound = bound(12 * unif.nnz + 4 * n_tiles + 4 * k_dim * n + part_bytes,
                        2 * unif.nnz * n)
        c_bound = bound(part_bytes + 4 * n_tiles + 4 * m * n, n_tiles * spill_win * n)
        row = {"kernel_ms": time_ms(run),
               "plain_ms": time_ms(lambda: vsr.spill_partials_plain(
                   sbal, x2, spill_base, spill_win), reps=5),
               "library_ms": time_ms(lambda: lib_a @ x2),
               "bound_ms": k_bound[0], "bound_by": k_bound[1],
               "combine_ms": time_ms(lambda: vsr.spill_combine(part, spill_base, m)),
               "combine_bound_ms": c_bound[0],
               "spill_call_ms": time_ms(lambda: S.matmul(x, impl="nb_pr")),
               "fused_kernel_ms": time_ms(fused)}
        print(f"[time] {kernel} unif_s{args.scale}_e16 N={n} win={spill_win} "
              + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        if n == SPILL_SUMMARY_N[kernel]:
            summary_rows[kernel] = (row, f"unif_s{args.scale}_e16 N={n} "
                                          f"win={spill_win}")
        del part
    del lib_a
    torch.cuda.empty_cache()

    # -- 6. summary ---------------------------------------------------------------
    phase("summary")
    summary = []
    for kernel, meta in KERNELS.items():
        if kernel in SUMMARY_SHAPE:
            name, n = SUMMARY_SHAPE[kernel]
            row = rows[(name, n)]
            shape = f"{name}_s{args.scale}_e16 N={n}"
        else:
            row, shape = summary_rows[kernel]
        summary.append({"name": kernel, **meta, "launches": launches[kernel],
                        "max_abs_err": max_abs[kernel], "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": shape})
        if kernel in designs:
            # the design each launch on the main path took
            summary[-1]["design"] = {dd: nn for dd, nn in
                                     designs[kernel].items() if nn}
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
