#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--scale 20] [--seed 0]

Run from the repository root on a machine with a CUDA card and ``nvcc``.  It
uses neither JAX nor the reference package.  Phases, each fatal on failure:

1. card    — the card's name and power limit, as nvidia-smi gives them;
2. build   — compile the kernels from ``src/repro_torch/csrc`` (seconds and
             the ptxas register lines);
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
             at the shapes of the main path (K1 in both designs, forced: sr
             on the Graph500 graph at N = 32 and 128, pr at N = 4 on both
             graphs, and each at the other's N, pr at 32 and sr at 4, empty
             rows exactly 0; K2 on both graphs; K3 in both designs, forced: sr
             at N = 32 and 128, pr at N = 1 and 4; K7-K10 at the Gemma head in
             both designs, forced; K11 routed and in both designs, forced,
             at the Gemma weight in float32 and bfloat16 and at (16, 64),
             and on a ragged matrix; the slot-tile K7 in full and edge mode
             and K8 alone on the edge statistics on both graphs; K6 in
             both designs, forced, on both graphs: "seq" at d = 1 and 4,
             "par" at d = 64 in float32 and bfloat16 and at d = 256 on
             g500, padding slots exactly 0; K4, K5
             and the spill combine on the uniform graph's windows at N = 1,
             4, 32, 128 and a bfloat16 X at N = 32; the int8 and fp8
             variants of K1, K2, K4 and K5 — value slabs of codes, one f32
             scale a tile — against their plain versions, which decode and
             then run the float math: K1 sr on g500 at N = 32 and 128 and
             at N = 4, where a CTA stages 8 tiles, each with its own scale,
             K1 pr at N = 4 on both graphs, K2 on both graphs, K4 and K5 on
             the uniform graph's windows, float32 and bfloat16 X, empty
             rows exactly 0): relative inf-norm error at most
             1e-4 in float32 (hub rows of ~40k terms summed in another
             order, atomics in no fixed order) and 2e-2 in bfloat16;
4. main    — ``repro_torch.sparse(csr) @ x`` for two Graph500-scale R-MAT
             graphs (scale 20, edge factor 16: Graph500 Kronecker a,b,c =
             .57,.19,.19, and uniform .25,.25,.25) at N = 1, 4, 32, 128:
             the selector's pick, the launch counter of the kernel it maps
             to and the design it took (K1: sr for nb_sr, pr for nb_pr; K3:
             sr for rs_sr), agreement with the plain "torch" backend, a cache hit with
             new values, and a small graph against a dense float64 product;
             then a GAT attention layer on both graphs,
             ``repro_torch.sparse_chain(csr, a, b, x, alpha=0.125)`` with a,
             b of width d = 64 and N = 1, 32, 128, and
             ``repro_torch.sddmm(csr, a, b)``: K6, K7 and K8 launched (K7 in
             edge mode alone, ``fused_chain.STATS_MODES``; K6 in its "par"
             design, ``fused_chain.DESIGN_LAUNCHES``), agreement with
             the "torch" backend, empty rows exactly 0, and one call with the
             fuse gate shut (K6, K7 in full mode, K1 in its sr design); then block-sparse
             attention at full model widths, random Q/K/V from the seed:
             (a) Gemma-3-12B's local layer (``configs/gemma3_12b.py`` with
             ``attn_pattern="block_sparse"``: 16 query heads, 8 KV heads,
             head_dim 256, window 1024 → a causal band of 16 blocks of 64)
             at batch 1, seq 8192, through the model's
             ``_block_sparse_attention`` (no bias: 16 launches each of K7
             and K8, all in the block design); (b) the same layer through
             ``repro_torch.sparse_attention`` with an ALiBi bias
             −2⁻⁶·(i − j) (16 launches each of K9 and K10); (c) a BigBird
             encoder, ``bigbird(4096, 1, 2, 3, block=64)``, 12 heads of
             d = 64 with the bias (K9's merge of the 8-tile global rows);
             each against the "torch" backend on one head, Gemma and BigBird
             through the block design of K7-K10 and the GAT chains through
             the slot-tile design of K7/K8 (the per-design counters),
             a block mask with an empty block row giving rows of exactly 0,
             and one call with ``attn_fuse_min_seq`` above the sequence
             (K6, K9, K1 in its sr design, and no plain version); then the block-granule backend on a
             block-pruned Gemma-3-12B FFN up-projection — W of shape
             (d_ff 15360, d_model 3840), (8, 128) blocks each kept with
             probability 0.25 (numpy ``default_rng(seed)``), kept values
             N(0, 1/3840) — as ``repro_torch.sparse(w, backend="bsr") @ x``
             for X (3840, N) at N = 1, 4, 32, 128 (one K11 launch a call:
             the tensor-core design at N = 32 and 128, the fma design at 1
             and 4, by ``bsr.DESIGN_LAUNCHES``; agreement with the "torch"
             backend, the default "hopper" plan
             and a dense float64 product, a cache hit with new values, a
             second plan at ``bsr_block=(16, 64)``); then the spill path of
             the uniform graph (``spill=True`` in the ``nb_pr`` opts: K5 at
             N = 1, K4 above, each call one launch of it and one of the
             combine kernel) against the fused K1/K2, the same opt on the
             Graph500 graph refused (its window is past ``max_win``), and
             ``spmm_as_n_spmv_hopper`` at N = 4 (four K2 launches);
5. times   — per (graph, N): the kernel, its plain version and
             ``torch.sparse.mm`` (cuSPARSE, the paper's baseline) by CUDA
             events, median of 20 runs after a warm-up, beside the bound:
             max(bytes / 3.35 TB/s, 2·nnz·N / 165 TFLOP/s) with bytes =
             12·nnz (K3: 8·nnz + 4·M, the stored entries and the row
             lengths) + 4·K·N + 4·M·N, K1's row with each design forced
             beside the routed one, K3's row with its design, its lanes a
             row and the X rows it gathers (nnz·N·4 B); on the uniform
             graph K3's pr design forced at N = 1 and 4 beside the pick
             (K2, K1) and ``sparse.mm``, and at N = 32 and 128 the sr
             design in one pass beside its routed column-slab order and K1
             forced (the selector's other side of sr_cv); per (graph, transform,
             N) of the chain: K6, K7 in full mode (and its ratio to K6) and
             in edge mode (with the share of slots in the tiles' first and
             last runs), K8 alone on the edge statistics (and on every row's),
             the fused call, the unfused pair and the plain version, beside
             each kernel's bound
             (each input read once, each output written once) and, for K6,
             ``torch.sparse.sampled_addmm`` (cuSPARSE SDDMM), its design and
             the bytes it gathers (one B row a slot, one A row a run of a
             tile), also at d = 1, 4 and 256 on g500 and at the Gemma head
             (d = 256 on the band); per attention
             case, one head: K9 (K7) and K10 (K8) alone, the fused call,
             the unfused pair, the plain version and
             ``scaled_dot_product_attention`` with a dense (S, S) mask
             (boolean, or float holding −inf and the bias), and the whole
             layer's call beside SDPA over all heads, split into its
             kernels (heads × the pair) and the host work outside them; K7
             and K8 (no bias) and K9 and K10 (ALiBi) in both designs
             (block, slot-tile) at the Gemma head in float32 and bfloat16
             beside SDPA, each design's bound counting the pattern bytes it
             reads (block: 12 B a (block, row) of masks and starts, 4 B a
             block, 16 B a work chunk and 4 B of bias a kept entry;
             slot-tile: 8 B a slab slot, 12 B with the bias); the plan
             key's ``pattern_fingerprint`` alone at Gemma's mask and a
             cached ``attention_plan`` lookup (host clock); per N of the pruned
             FFN weight: K11 with its group layout prebuilt (the layout's
             build time on the host clock and the tensor-core kernel's
             ``-Xptxas -v`` lines printed first), each design forced, its
             plain version, the facade's call, ``torch.sparse.mm`` on the
             CSR, ``to_sparse_bsr((8, 128)) @ x`` where PyTorch takes it, and
             the dense ``torch.matmul`` of W, beside K11's bound:
             max(bytes / 3.35 TB/s, 2·nblocks·bm·bk·N / 165 TFLOP/s) with
             bytes = 4·nblocks·bm·bk + the pattern the routed design reads
             (fma: 4·nblocks + 4·(Mb+1); tensor cores: 4·(groups+1) + 36 B
             an entry of the layout) + 4·K·N + 4·M·N; the same in bfloat16
             (at 989 TFLOP/s) and at (16, 64), beside the dense product in
             that type and ``sparse.mm`` where it takes it; per N of the
             uniform graph's spill path: K4
             (K5) alone, the combine kernel beside its plain version and
             one ``index_add_`` (its library call), the spill call and its
             ratio to ``torch.sparse.mm``, the fused K1 (K2) and the plain
             version, each bound counting the partials written (the
             combine's: the partials read once, Y written once);
6. backward — on both graphs at N = 1, 4, 32, 128, ``loss = (A.with_values(v)
             @ x * gy).sum()`` and ``loss.backward()``: K6 launched once in
             the design N routes to ("seq" at 1 and 4, "par" above) and
             the kernel of the transposed plan's own pick (Aᵀ's statistics
             and picks printed), ``v.grad`` and ``x.grad`` within 1e-4 of the
             reference's ``_coo_bwd`` in plain PyTorch on the card's tensors
             (``coo_bwd_plain``, chunked); times of the backward, K6 alone,
             the SpMM of Aᵀ alone and the rest (glue), beside
             ``sampled_addmm`` plus ``sparse.mm`` on Aᵀ and the sum of the
             two kernels' bounds;
7. train    — one ``SparseFFN`` at Gemma-3-12B's FFN widths (d_model 3840,
             d_ff 15360, ``SparseFFNConfig()``: density 0.1, tile 512,
             swiglu; ~5.9M nonzeros a matrix, patterns from the seed) on
             batch 4 x seq 512 = 2,048 tokens, 5 AdamW steps through
             ``make_train_step`` (lr 1e-3, warmup 2, MSE to a seeded
             target): each step 3 K6 and 6 K1 sr launches (``nb_sr``, the
             pattern entry's route above N = 4), 3 per-pattern
             prep builds over the 5 steps, a falling loss, the first step's
             grads finite, nonzero and within 1e-4 of torch autograd of the
             dense products (TF32 off); times of the step, its split (the
             forward SpMMs, K6, the SpMMs of Aᵀ, the optimizer) and the
             dense step; K1 at N = 2048 in both designs and K6 at d = 2048
             on the gate matrix against their plain versions, ``sparse.mm``
             and ``sampled_addmm``;
8. chain_backward — the GAT layer's backward on both graphs (A, B of width
             64, α = 0.125; softmax at N = 1, 32, 128, identity and scale at
             32): ``(A.chain(a, b, x) * gy).sum().backward()`` launches the
             fused forward, K6 twice (the recompute, ``dW``), K7 in full mode
             (softmax), the plan's SpMV for the row sum and three SpMMs (A,
             Aᵀ twice); dA, dB, dX within 1e-4 of ``chain_bwd_plain`` on the
             card's tensors (chunked); times of the backward on a kept graph,
             median of 20, split into the recompute, ``dW``, the row sum,
             dA, dB, dX and Aᵀ's two permuted streams, beside two
             ``sampled_addmm`` plus three ``sparse.mm`` for the same products
             and the sum of the products' bounds; K7's full mode alone;
9. gat_train — ``repro_torch.examples.train_gat.train`` at scale 20, edge
             factor 16, d_in = d_head = 64, 5 SGD steps: the loss falls;
             the step time (median of steps 2-5, host clock with a sync)
             and the launches a step;
10. attention_backward — Gemma-3-12B's local layer at seq 8192 (16 heads
             of 256, 8 KV heads, the causal band) through
             ``_block_sparse_attention`` forward and backward: a head's K7
             twice and K8 in the block design, K6 twice and 4 SpMMs; head 5's
             dQ within 1e-4 of ``attn_bwd_plain``; one head through
             ``execute_attention`` without and with the ALiBi bias (dQ, dK,
             dV, dBias against the plain backward), its backward split as
             the chain's, beside SDPA forward and backward on the dense mask;
             the layer's backward and forward + backward beside SDPA's over
             all heads;
11. bsr_backward — ``W.with_values(v) @ x`` on the block-pruned Gemma FFN
             up-projection at N = 1, 4, 32, 128, backward: K6 over the CSR
             pattern and K11 on Aᵀ's BSR at (128, 8) (the block transpose,
             as many blocks; the fma design in row chunks), grads within
             1e-4 of ``bsr_bwd_plain``, K11 on Aᵀ against its plain
             version; times split into K6, K11 on Aᵀ and Aᵀ's stream, beside
             the dense ``matmul`` backward (TF32 off) and ``sparse.mm`` on
             Aᵀ;
12. quant  — quantized value streams: ``repro_torch.sparse(csr,
             quant=m) @ x`` for m = int8 and fp8 on both scale-20 graphs
             at N = 1, 4, 32, 128: an ``nb_*`` pick everywhere (K1 sr in
             place of K3 on the uniform graph at N = 32 and 128), one coded
             launch a call and no other (``vsr.VALUE_LAUNCHES`` /
             ``spmv.VALUE_LAUNCHES``), no plain version, agreement with the
             ``"torch"`` backend on the same plan, the codes and scales
             made on the card bit-equal to those made on the CPU from the
             same f32 slab; the spill opt on the quantized uniform plan (K4
             / K5 on codes); a backward through the baked plan (the forward
             coded, dX on Aᵀ's unquantized plan over the decoded stream,
             within 1e-4 of the plain ``_coo_bwd`` on decoded values); and
             ``pattern_matmul(..., quant="int8")`` on the Gemma-3-12B FFN
             gate pattern (15,360 x 3,840, ``SparseFFNConfig()``) at 2,048
             tokens, forward (coded K1 sr) and backward (straight through),
             against the dense products.  Times (CUDA events, median of
             20): the coded kernel and call beside the f32 kernel of the
             same design, the float plan's call, the plain version and
             ``torch.sparse.mm`` on the decoded f32 CSR, with the coded
             bound: 9 B a nonzero (int32 row and column, one code) + 4 B a
             tile + 4·K·N + 4·M·N, against 12 B a nonzero for f32;
13. offline — the offline half of the split: (a) ``calibrate_backend`` on
             ``"hopper"`` over the paper's 27 R-MAT matrices
             (``rmat_suite()``: scales 10/12/14 x edge factors 4/16/64 x
             three skews; each matrix's ELL bytes printed before it is
             built) at N = 1, 4, 32, 128, each (matrix, N, kernel) the mean
             of 10 replays of the builder's call captured in a CUDA graph
             after a warm-up (``tune.Timer``; the timing modes counted and
             printed), every time printed
             with the oracle's, the defaults' and the winner's pick; the
             winning thresholds, their geomean slowdown against the oracle
             and that of the defaults (the paper's "5-12%"), the winner
             saved and reloaded through ``$REPRO_THRESHOLDS``; then the same
             grid search (``calibrate(times=)``) on device time alone: each
             point's call from a full-coverage artifact captured in a CUDA
             graph, the mean of 10 replays; (b) frozen
             ``PlanArtifact``s at full size: ``finalize(n)`` on g500 at N =
             1, 4, 32, 128 (K2, K1 pr, K1 sr) and on the uniform graph at
             32 and 128 (K3 sr), a full-coverage ``finalize()`` on the
             uniform graph (each of the four kernels at N = 32) and the
             Gemma ffn_up's ``"bsr"`` artifact at N = 128 (K11): each
             ``execute(art, x)`` one launch, with the sync guard set to
             error and no substrate or pattern-prep build, bit-equal to
             the builder's ``A @ x`` on every row that one or two tiles hold
             (an NB kernel adds a row of three or more tiles by atomics in
             no fixed order: there within 1e-6) and within 1e-4 of the
             plain version; the call captured in a CUDA graph and replayed
             20 times, each replay held the same way; the builder's call,
             the artifact's call and the graph replay timed (median of 20);
             grads through the artifact (g500 N = 32, the ``"bsr"``
             artifact) within 1e-4 of the builder's, with no host build and
             no sync; (c) ``repro_torch.examples.quickstart.main()``;
14. tune   — ``kernels/tune.py`` on the card, each point timed by
             ``tune.Timer`` (a warm-up call, the call captured in a CUDA
             graph with the sync guard set to error, the mean of
             TUNE_REPEATS replays by CUDA events; a call that syncs or
             builds on the host timed back-to-back and listed): (a)
             ``autotune_geometry`` over ``HOPPER_CANDIDATES`` (tile 128 to
             4096) on both scale-20 graphs at N = 1, 4, 32, 128 on the
             pick's NB kernel (``nb_sr`` forced where the pick is K3), two
             sweeps, the winners compared; the tuned plan's tile, its
             output against the plain version and its call beside the
             default tile 512; (b) ``autotune_quant`` (int8, fp8) on g500 at
             each N on the pick's design, both arms; (c) ``autotune_chain``
             on g500 at d = 64, N = 1, 8, 32, 128 (softmax) and
             ``measure_chain``'s arms for identity and scale; (d)
             ``autotune_attention`` over Gemma-3-12B's local band at seq
             1,024 to 8,192, one head of 256, with the ALiBi bias (K9 +
             K10) and without (K7 + K8), both arms at every seq; (e)
             ``calibrate_backend(tune_geometry=True, tune_quant=True)`` on
             three scale-14 matrices of ``rmat_suite``, saved with the chain
             and attention gates and reloaded through
             ``$REPRO_THRESHOLDS``: ``sparse()`` takes the saved tiles and
             the quant, chain and attention gates act at the saved
             crossovers (the ``demote:*`` counters);
15. guardrails — the guardrails (``core/guardrails.py``) on the card's
             kernels, the one phase that makes kernels fail on purpose: the
             fault matrix (threshold 2, cooldown 0, three failures injected
             at ``kernel_execute:<backend>``) on g500 (K2 at N = 1, K1 sr at
             N = 128) and the Gemma ffn_up on ``"bsr"`` (K11 at N = 128):
             on the card a kernel launches or raises, so three calls raise
             with no launch, each counted as ``kernel_failure`` (no rung
             below runs), then a probe that launches the kernel once and
             closes the breaker; the ``"fault_launch"`` build (K1, K2 and K3
             launched with an illegal block size:
             ``cudaErrorInvalidConfiguration``, a real launch error) raised
             and counted, then the default build's probe recovering;
             sentinels on K1 sr at N = 128 with a NaN in X (raise,
             sanitize, fallback — on the card the same pass as sanitize —
             sanitize in a CUDA graph, raise refused at capture) and their cost on a
             finite X; ``validate="repair"`` on a row-shuffled g500 CSR
             with 1% of its entries split into duplicate halves, hitting
             the clean plan's cache entry with the same output; a corrupted
             cached plan under ``integrity="hit"`` rebuilt; times: the
             eager artifact call with and without the guard (g500 K2 at N =
             1, K1 sr at N = 128, and the host's µs a call on a small
             matrix), ``inspect_csr`` / ``repair_csr`` on g500,
             ``plan_digest`` of a builder and an artifact, a ``sparse()``
             cache miss with and without a published digest, the FFN train
             step with ``skip_nonfinite`` on and off (and one poisoned
             step kept).  It ends with ``HEALTH.reset()``; every other
             phase fails if it leaves a kernel failure, a reroute, a breaker
             skip, a sentinel fallback or a tripped breaker in ``HEALTH``;
16. models — the model layer (``repro_torch.models``) at full width and
             depth: OLMoE-1B-7B (``configs/olmoe_1b_7b.CONFIG``: 16
             layers, d_model 2048, 16 heads, 64 experts top-8 of
             d_ff 1024, vocab 50,304, bf16; 6.9 B parameters, 13.8 GB)
             initialised on the card from the seed; ``Model.prefill`` of
             4 x 512 tokens ("sort" → ``moe_spmm``, capacity 320: each MoE
             layer's dispatch, a (20,480 x 2,048) pattern times X, and
             combine, a (2,048 x 20,481) pattern times H — exactly 32 K1
             sr launches, ``vsr.DESIGN_LAUNCHES``); 16 ``decode_step``s at
             B = 4 on the selector's one-hot path (no kernel) and 4 with
             ``dispatch="spmm"`` forced (K1 sr twice a layer, tile 32);
             checks: (a) one layer's ``moe_apply`` at T = 2,048 on
             "hopper" against "torch" on the card (1e-4 with f32 weights,
             2e-2 in bf16; the router's top-k ids equal), (b) on a 2-layer
             float32 cut at full width (capacity factor 8, so no token
             drops) ``decode_step(prefill(t[:64]))`` against
             ``prefill(t[:65])`` within 2e-2, (c) finite logits at full
             depth, (d) ``loss_fn`` forward and backward on the cut (remat
             by ``torch.utils.checkpoint``) against "torch" within 1e-4,
             K6 once a layer and one transpose a MoE matrix
             (``PATTERN_PREP["builds"]``), (e) no kernel failure or
             reroute (the ``[health]`` line); times beside the card's name
             and power limit: prefill ms and tokens/s, ms a decode step on
             each path, K1 alone on one layer's dispatch and combine (CUDA
             events, with its plain version, ``torch.sparse.mm`` in bf16
             and the bound), the parameter bytes and the phase's seconds;
17. serve  — the serve engine (``repro_torch.serve.ServeEngine``) on
             OLMoE-1B-7B at full width and depth (bf16, weights from the
             seed): (a) ``slots=4, max_len=640, pin_topology=True,
             drift_patience=2``, 8 requests of prompt lengths drawn from
             the seed in 128-512, 16 new tokens each — every request done,
             K1 launched, plan builds and hits, derived topologies, the
             dispatch paths "spmm" (prefill) and "pinned" (decode), no
             kernel failure or reroute; TTFT, tick and decode tokens/s, the
             pinned and one-hot decode group times and the share of tokens
             equal to the sequential oracle's (printed, not bounded: pinned
             lanes decode on their derived topology and bf16 batch shapes
             may flip near-ties); (a') a synchronous engine on two of the
             requests, each prefill's and each pinned step's launches
             counted apart (K1 in both); (c) four requests with every plan
             build failing (``FaultSpec(fail=10)``, ``plan_timeout=0.5``):
             all done through the fallback path, build failures and
             fallback lanes counted, no lane that has decoded misses a
             tick; (b) on the 2-layer float32 cut at full width: the
             synchronous engine's tokens equal the sequential greedy
             oracle's, the async engine's equal the synchronous one's
             (plain and ``pin_topology=True``), and a pinned engine's logits
             equal a ``use_backend("torch")`` engine's within 1e-4; (d)
             Llama-3.2-1B at full width with a block-sparse causal band
             (window 1024, blocks of 64), prompts of 2,048, 2,048, 4,096
             and 4,096 tokens, 8 new each: K7 and K8 on the block design
             (``fused_chain.DESIGN_LAUNCHES``), exactly 2 attention plan
             builds in the engine's cache, TTFT at each length;
18. driver — ``TrainDriver`` on ``examples/train_sparse_lm.py``'s model (6
             layers, d_model 512, sparse FFN at density 0.15: K1 and K6 each
             step) for 8 steps of 8 x 128 tokens, a checkpoint every 4, the
             first try of step 6 failing: the run restarts from step 4, ends
             at step 8, step 0's batch has a lower loss after than before,
             and the last checkpoint restores bit-equal to the final state;
19. families — the SSM, hybrid and audio families at full width and
             depth, bf16 weights from the seed: (a) RWKV-6 3B (32 layers,
             d_model 2,560, 40 heads of 64), prefill 2 x 512 and 16 greedy
             decode steps, finite logits, the cache's bytes the same at
             max_len 640 and 8,192; on its 2-layer f32 cut, prefill(t) vs
             prefill(t[:-1]) + decode_step(t[-1]) within 1e-3 and the
             card's logits within 1e-4 of the CPU's; (b) Zamba2-2.7B (54
             Mamba-2 layers, shared attention every 6), prefill 1 x 2,048
             (full attention) and 16 decode steps; block-sparse (window
             1,024, blocks of 64) at 4,096 tokens: exactly 288 launches
             each of K7 and K8 on the block design (9 shared-attention
             calls x 32 heads), the plan key's fingerprint share; K7 and K8
             alone at one head (d = 80) against their plain versions, timed
             beside SDPA; ``ssd_chunked`` against the ``ssd_decode_step``
             recurrence at H 80, P 64, N 64, chunk 256, 1,024 tokens within
             1e-3; the one-group f32 cut (6 layers) at 1,024 tokens,
             "hopper" against "torch" within 1e-4 and prefill + decode
             against a longer prefill within 2e-2; (c) Whisper-tiny (4 + 4
             layers, d_model 384, 1,500 frames), prefill 4 x 64 and 16
             decode steps; block-sparse f32 (window 256, blocks of 64): K7
             and K8 once a layer, head and lane in the encoder's
             non-causal band and the decoder's prefill, "hopper" against
             "torch" within 1e-4; (d) the serve engine (4 slots, max_len
             640) on (a)'s model, 8 requests of 128-512 tokens, 16 new:
             every request done, TTFT, tick and decode tokens/s; on its f32
             cut and on (b)'s one-group cut (4 requests, 8 new, K7 and K8
             in the prefills) the tokens equal the sequential greedy
             oracle's, async equal to sync;
20. sharded — the sharded backend (``core/shard.py``) on a mesh of 4
             shards that share the card, each shard on a stream of its own
             (``SHARDED``), every result held to the unsharded plan on the
             card within 1e-4 (f32; the ring against the psum within 1e-5),
             each check with its launches a call (the shard's kernel 4
             times) and its times, median of 20: (a) ``sparse(csr,
             mesh=mesh) @ x`` on both scale-20 graphs at N = 1, 4, 32, 128
             (g500 split by nonzeros and psummed: K2, K1 pr / sr; uniform
             split by rows and concatenated: K2, K1 pr, K3 sr), the psum
             or concat alone, the spill inner (K5 + combine on g500 at N =
             1, K4 + combine on the uniform graph at N = 128); (b) the ring
             at N = 512 against the psum, ``autotune_overlap`` at N = 256,
             512 on CUDA-graph replays; (c) the backward at N = 32 (K6 and
             K1 a shard); (d) an int8 plan at N = 128 against the product of
             its decoded values; (e) the GAT softmax chain on both graphs
             (K7 + K8 a shard; nnz split: the statistics merged across the
             shards) and one Gemma-3-12B local head at seq 8,192 (row split,
             a block layout a shard), with a bias refused; (f) one sparse FFN
             layer at Gemma-3-12B's widths through
             ``execute_pattern_sharded``, 5 AdamW steps, each loss within
             1e-4 of the unsharded run's, then the int8 error-feedback
             all-reduce of its gradients on 4 micro-batches over a 4-way
             ``data`` mesh, within 1% (relative L2) of the f32 mean; (g) a
             finalized sharded artifact, no host build and no sync a call;
21. launch — the launch tooling (``repro_torch.launch``), run from a
             temporary working directory: (a) ``launch.train`` at ``--arch
             llama3.2-1b --scale full`` (16 layers, d_model 2,048, bf16,
             weights from the seed), 10 steps of 4 x 256 tokens on the
             card, ``--ckpt-every`` above ``--steps`` (a checkpoint at this
             width, bf16 weights and f32 moments, is ~12.4 GB; the driver
             still writes one at the end): finite losses, the parameter
             count, step ms (median after the first), tokens/s and the
             model-FLOP share ``cost_model.cell_cost(...).model_flops /
             (step s x 989e12)`` beside the card's name and power limit;
             (b) ``launch.train`` at ``--arch olmoe-1b-7b --scale 100m``,
             150 steps of 8 x 256 at ``--lr 1e-3`` (the loss of the
             launcher's synthetic stream rises for ~40 steps after the
             warm-up, then falls): the mean of the last 5 losses below the
             mean of the first 5, K1 launched (the MoE's dispatch and
             combine), ``moe.DISPATCH_PATHS`` of the run; (c) one dry-run cell,
             ``llama3.2-1b train_4k`` on the (data=32, model=8) mesh of meta
             devices, on the card's host: its summary line;
22. tp     — the weight-gathered SPMD runtime (``models/spmd.py``) on a
             (data=2, model=2) mesh whose four positions share the card
             (``TP``), no kernel of K1-K11 on the path of (a)-(c) and
             (e): (a) Llama-3.2-1B at
             full width (bf16, block remat), 3 steps of 4 x 256 at lr 3e-4
             from the params of an unsharded run on the card: each loss
             within 2e-2 (relative) of the unsharded step's, each leaf's
             change and f32 first moment within 2e-2 of their size
             (2-norm) or within twice the error of the floor run, the
             unsharded step in 2 microbatches (bf16 gradients of the row
             halves summed, as the mesh sums them), whichever is larger;
             the
             collective log's bytes a step by kind (position (0, 0)'s
             program) equal to ``dryrun.plan_collectives`` for that mesh
             and shape; step ms, device-busy ms of the last step
             (``torch.profiler``), peak GB; (b) a prefill of 4 x 512 on the
             mesh, the last position's logits within 2e-2 of the unsharded
             prefill's; (c) at the 100m scale, a placed state saved at (2,
             2) restored at (4, 1) and unplaced, both bit-equal to it once
             gathered, and one more step from the restored state bit-equal
             to the step from the state never saved; (d) (a) and (b)
             with a sparse FFN (density 0.15, tile 512: 4,916 tiles a
             matrix, placed 2,458 a ``data`` shard), each shard's K1 and
             K6 on its own piece: K1 1,152 and K6 384 a step and K1 384 a
             prefill, as the per-shard design counts them, the log equal
             to the plan, and a second floor run (the unsharded step with
             its sparse matmuls' tiles over 2 shards of the sharded
             backend); (e) Zamba2-2.7B cut to 12 layers, RWKV-6 3B to 4,
             Whisper-tiny whole, at full width in f32 (``LEAF_TOL`` 1e-3),
             2 steps and a prefill each; every loss within ``RTOL`` or
             twice the floor runs' loss error;
23. summary — one JSON line of the kernels (``launches`` and ``design``:
             the main path's; ``launches_by_path`` and ``design_by_path``:
             every path above; for K1, K2, K4 and K5 ``launches_by_value``,
             and an entry of their own for each coded variant,
             ``<kernel>:int8`` / ``<kernel>:fp8``, whose ``launches`` are
             the quant path's; K1's entry also carries ``models``, one
             OLMoE-1B-7B layer's dispatch and combine, and ``serve``, the
             launches by engine call of (a'); K7's and K8's carry
             ``families``, one Zamba2 head at d = 80; ``launches_by_path``
             has ``sharded`` and ``launch``), the card line, then the
             result.

Without a CUDA device it prints no result and exits 2.  ``--scale`` below 20
runs smaller graphs for a quick look; the graph statistics published with
the slice are checked at scale 20 only.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
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
    # K1: the sr design in vsr.cu, the pr design (K2's warp kernel) in spmv.cu
    "vsr_spmm": {"route": "cuda",
                 "source": "src/repro_torch/csrc/vsr.cu + "
                           "src/repro_torch/csrc/spmv.cu",
                 "replaces": "src/repro/kernels/vsr.py:141"},
    "vsr_spmv": {"route": "cuda", "source": "src/repro_torch/csrc/spmv.cu",
                 "replaces": "src/repro/kernels/spmv.py:131"},
    "csc_spmm": {"route": "cuda", "source": "src/repro_torch/csrc/csc.cu",
                 "replaces": "src/repro/kernels/csc.py:36"},
    "sddmm": {"route": "cuda", "source": "src/repro_torch/csrc/sddmm.cu",
              "replaces": "src/repro/kernels/fused_chain.py:81"},
    # K7/K8: the slot-tile design in chain.cu, the block design (attention
    # patterns) in attention.cu with the bias compiled out
    "chain_stats": {"route": "cuda",
                    "source": "src/repro_torch/csrc/chain.cu + "
                              "src/repro_torch/csrc/attention.cu",
                    "replaces": "src/repro/kernels/fused_chain.py:123"},
    "chain": {"route": "cuda",
              "source": "src/repro_torch/csrc/chain.cu + "
                        "src/repro_torch/csrc/attention.cu",
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
#: the graph whose times stand for K6 in the summary line (K7 and K8 stand
#: for the Gemma head without a bias)
SDDMM_SUMMARY = "g500"
#: K6's widths timed beside d = 64 on g500
SDDMM_WIDTHS = (1, 4, 256)
#: K6's designs forced in the kernels phase: (design, d, type, graphs)
SDDMM_FORCED = (("seq", 1, "float32", ("g500", "unif")),
                ("seq", 4, "float32", ("g500", "unif")),
                ("par", 64, "float32", ("g500", "unif")),
                ("par", 64, "bfloat16", ("g500", "unif")),
                ("par", 256, "float32", ("g500",)))
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
    # the segment sum outside the reference's spill kernels
    "spill_combine": {"route": "cuda", "source": "src/repro_torch/csrc/vsr.cu",
                      "replaces": "src/repro/kernels/vsr.py:285"},
})
#: the block-pruned FFN weight of the "bsr" backend: Gemma-3-12B's
#: up-projection at the default bsr_block, a quarter of the blocks kept
BSR_BLOCK = (8, 128)
BSR_KEEP = 0.25
#: the second plan's block shape, and the small ragged matrix's
BSR_BLOCK_ALT = (16, 64)
#: the N whose times stand for each new kernel in the summary line
BSR_SUMMARY_N, SPILL_SUMMARY_N = 128, {"vsr_spmm_spill": 128, "vsr_spmv_spill": 1,
                                      "spill_combine": 128}


#: the sparse-FFN training steps: one Gemma-3-12B FFN layer at its widths
#: (d_model 3840, d_ff 15360, ``SparseFFNConfig()``: density 0.1, tile 512,
#: swiglu) on batch 4 x seq 512 tokens, five AdamW steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 5
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)
#: the GAT training path (``examples/train_gat.py``) at the GAT cell's
#: width: scale-20 R-MAT with self-loops, d_in = d_head = 64, SGD steps
GAT_STEPS = 5
#: quantized value streams: the modes, and the kernels with coded variants
#: with the TPU kernel each replaces and its quant branch
QUANT_MODES = ("int8", "fp8")
CODED = {"vsr_spmm": ("src/repro/kernels/vsr.py:141", "vsr.py:146-155"),
         "vsr_spmv": ("src/repro/kernels/spmv.py:131", "spmv.py:134-143"),
         "vsr_spmm_spill": ("src/repro/kernels/vsr.py:225", "vsr.py:229-237"),
         "vsr_spmv_spill": ("src/repro/kernels/spmv.py:35", "spmv.py:38-46")}
CODED_KEYS = tuple(f"{k}:{m}" for k in CODED for m in QUANT_MODES)
#: the (graph, N) whose times stand for each coded variant in the summary
CODED_SHAPE = {"vsr_spmm": ("g500", 128), "vsr_spmv": ("g500", 1),
               "vsr_spmm_spill": ("unif", 128), "vsr_spmv_spill": ("unif", 1)}


#: the offline path: the selector's calibration over the paper's 27-matrix
#: R-MAT suite at these N, each point the mean of CAL_REPEATS calls after a
#: warm-up; the frozen artifacts at full size, (graph, N, impl) — g500 at
#: the four N (K2, K1 pr, K1 sr), the uniform graph at N = 32 and 128 (K3
#: sr) — then the uniform graph's full-coverage artifact (each kernel at
#: FULL_N) and the Gemma ffn_up's "bsr" artifact at BSR_ARTIFACT_N (K11)
CAL_NS = (1, 4, 32, 128)
CAL_REPEATS = 10
ARTIFACT_CASES = (("g500", 1), ("g500", 4), ("g500", 32), ("g500", 128),
                  ("unif", 32), ("unif", 128))
FULL_N = 32
BSR_ARTIFACT_N = 128
GRAPH_REPLAYS = 20
#: the tune path (``kernels/tune.py``): each timed point the mean of
#: TUNE_REPEATS CUDA-graph replays; the chain's crossover at the GAT width
#: over TUNE_CHAIN_NS, the attention gate's over Gemma-3-12B's local band at
#: TUNE_ATTN_SEQS, one head of TUNE_ATTN_D
TUNE_REPEATS = 10
TUNE_CHAIN_NS, TUNE_CHAIN_D = (1, 8, 32, 128), 64
TUNE_ATTN_SEQS, TUNE_ATTN_D = (1024, 2048, 4096, 8192), 256


#: the models path: OLMoE-1B-7B (``configs/olmoe_1b_7b.CONFIG``) at full
#: width and depth, weights from the seed on the card; a prefill of
#: MODEL_BATCH x MODEL_SEQ tokens ("sort" → ``moe_spmm``, capacity 320),
#: MODEL_DECODE steps on the selector's path (one-hot at B = 4) and
#: MODEL_DECODE_SPMM with ``dispatch="spmm"`` forced; the float32 checks on
#: a cut of MODEL_CUT layers at CUT_BATCH x CUT_SEQ tokens
MODEL_BATCH, MODEL_SEQ = 4, 512
MODEL_DECODE, MODEL_DECODE_SPMM = 16, 4
MODEL_CUT, CUT_BATCH, CUT_SEQ = 2, 2, 64


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


#: the serve path: OLMoE-1B-7B at full width and depth (bf16, weights from
#: the seed) behind ``ServeEngine(slots=4, max_len=640, pin_topology=True,
#: drift_patience=2)``, SERVE_REQUESTS requests of prompt lengths drawn from
#: the seed in SERVE_PROMPT, SERVE_NEW tokens each; the attribution run
#: (synchronous, two requests) that splits K1 between prefill and pinned
#: decode; the float32 cut (MODEL_CUT layers) for exactness at
#: SERVE_CUT_PROMPT lengths; the faulted run (SERVE_FAULT_REQUESTS); the
#: long-context run: Llama-3.2-1B at full width with a block-sparse causal
#: band (window 1024, blocks of 64) on prompts of LONG_PROMPTS tokens
SERVE = dict(slots=4, max_len=640, requests=8, prompt=(128, 512), new=16,
             attribution_requests=2, attribution_new=4,
             cut_requests=4, cut_prompt=(32, 96), cut_new=8, cut_max_len=128,
             fault_requests=4,
             long_prompts=(2048, 2048, 4096, 4096), long_new=8,
             long_window=1024, long_block=64)
#: the driver path: ``examples/train_sparse_lm.py``'s model (6 layers,
#: d_model 512, sparse FFN at density 0.15) under ``TrainDriver``, steps,
#: the checkpoint period and the step whose first try fails
DRIVER = dict(steps=8, every=4, fail_at=6, batch=8, seq=128)


def serve_phase(ctx, sizes=SERVE):
    """Phase ``serve``: the serve engine of the port on OLMoE-1B-7B at full
    width and depth ((a) timings and counts, (b) exactness on the float32
    cut, (c) faults), then long-context prefill on Llama-3.2-1B ((d)).
    ``ctx`` carries the card's helpers; returns the phase's rows."""
    import torch

    import repro_torch
    from repro_torch.configs import llama3_2_1b, olmoe_1b_7b
    from repro_torch.kernels import launch_counts, vsr
    from repro_torch.models import Model, moe
    from repro_torch.serve import (FaultInjector, FaultSpec, Request,
                                   ServeEngine)

    dev, fail, say = ctx.dev, ctx.fail, ctx.say
    rows = {}
    rng = np.random.default_rng(ctx.seed)
    mcfg = ctx.olmoe if ctx.olmoe is not None else olmoe_1b_7b.CONFIG
    model = Model(mcfg)
    params = model.init(torch.Generator(device=dev).manual_seed(ctx.seed),
                        device=dev)
    n_moe = mcfg.num_layers
    vocab = mcfg.vocab_size
    lo, hi = sizes["prompt"]
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in rng.integers(lo, hi + 1, sizes["requests"])]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def health_moved(m):
        return {k: v for k, v in m["health"]["counters"].items()
                if k.startswith(("kernel_failure:", "kernel_reroute:",
                                 "breaker_skip:", "sentinel_fallback:"))}

    def timed_groups(eng):
        """Wall time of each decode group call by kind (the tick's tokens
        come to the host inside it, so it includes the device's work)."""
        times = {"pinned": [], "onehot": []}
        orig = eng._decode_group

        def group(lanes, *, pinned):
            t0 = time.perf_counter()
            orig(lanes, pinned=pinned)
            times["pinned" if pinned else "onehot"].append(
                time.perf_counter() - t0)
        eng._decode_group = group
        return times

    prefill_alone = []

    def oracle(m_, p_, prompt, n, max_len):
        """The sequential greedy oracle: ``prefill``, then ``decode_step``;
        the prefill's wall time (ending in a sync) goes to
        ``prefill_alone``."""
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, cache = m_.prefill(p_, {"tokens": torch.tensor(
                [prompt], dtype=torch.int32, device=dev)}, max_len)
            want = [int(torch.argmax(logits[0]))]
            prefill_alone.append(time.perf_counter() - t0)
            while len(want) < n:
                logits, cache = m_.decode_step(p_, cache, torch.tensor(
                    [[want[-1]]], dtype=torch.int32, device=dev))
                want.append(int(torch.argmax(logits[0])))
        return want

    # (a) the async engine at full width and depth
    eng = ServeEngine(model, params, slots=sizes["slots"],
                      max_len=sizes["max_len"], pin_topology=True,
                      drift_patience=2)
    groups = timed_groups(eng)
    paths0 = dict(moe.DISPATCH_PATHS)

    def serve_all():
        t0 = time.perf_counter()
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=sizes["new"]))
        done = eng.run_until_done(max_ticks=2000)
        sync()
        return done, time.perf_counter() - t0
    (done, wall), counts = ctx.drive(serve_all, "serve")
    k1 = ctx.took()["vsr_spmm"]
    eng.close()
    m = eng.metrics()
    paths = {k: v - paths0[k] for k, v in moe.DISPATCH_PATHS.items()
             if v != paths0[k]}
    dec_tokens = sum(r.metrics.decode_ticks for r in done)
    dec_s = sum(groups["pinned"]) + sum(groups["onehot"])
    row = {"requests": len(done), "prompt_lens": [len(p) for p in prompts],
           "max_new": sizes["new"], "status": m["requests"],
           "ticks": m["ticks"], "latency": m["latency"],
           "counters": m["counters"], "plan_cache": m["plan_cache"],
           "dispatch_paths": paths, "launches": counts, "k1_designs": k1,
           "decode_tokens": dec_tokens, "decode_s": dec_s,
           "decode_tokens_per_s": dec_tokens / dec_s if dec_s else None,
           "pinned_group_ms_p50": (1e3 * statistics.median(groups["pinned"])
                                   if groups["pinned"] else None),
           "onehot_group_ms_p50": (1e3 * statistics.median(groups["onehot"])
                                   if groups["onehot"] else None),
           "pinned_groups": len(groups["pinned"]),
           "onehot_groups": len(groups["onehot"]),
           "wall_s": wall, "health": health_moved(m),
           "queue_ms": [1e3 * r.metrics.queue_s for r in done],
           "prefill_ms": [1e3 * r.metrics.prefill_s for r in done],
           "ttft_ms": [1e3 * r.metrics.ttft_s for r in done]}
    say("(a) olmoe async engine", row)
    if not all(r.done for r in done) or counts["vsr_spmm"] < 1 or \
            m["plan_cache"]["builds"] < 1 or m["plan_cache"]["hits"] < 1 or \
            m["counters"].get("topologies_derived", 0) < 1 or row["health"] \
            or not paths.get("spmm") or not paths.get("pinned"):
        fail(f"serve (a): {row}")
    rows["a"] = row
    # the tokens of the bf16 full-depth run beside the sequential oracle
    # (pinned lanes decode on their derived topology, not the router's:
    # printed, not bounded)
    agree = total = 0
    for r, p in zip(done, prompts):
        want = oracle(model, params, p, sizes["new"], sizes["max_len"])
        agree += sum(int(a == b) for a, b in zip(r.out, want))
        total += len(want)
    rows["a"]["oracle_agreement"] = agree / total
    say("(a) bf16 tokens equal to the oracle's; each prefill alone (a "
        "sequential call, warm)", {
            "share": agree / total, "tokens": total,
            "prefill_alone_ms": [1e3 * t for t in prefill_alone]})

    # (a') the synchronous engine: K1 in prefill and in pinned decode apart
    eng = ServeEngine(model, params, slots=sizes["slots"],
                      max_len=sizes["max_len"], pin_topology=True,
                      async_prefill=False, async_plans=False)
    split = {"prefill": {}, "pinned": {}, "onehot": {}}

    def counted(kind, fn):
        def call(*args):
            before = launch_counts()
            d0 = {d: n for d, n in vsr.DESIGN_LAUNCHES["vsr_spmm"].items()}
            out = fn(*args)
            sync()
            moved = {k: v - before[k] for k, v in launch_counts().items()
                     if v != before[k]}
            moved["vsr_spmm_sr"] = vsr.DESIGN_LAUNCHES["vsr_spmm"]["sr"] - d0["sr"]
            for k, v in moved.items():
                split[kind][k] = split[kind].get(k, 0) + v
            split[kind]["calls"] = split[kind].get("calls", 0) + 1
            return out
        return call
    eng._prefill = counted("prefill", eng._prefill)
    eng._decode = counted("onehot", eng._decode)
    pinned_step = eng._pinned_decode
    eng._pinned_decode = lambda topo: counted("pinned", pinned_step(topo))

    def attribution():
        for rid, p in enumerate(prompts[:sizes["attribution_requests"]]):
            eng.submit(Request(rid=rid, prompt=p,
                               max_new=sizes["attribution_new"]))
        return eng.run_until_done(max_ticks=200)
    done_s, _ = ctx.drive(attribution, "serve")
    eng.close()
    say("(a') launches by call (synchronous engine)", split)
    if not all(r.done for r in done_s) or \
            split["prefill"].get("vsr_spmm_sr", 0) < 1 or \
            split["pinned"].get("vsr_spmm", 0) < 1:
        fail(f"serve (a'): K1 did not launch in prefill and pinned decode "
             f"{split}")
    rows["launches_by_call"] = split

    # (c) faults: every plan build fails; residents keep their ticks.  A
    # finite burst is not enough: a build whose group changes while it runs
    # (a later prefill joins) is abandoned unpolled, so a burst can be spent
    # on abandoned builds and the last group's build then succeeds
    faults = FaultInjector({"plan_build": FaultSpec(fail=10_000)},
                           seed=ctx.seed)
    eng = ServeEngine(model, params, slots=sizes["slots"],
                      max_len=sizes["max_len"], pin_topology=True,
                      faults=faults, plan_timeout=0.5)
    reqs = [Request(rid=rid, prompt=p, max_new=sizes["new"])
            for rid, p in enumerate(prompts[:sizes["fault_requests"]])]

    def faulted():
        for r in reqs:
            eng.submit(r)
        missed = []
        while eng.pending() and eng.ticks < 2000:
            before = {r.rid: len(r.out) for r in reqs
                      if r.status == "active" and r.metrics.decode_ticks}
            eng.tick()
            missed += [rid for rid, n in before.items()
                       if not reqs[rid].done and len(reqs[rid].out) != n + 1]
        eng.run_until_done(max_ticks=2000)
        sync()
        return missed
    missed, counts_c = ctx.drive(faulted, "serve")
    eng.close()
    m = eng.metrics()
    row = {"status": m["requests"], "counters": m["counters"],
           "faults": m["faults"], "missed_ticks": missed,
           "fallback_ticks": [r.metrics.fallback_ticks for r in reqs],
           "wait_ticks": [r.metrics.wait_ticks for r in reqs],
           "launches": counts_c, "health": health_moved(m)}
    say("(c) plan builds failing", row)
    if not all(r.done for r in reqs) or missed or row["health"] or \
            m["counters"].get("plan_build_failures", 0) < 1 or \
            m["counters"].get("plan_fallback_lanes", 0) < 1:
        fail(f"serve (c): {row}")
    rows["c"] = row

    # (b) exactness on the float32 cut of the same width
    cut = mcfg.scaled(num_layers=ctx.cut_layers, param_dtype="float32",
                      compute_dtype="float32",
                      moe=dataclasses.replace(mcfg.moe, capacity_factor=8.0))
    cut_model = Model(cut)
    cp = {k: v.float() for k, v in params.items() if k != "blocks"}
    cp["blocks"] = {g: {k: v[:ctx.cut_layers].float() for k, v in grp.items()}
                    for g, grp in params["blocks"].items()}
    del params, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lo, hi = sizes["cut_prompt"]
    cut_prompts = [rng.integers(0, vocab, int(n)).tolist()
                   for n in rng.integers(lo, hi + 1, sizes["cut_requests"])]

    def serve_cut(backend=None, spy=False, **kw):
        eng = ServeEngine(cut_model, cp, slots=sizes["slots"],
                          max_len=sizes["cut_max_len"], **kw)
        seen = []
        if spy:
            def record(fn):
                def call(*args):
                    logits, cache = fn(*args)
                    seen.append(logits.float())
                    return logits, cache
                return call
            eng._prefill = record(eng._prefill)
            eng._decode = record(eng._decode)
            pinned_step = eng._pinned_decode
            eng._pinned_decode = lambda topo: record(pinned_step(topo))
        scope = (repro_torch.use_backend(backend) if backend
                 else contextlib.nullcontext())
        with scope:
            for rid, p in enumerate(cut_prompts):
                eng.submit(Request(rid=rid, prompt=p, max_new=sizes["cut_new"]))
            done = eng.run_until_done(max_ticks=500)
        eng.close()
        if not all(r.done for r in done):
            fail(f"serve (b): a request of the cut did not finish "
                 f"{[(r.rid, r.status) for r in done]}")
        return {r.rid: list(r.out) for r in done}, seen, eng.metrics()

    sync_kw = dict(async_prefill=False, async_plans=False)
    (tok_sync, _, _), counts_b = ctx.drive(lambda: serve_cut(**sync_kw),
                                           "serve")
    tok_async, _, _ = serve_cut()
    want = {rid: oracle(cut_model, cp, p, sizes["cut_new"], sizes["cut_max_len"])
            for rid, p in enumerate(cut_prompts)}
    tok_pin, logits_h, m_h = serve_cut(spy=True, pin_topology=True, **sync_kw)
    tok_pin_t, logits_t, m_t = serve_cut("torch", spy=True, pin_topology=True,
                                         **sync_kw)
    tok_pin_async, _, m_pa = serve_cut(pin_topology=True)
    rel = max((ctx.errors(a, b)[0] for a, b in zip(logits_h, logits_t)),
              default=float("inf"))
    row = {"prompt_lens": [len(p) for p in cut_prompts],
           "sync_equals_oracle": tok_sync == want,
           "async_equals_sync": tok_async == tok_sync,
           "pinned_hopper_equals_torch": tok_pin == tok_pin_t,
           "pinned_async_equals_sync": tok_pin_async == tok_pin,
           "logit_calls": [len(logits_h), len(logits_t)],
           "logits_rel_err_vs_torch": rel,
           "topologies_derived": m_pa["counters"].get("topologies_derived"),
           "plan_builds": m_pa["plan_cache"]["builds"],
           "launches_sync": counts_b}
    say(f"(b) {ctx.cut_layers}-layer f32 cut, tol {ctx.rtol:g}", row)
    if not (row["sync_equals_oracle"] and row["async_equals_sync"]
            and row["pinned_hopper_equals_torch"]
            and row["pinned_async_equals_sync"]) \
            or len(logits_h) != len(logits_t) or rel > ctx.rtol \
            or row["topologies_derived"] != len(cut_prompts) \
            or row["plan_builds"] < 1:
        fail(f"serve (b): {row}")
    rows["b"] = row
    del cp, cut_model, logits_h, logits_t
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (d) long context: block-sparse prefill on the block design of K7/K8
    lcfg = (ctx.llama if ctx.llama is not None else llama3_2_1b.CONFIG).scaled(
        attn_pattern="block_sparse", window=sizes["long_window"],
        attn_block=sizes["long_block"])
    lmodel = Model(lcfg)
    lparams = lmodel.init(torch.Generator(device=dev).manual_seed(ctx.seed),
                          device=dev)
    long_prompts = [rng.integers(0, lcfg.vocab_size, n).tolist()
                    for n in sizes["long_prompts"]]
    eng = ServeEngine(lmodel, lparams, slots=sizes["slots"],
                      max_len=max(sizes["long_prompts"]) + sizes["long_new"])

    def serve_long():
        for rid, p in enumerate(long_prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=sizes["long_new"]))
        done = eng.run_until_done(max_ticks=500)
        sync()
        return done
    done_l, counts_d = ctx.drive(serve_long, "serve")
    designs = {k: v for k, v in ctx.took().items()
               if k in ("chain_stats", "chain")}
    eng.close()
    m = eng.metrics()
    # each length's prefill alone (warm, ending in a sync) beside the plan
    # key's fingerprint, which every layer call pays (ROADMAP item 0)
    from repro_torch.attention.module import _spec_csr
    from repro_torch.core.cache import pattern_fingerprint
    from repro_torch.models.transformer import _block_sparse_spec
    alone = {}
    for n in sorted(set(sizes["long_prompts"])):
        toks = torch.tensor([long_prompts[sizes["long_prompts"].index(n)]],
                            dtype=torch.int32, device=dev)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            with torch.no_grad():
                lmodel.prefill(lparams, {"tokens": toks}, n)
            sync()
            walls.append(time.perf_counter() - t0)
        csr = _spec_csr(_block_sparse_spec(lcfg, n, True), dev)
        fps = []
        for _ in range(3):
            t0 = time.perf_counter()
            pattern_fingerprint(csr)
            fps.append(time.perf_counter() - t0)
        fp_ms = 1e3 * statistics.median(fps)
        alone[n] = {"prefill_ms": 1e3 * min(walls), "nnz": csr.nnz,
                    "fingerprint_ms": fp_ms,
                    "fingerprint_share": lcfg.num_layers * fp_ms
                    / (1e3 * min(walls))}
    ttft = {}
    for r in done_l:
        ttft.setdefault(len(r.prompt), []).append(1e3 * r.metrics.ttft_s)
    row = {"prompt_lens": list(sizes["long_prompts"]),
           "status": m["requests"], "plan_cache": m["plan_cache"],
           "launches": counts_d, "designs": designs,
           "ttft_ms_by_len": ttft, "prefill_alone": alone,
           "ticks": m["ticks"],
           "latency": m["latency"], "health": health_moved(m)}
    say("(d) long-context prefill", row)
    if not all(r.done for r in done_l) or m["plan_cache"]["builds"] != 2 \
            or designs["chain_stats"]["block"] < 1 \
            or designs["chain"]["block"] < 1 or row["health"]:
        fail(f"serve (d): {row}")
    rows["d"] = row
    del lparams, lmodel
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def driver_phase(ctx, sizes=DRIVER):
    """Phase ``driver``: ``TrainDriver`` on ``train_sparse_lm``'s model,
    a failure at ``fail_at`` rolled back to the last checkpoint; the final
    state restored bit for bit."""
    import tempfile

    import torch

    from repro_torch.examples import train_sparse_lm

    dev, fail, say = ctx.dev, ctx.fail, ctx.say
    armed = [True]

    def hook(step):
        if step == sizes["fail_at"] and armed[0]:
            armed[0] = False
            raise RuntimeError("injected failure")

    with tempfile.TemporaryDirectory() as ckdir:
        def run():
            return train_sparse_lm.train(
                steps=sizes["steps"], batch=sizes["batch"], seq=sizes["seq"],
                device=dev, checkpoint_every=sizes["every"],
                checkpoint_dir=ckdir, failure_hook=hook, seed=ctx.seed)
        (driver, model, batch_fn, initial, final), counts = ctx.drive(
            run, "driver")
        latest = driver.ckpt.latest_step()
        back = driver.ckpt.restore(latest, like=final)

        def equal(a, b):
            if isinstance(a, dict):
                return set(a) == set(b) and all(equal(a[k], b[k]) for k in a)
            return a.dtype == b.dtype and a.device == b.device \
                and torch.equal(a, b)
        restored_equal = equal(back, final)
    with torch.no_grad():
        before, _ = model.loss_fn(initial["params"], batch_fn(0))
        after, _ = model.loss_fn(final["params"], batch_fn(0))
    steps = [e.step for e in driver.events]
    walls = [e.wall for e in driver.events]
    row = {"steps": steps, "restarts": driver.restarts,
           "final_step": int(final["opt"]["step"]),
           "latest_checkpoint": latest,
           "losses": [e.metrics["loss"] for e in driver.events],
           "batch0_loss_before": float(before),
           "batch0_loss_after": float(after),
           "step_ms_median": 1e3 * statistics.median(walls[1:]),
           "first_step_ms": 1e3 * walls[0],
           "stragglers": driver.straggler_events,
           "restored_bit_equal": restored_equal, "launches": counts,
           "k1_designs": ctx.took()["vsr_spmm"]}
    say("train_sparse_lm under TrainDriver", row)
    # steps up to the failure, then again from the last checkpoint
    restart = sizes["fail_at"] // sizes["every"] * sizes["every"]
    want_steps = (list(range(sizes["fail_at"]))
                  + list(range(restart, sizes["steps"])))
    if steps != want_steps or driver.restarts != 1 or \
            row["final_step"] != sizes["steps"] or not restored_equal or \
            not float(after) < float(before) or counts["vsr_spmm"] < 1 or \
            counts["sddmm"] < 1:
        fail(f"driver: {row}")
    return row


#: the families path: RWKV-6 3B, Zamba2-2.7B and Whisper-tiny at full
#: width and depth (bf16, weights from the seed), each freed before the
#: next.  (a) RWKV-6: prefill rwkv_batch x rwkv_seq, ``decode`` greedy
#: steps; the f32 cut of rwkv_cut_layers for the state handoff and the CPU
#: equality; (b) Zamba2: prefill zamba_seq as published (full attention),
#: ``decode`` steps; block-sparse shared attention (window, block) at
#: zamba_sparse_seq; the SSD scan at the full head shapes ``ssd``; the
#: one-group f32 cut (zamba_cut_layers) at zamba_cut_seq; (c) Whisper:
#: frames (whisper_batch, num_frames, d_model), prefill whisper_seq,
#: ``decode`` steps, block-sparse in f32 (whisper_window, block); (d) the
#: serve engine on (a)'s model (slots, max_len, ``requests`` prompts in
#: ``prompt``, ``new`` tokens), on its f32 cut, and on (b)'s f32 cut
#: (cut_requests, cut_new)
FAMILIES = dict(rwkv_batch=2, rwkv_seq=512, decode=16, rwkv_cut_layers=2,
                rwkv_cut_seq=128, rwkv_long_len=8192,
                zamba_seq=2048, zamba_sparse_seq=4096, window=1024, block=64,
                ssd=dict(seq=1024, heads=80, head_dim=64, state=64, chunk=256),
                zamba_cut_layers=6, zamba_cut_seq=1024,
                whisper_batch=4, whisper_seq=64, whisper_window=256,
                slots=4, max_len=640, requests=8, prompt=(128, 512), new=16,
                cut_requests=4, cut_new=8)


def families_phase(ctx, sizes=FAMILIES):
    """Phase ``families``: the SSM, hybrid and audio models of the port at
    full width and depth, their exactness on float32 cuts, K7/K8 at
    Zamba2's head width (d = 80) and under Whisper's non-causal encoder
    mask, and the serve engine on the RWKV-6 and Zamba2 caches.  ``ctx``
    carries the card's helpers; returns the phase's rows."""
    import torch

    import repro_torch
    from repro_torch.attention.module import _spec_csr
    from repro_torch.configs import rwkv6_3b, whisper_tiny, zamba2_2_7b
    from repro_torch.core import formats
    from repro_torch.core.cache import pattern_fingerprint
    from repro_torch.kernels import fused_chain
    from repro_torch.kernels.blocks import BLOCK, AttnBlocks
    from repro_torch.models import Model, ssm
    from repro_torch.models import params as model_params
    from repro_torch.models.transformer import _block_sparse_spec
    from repro_torch.serve import Request, ServeEngine

    dev, fail, say = ctx.dev, ctx.fail, ctx.say
    rows = {}
    rng = np.random.default_rng(ctx.seed)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    f32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def walled(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        else:
            yield tree

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))

    def tree_map(fn, tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v) for k, v in tree.items()}
        return fn(tree)

    def rel(got, want):
        return ctx.errors(got, want)[0]

    def health_moved(m):
        return {k: v for k, v in m["health"]["counters"].items()
                if k.startswith(("kernel_failure:", "kernel_reroute:",
                                 "breaker_skip:", "sentinel_fallback:"))}

    def decode_run(model, params, logits, caches, steps):
        """``steps`` greedy decode steps from ``logits``: the last logits,
        the caches and each step's wall time (ending in a sync)."""
        walls = []
        for _ in range(steps):
            tok = logits.argmax(-1, keepdim=True)
            (logits, caches), w = walled(
                lambda: model.decode_step(params, caches, tok))
            walls.append(w)
        return logits, caches, walls

    def oracle(model, params, prompt, n, max_len):
        """The sequential greedy oracle: ``prefill``, then ``decode_step``."""
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": torch.tensor(
                [prompt], dtype=torch.int32, device=dev)}, max_len)
            want = [int(torch.argmax(logits[0]))]
            while len(want) < n:
                logits, cache = model.decode_step(params, cache, torch.tensor(
                    [[want[-1]]], dtype=torch.int32, device=dev))
                want.append(int(torch.argmax(logits[0])))
        return want

    def serve(model, params, prompts, new, *, max_len, label, **kw):
        """Serve ``prompts`` (``new`` tokens each) on a fresh engine, driven
        as one call; returns (tokens by rid, metrics, launches, the decode
        groups' wall times)."""
        eng = ServeEngine(model, params, slots=sizes["slots"],
                          max_len=max_len, **kw)
        groups = []
        orig = eng._decode_group

        def group(lanes, *, pinned):
            t0 = time.perf_counter()
            orig(lanes, pinned=pinned)
            groups.append(time.perf_counter() - t0)
        eng._decode_group = group

        def run():
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_new=new))
            done = eng.run_until_done(max_ticks=2000)
            sync()
            return done
        done, counts = ctx.drive(run, "families")
        eng.close()
        m = eng.metrics()
        if not all(r.done for r in done) or health_moved(m):
            fail(f"families (d) {label}: {[(r.rid, r.status) for r in done]} "
                 f"{health_moved(m)}")
        return {r.rid: list(r.out) for r in done}, m, counts, groups, done

    # ---- (a) RWKV-6 3B at full width and depth ----------------------------
    cfg = ctx.rwkv if ctx.rwkv is not None else rwkv6_3b.CONFIG
    model = Model(cfg)
    (params, init_s) = walled(lambda: model.init(
        torch.Generator(device=dev).manual_seed(ctx.seed), device=dev))
    b, s, steps = sizes["rwkv_batch"], sizes["rwkv_seq"], sizes["decode"]
    max_len = sizes["max_len"]
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), device=dev,
                         generator=gen)
    with torch.no_grad():
        ((logits, caches), first_s), counts = ctx.drive(lambda: walled(
            lambda: model.prefill(params, {"tokens": toks[:, :s]}, max_len)),
            "families")
        _, pre_s = walled(lambda: model.prefill(params, {"tokens": toks[:, :s]},
                                                max_len))
        ok_prefill = bool(torch.isfinite(logits).all())
        logits, caches, dec = decode_run(model, params, logits, caches, steps)
    cache_bytes = {n: nbytes(model.init_cache(b, n, device="meta"))
                   for n in (max_len, sizes["rwkv_long_len"])}
    row = {"config": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "heads": cfg.num_heads,
           "param_count": model_params.param_count(model.specs),
           "param_bytes": model_params.param_bytes(model.specs),
           "init_on_card_s": init_s, "batch": b, "seq": s,
           "first_prefill_ms": 1e3 * first_s, "prefill_ms": 1e3 * pre_s,
           "prefill_tokens_per_s": b * s / pre_s,
           "decode_step_ms": 1e3 * statistics.median(dec[1:]),
           "first_decode_step_ms": 1e3 * dec[0],
           "decode_tokens_per_s": b / statistics.median(dec[1:]),
           "cache_bytes": nbytes(caches),
           "cache_bytes_by_max_len": cache_bytes,
           "cache_bytes_per_lane": nbytes(caches) / b,
           "launches": {k: v for k, v in counts.items() if v}}
    say("(a) rwkv6-3b prefill and decode", row)
    if not ok_prefill or not bool(torch.isfinite(logits).all()) or \
            int(caches["length"]) != s + steps or \
            len(set(cache_bytes.values())) != 1 or \
            row["cache_bytes"] != cache_bytes[max_len]:
        fail(f"families (a): {row}")
    rows["a"] = row

    # the f32 cut at full width: the state handoff and the CPU's logits
    n_cut = sizes["rwkv_cut_layers"]
    cut = cfg.scaled(num_layers=n_cut, **f32)
    cut_model = Model(cut)
    cp = {k: v.float() for k, v in params.items() if k != "blocks"}
    cp["blocks"] = {k: v[:n_cut].float() for k, v in params["blocks"].items()}
    t = toks[:, :sizes["rwkv_cut_seq"] + 1]
    with torch.no_grad():
        lp, _ = cut_model.prefill(cp, {"tokens": t}, 2 * t.shape[1])
        _, c = cut_model.prefill(cp, {"tokens": t[:, :-1]}, 2 * t.shape[1])
        ld, _ = cut_model.decode_step(cp, c, t[:, -1:])
        cpu = torch.device("cpu")
        (lc, _), cpu_s = walled(lambda: cut_model.prefill(
            tree_map(lambda v: v.to(cpu), cp), {"tokens": t.to(cpu)},
            2 * t.shape[1]))
    check = {"layers": n_cut, "seq": t.shape[1],
             "stream_max_abs_err": float((lp - ld).abs().max()),
             "card_vs_cpu_rel_err": rel(lp, lc.to(dev)),
             "cpu_prefill_s": cpu_s}
    print(f"[check] families (a) rwkv6 {n_cut}-layer f32 cut: prefill(t) vs "
          f"prefill(t[:-1]) + decode_step(t[-1]) and the card vs the CPU "
          f"{json.dumps(check)} tol 1e-3 (abs) / {ctx.rtol:g}", flush=True)
    if check["stream_max_abs_err"] > 1e-3 or \
            check["card_vs_cpu_rel_err"] > ctx.rtol:
        fail(f"families (a) cut: {check}")
    rows["a"]["cut"] = check
    del lp, ld, lc, c

    # ---- (d) the serve engine on RWKV-6, full and on the f32 cut ----------
    lo, hi = sizes["prompt"]
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(lo, hi + 1, sizes["requests"])]
    out, m, counts, groups, done = serve(model, params, prompts, sizes["new"],
                                         max_len=max_len, label="rwkv")
    dec_tokens = sum(r.metrics.decode_ticks for r in done)
    row = {"requests": len(done), "prompt_lens": [len(p) for p in prompts],
           "max_new": sizes["new"], "status": m["requests"],
           "ticks": m["ticks"], "latency": m["latency"],
           "decode_tokens": dec_tokens, "decode_s": sum(groups),
           "decode_tokens_per_s": dec_tokens / sum(groups),
           "group_ms_p50": 1e3 * statistics.median(groups),
           "ttft_ms": [1e3 * r.metrics.ttft_s for r in done],
           "prefill_ms": [1e3 * r.metrics.prefill_s for r in done],
           "launches": {k: v for k, v in counts.items() if v},
           "health": health_moved(m)}
    say("(d) rwkv6-3b served", row)
    rows["d_rwkv"] = row
    del params, model, caches, logits
    free()
    sync_kw = dict(async_prefill=False, async_plans=False)
    tok_sync, *_ = serve(cut_model, cp, prompts, sizes["new"],
                         max_len=max_len, label="rwkv cut sync", **sync_kw)
    tok_async, *_ = serve(cut_model, cp, prompts, sizes["new"],
                          max_len=max_len, label="rwkv cut async")
    want = {rid: oracle(cut_model, cp, p, sizes["new"], max_len)
            for rid, p in enumerate(prompts)}
    check = {"requests": len(prompts),
             "sync_equals_oracle": tok_sync == want,
             "async_equals_sync": tok_async == tok_sync}
    say(f"(d) rwkv6-3b {n_cut}-layer f32 cut served", check)
    if not (check["sync_equals_oracle"] and check["async_equals_sync"]):
        fail(f"families (d) rwkv cut: {check}")
    rows["d_rwkv"]["cut"] = check
    del cp, cut_model
    free()

    # ---- (b) Zamba2-2.7B at full width and depth --------------------------
    zcfg = ctx.zamba if ctx.zamba is not None else zamba2_2_7b.CONFIG
    groups_n = zcfg.num_layers // zcfg.shared_every
    zm = Model(zcfg)
    zp, init_s = walled(lambda: zm.init(
        torch.Generator(device=dev).manual_seed(ctx.seed), device=dev))
    zs, zss = sizes["zamba_seq"], sizes["zamba_sparse_seq"]
    ztoks = torch.randint(0, zcfg.vocab_size, (1, zss + 1), device=dev,
                          generator=gen)
    with torch.no_grad():
        ((logits, caches), first_s), counts = ctx.drive(lambda: walled(
            lambda: zm.prefill(zp, {"tokens": ztoks[:, :zs]}, zs + steps)),
            "families")
        _, pre_s = walled(lambda: zm.prefill(zp, {"tokens": ztoks[:, :zs]},
                                             zs + steps))
        ok_prefill = bool(torch.isfinite(logits).all())
        logits, caches, dec = decode_run(zm, zp, logits, caches, steps)
    row = {"config": zcfg.name, "layers": zcfg.num_layers,
           "shared_every": zcfg.shared_every, "d_model": zcfg.d_model,
           "param_count": model_params.param_count(zm.specs),
           "param_bytes": model_params.param_bytes(zm.specs),
           "init_on_card_s": init_s, "seq": zs,
           "first_prefill_ms": 1e3 * first_s, "prefill_ms": 1e3 * pre_s,
           "prefill_tokens_per_s": zs / pre_s,
           "decode_step_ms": 1e3 * statistics.median(dec[1:]),
           "first_decode_step_ms": 1e3 * dec[0],
           "cache_bytes": nbytes(caches),
           "launches": {k: v for k, v in counts.items() if v}}
    say("(b) zamba2-2.7b prefill (full attention) and decode", row)
    if not ok_prefill or not bool(torch.isfinite(logits).all()) or \
            int(caches["length"]) != zs + steps:
        fail(f"families (b): {row}")
    rows["b"] = row
    del caches, logits

    # block-sparse shared attention: K7 and K8 on the block design, one
    # launch a group and head at B = 1
    scfg = zcfg.scaled(attn_pattern="block_sparse", window=sizes["window"],
                       attn_block=sizes["block"])
    sm = Model(scfg)
    want_k = groups_n * scfg.num_heads
    with torch.no_grad():
        ((logits, _), first_s), counts = ctx.drive(lambda: walled(
            lambda: sm.prefill(zp, {"tokens": ztoks[:, :zss]}, zss)),
            "families")
        designs = {k: v for k, v in ctx.took().items()
                   if k in ("chain_stats", "chain")}
        _, pre_s = walled(lambda: sm.prefill(zp, {"tokens": ztoks[:, :zss]},
                                             zss))
    csr = _spec_csr(_block_sparse_spec(scfg, zss, True), dev)
    fps = []
    for _ in range(3):
        t0 = time.perf_counter()
        pattern_fingerprint(csr)
        fps.append(time.perf_counter() - t0)
    fp_ms = 1e3 * statistics.median(fps)
    row = {"seq": zss, "window": scfg.window, "block": scfg.attn_block,
           "head_dim": scfg.head_dim, "nnz": csr.nnz,
           "first_prefill_ms": 1e3 * first_s, "prefill_ms": 1e3 * pre_s,
           "launches": {k: v for k, v in counts.items() if v},
           "designs": designs, "expected_each": want_k,
           "fingerprint_ms": fp_ms,
           "fingerprint_share": groups_n * fp_ms / (1e3 * pre_s)}
    say("(b) zamba2-2.7b block-sparse prefill", row)
    if not bool(torch.isfinite(logits).all()) or \
            counts["chain_stats"] != want_k or counts["chain"] != want_k or \
            designs["chain_stats"]["block"] != want_k or \
            designs["chain"]["block"] != want_k:
        fail(f"families (b) block-sparse: K7/K8 launched {counts} {designs}, "
             f"expected {want_k} each on the block design")
    rows["b"]["block_sparse"] = row
    del logits

    # K7 and K8 alone at one head of the shared attention (d = 80) against
    # their plain versions, timed beside SDPA on the dense mask
    d = scfg.head_dim
    bal = formats.csr_to_balanced(csr, 512)
    blocks = AttnBlocks()
    q, k, v = (torch.randn(zss, d, device=dev, generator=gen)
               for _ in range(3))
    pat = (bal.rows, bal.cols, q, k)
    kw = dict(shape=csr.shape, alpha=d ** -0.5)
    pm, ps = fused_chain.chain_stats_plain(*pat, **kw)
    yp = fused_chain.chain_plain(*pat, v, transform="softmax",
                                 stats=(pm, ps), **kw)
    fkw = dict(kw, blocks=blocks)
    rm, rs = fused_chain._launch_stats("block", *pat, **fkw)
    y = fused_chain._launch_chain("block", *pat, v, transform="softmax",
                                  stats=(pm, ps), **fkw)
    label = f"zamba2 shared attention head seq={zss} d={d} block"
    ctx.hold("chain_stats", f"{label} row max", rm, pm, "float32")
    ctx.hold("chain_stats", f"{label} row sum", rs, ps, "float32")
    ctx.hold("chain", f"{label} softmax", y, yp, "float32")
    lay = blocks(bal.rows, bal.cols, csr.shape)
    pattern_bytes = (12 * BLOCK * lay.n_blocks + 4 * lay.n_blocks
                     + 16 * lay.work.shape[0])
    base = pattern_bytes + 2 * zss * d * 4 + 8 * zss
    b7 = ctx.bound(base, 2 * csr.nnz * d)
    b8 = ctx.bound(base + 2 * zss * d * 4, 4 * csr.nnz * d)
    st = fused_chain._launch_stats(None, *pat, **fkw)
    r_ = torch.repeat_interleave(torch.arange(zss, device=dev),
                                 torch.diff(csr.indptr.long()))
    mask = torch.zeros((zss, zss), dtype=torch.bool, device=dev)
    mask[r_, csr.indices.long()] = True
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k7 = {"shape": f"{label} fill {lay.fill:.4f}", "nnz": csr.nnz,
          "ms": ctx.time_ms(lambda: fused_chain._launch_stats(None, *pat,
                                                              **fkw)),
          "plain_ms": ctx.time_ms(lambda: fused_chain.chain_stats_plain(
              *pat, **kw), 3),
          "library_ms": None, "bound_ms": b7[0], "bound_by": b7[1]}
    k8 = {"shape": f"{label} fill {lay.fill:.4f}", "nnz": csr.nnz,
          "ms": ctx.time_ms(lambda: fused_chain._launch_chain(
              None, *pat, v, transform="softmax", stats=st, **fkw)),
          "plain_ms": ctx.time_ms(lambda: fused_chain.chain_plain(
              *pat, v, transform="softmax", stats=st, **kw), 3),
          "library_ms": ctx.time_ms(lambda: sdpa(
              q[None, None], k[None, None], v[None, None],
              attn_mask=mask)),
          "bound_ms": b8[0], "bound_by": b8[1]}
    say("K7 / K8 at d = 80 (CUDA events, median of 20; K8's library: SDPA "
        "on the dense boolean mask, K7 + K8)", {"k7": k7, "k8": k8})
    rows["k7_d80"], rows["k8_d80"] = k7, k8
    del bal, blocks, q, k, v, pat, pm, ps, yp, rm, rs, y, st, mask, r_

    # the SSD scan at the full head shapes: chunked against the recurrence
    sd = sizes["ssd"]
    h_, p_, n_ = sd["heads"], sd["head_dim"], sd["state"]
    x = torch.randn(1, sd["seq"], h_, p_, device=dev, generator=gen)
    dt = torch.rand(1, sd["seq"], h_, device=dev, generator=gen) * 0.1 + 0.01
    a_log = torch.rand(h_, device=dev, generator=gen)
    bb = 0.3 * torch.randn(1, sd["seq"], n_, device=dev, generator=gen)
    cc = 0.3 * torch.randn(1, sd["seq"], n_, device=dev, generator=gen)
    dsk = torch.randn(h_, device=dev, generator=gen)
    with torch.no_grad():
        (y_c, s_c), chunk_s = walled(lambda: ssm.ssd_chunked(
            x, dt, a_log, bb, cc, dsk, chunk=sd["chunk"]))
        state = torch.zeros(1, h_, n_, p_, device=dev)
        ys = []
        t0 = time.perf_counter()
        for i in range(sd["seq"]):
            yi, state = ssm.ssd_decode_step(state, x[:, i], dt[:, i], a_log,
                                            bb[:, i], cc[:, i], dsk)
            ys.append(yi)
        sync()
        step_s = time.perf_counter() - t0
    check = {**sd, "y_rel_err": rel(y_c, torch.stack(ys, 1)),
             "state_rel_err": rel(s_c, state), "chunked_ms": 1e3 * chunk_s,
             "recurrence_ms": 1e3 * step_s}
    print(f"[check] families (b) ssd_chunked vs the ssd_decode_step "
          f"recurrence {json.dumps(check)} tol 1e-3", flush=True)
    if check["y_rel_err"] > 1e-3 or check["state_rel_err"] > 1e-3:
        fail(f"families (b) ssd: {check}")
    rows["b"]["ssd"] = check
    del x, dt, bb, cc, y_c, s_c, ys, state

    # one group in f32 at full width, block-sparse: "hopper" against
    # "torch", and prefill + one decode step against a longer prefill
    n_g = sizes["zamba_cut_layers"]
    gcfg = scfg.scaled(num_layers=n_g, **f32)
    gm = Model(gcfg)
    gp = {k: v.float() for k, v in zp.items()
          if k not in ("blocks", "shared_attn")}
    gp["blocks"] = tree_map(lambda v: v[:n_g // zcfg.shared_every].float(),
                            zp["blocks"])
    gp["shared_attn"] = tree_map(lambda v: v.float(), zp["shared_attn"])
    del zp, zm, sm
    free()
    gs = sizes["zamba_cut_seq"]
    t = ztoks[:, :gs + 1]
    with torch.no_grad():
        (lh, ch), counts = ctx.drive(lambda: gm.prefill(
            gp, {"tokens": t[:, :gs]}, gs + 8), "families")
        with repro_torch.use_backend("torch"):
            lt, _ = gm.prefill(gp, {"tokens": t[:, :gs]}, gs + 8)
        ld, _ = gm.decode_step(gp, ch, t[:, gs:])
        lp2, _ = gm.prefill(gp, {"tokens": t}, gs + 8)
    check = {"layers": n_g, "seq": gs, "hopper_vs_torch_rel_err": rel(lh, lt),
             "decode_vs_prefill_rel_err": rel(ld, lp2),
             "launches": {k: v for k, v in counts.items() if v}}
    print(f"[check] families (b) zamba2 one-group f32 cut, block-sparse: "
          f"{json.dumps(check)} tol {ctx.rtol:g} / 2e-2", flush=True)
    if check["hopper_vs_torch_rel_err"] > ctx.rtol or \
            check["decode_vs_prefill_rel_err"] >= 2e-2 or \
            counts["chain_stats"] != gcfg.num_heads or \
            counts["chain"] != gcfg.num_heads:
        fail(f"families (b) cut: {check}")
    rows["b"]["cut"] = check
    del lh, lt, ld, lp2, ch

    # (d) the serve engine on the one-group cut: K7/K8 in the prefills
    cut_prompts = [rng.integers(0, zcfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(lo, hi + 1, sizes["cut_requests"])]
    tok_sync, m, counts, groups, done = serve(
        gm, gp, cut_prompts, sizes["cut_new"], max_len=max_len,
        label="zamba2 cut sync", **sync_kw)
    tok_async, *_ = serve(gm, gp, cut_prompts, sizes["cut_new"],
                          max_len=max_len, label="zamba2 cut async")
    want = {rid: oracle(gm, gp, p, sizes["cut_new"], max_len)
            for rid, p in enumerate(cut_prompts)}
    check = {"prompt_lens": [len(p) for p in cut_prompts],
             "sync_equals_oracle": tok_sync == want,
             "async_equals_sync": tok_async == tok_sync,
             "launches_sync": {k: v for k, v in counts.items() if v},
             "ticks": m["ticks"], "latency": m["latency"],
             "decode_tokens_per_s": sum(r.metrics.decode_ticks for r in done)
             / sum(groups)}
    say("(d) zamba2-2.7b one-group f32 block-sparse cut served", check)
    if not (check["sync_equals_oracle"] and check["async_equals_sync"]) or \
            counts["chain_stats"] < 1 or counts["chain"] < 1:
        fail(f"families (d) zamba2 cut: {check}")
    rows["d_zamba"] = check
    del gp, gm
    free()

    # ---- (c) Whisper-tiny at full width -----------------------------------
    wcfg = ctx.whisper if ctx.whisper is not None else whisper_tiny.CONFIG
    wm = Model(wcfg)
    wp = wm.init(torch.Generator(device=dev).manual_seed(ctx.seed), device=dev)
    wb, ws = sizes["whisper_batch"], sizes["whisper_seq"]
    frames = torch.randn(wb, wcfg.num_frames, wcfg.d_model, device=dev,
                         generator=gen)
    wtoks = torch.randint(0, wcfg.vocab_size, (wb, ws), device=dev,
                          generator=gen)
    batch = {"tokens": wtoks, "frames": frames}
    with torch.no_grad():
        ((logits, caches), first_s), counts = ctx.drive(lambda: walled(
            lambda: wm.prefill(wp, batch, ws + steps)), "families")
        _, pre_s = walled(lambda: wm.prefill(wp, batch, ws + steps))
        ok_prefill = bool(torch.isfinite(logits).all())
        logits, caches, dec = decode_run(wm, wp, logits, caches, steps)
    row = {"config": wcfg.name, "encoder_layers": wcfg.encoder_layers,
           "layers": wcfg.num_layers, "d_model": wcfg.d_model,
           "frames": wcfg.num_frames, "batch": wb, "seq": ws,
           "param_count": model_params.param_count(wm.specs),
           "first_prefill_ms": 1e3 * first_s, "prefill_ms": 1e3 * pre_s,
           "decode_step_ms": 1e3 * statistics.median(dec[1:]),
           "first_decode_step_ms": 1e3 * dec[0],
           "launches": {k: v for k, v in counts.items() if v}}
    say("(c) whisper-tiny prefill and decode", row)
    if not ok_prefill or not bool(torch.isfinite(logits).all()) or \
            int(caches["length"]) != ws + steps or \
            tuple(caches["memory"].shape) != (wb, wcfg.num_frames,
                                              wcfg.d_model):
        fail(f"families (c): {row}")
    rows["c"] = row
    del logits, caches

    # block-sparse in f32: the encoder's non-causal band over 1,500 frames
    # (the last block partial) and the decoder's causal prefill on K7 + K8
    fcfg = wcfg.scaled(attn_pattern="block_sparse",
                       window=sizes["whisper_window"],
                       attn_block=sizes["block"], **f32)
    fm = Model(fcfg)
    fp = tree_map(lambda v: v.float(), wp)
    want_k = (fcfg.encoder_layers + fcfg.num_layers) * fcfg.num_heads * wb
    with torch.no_grad():
        (lh, ch), counts = ctx.drive(lambda: fm.prefill(fp, batch, ws + 8),
                                     "families")
        designs = {k: v for k, v in ctx.took().items()
                   if k in ("chain_stats", "chain")}
        with repro_torch.use_backend("torch"):
            lt, ct = fm.prefill(fp, batch, ws + 8)
    check = {"window": fcfg.window, "block": fcfg.attn_block,
             "hopper_vs_torch_rel_err": rel(lh, lt),
             "memory_rel_err": rel(ch["memory"], ct["memory"]),
             "launches": {k: v for k, v in counts.items() if v},
             "designs": designs, "expected_each": want_k}
    print(f"[check] families (c) whisper-tiny block-sparse f32: "
          f"{json.dumps(check)} tol {ctx.rtol:g}", flush=True)
    if check["hopper_vs_torch_rel_err"] > ctx.rtol or \
            check["memory_rel_err"] > ctx.rtol or \
            counts["chain_stats"] != want_k or counts["chain"] != want_k or \
            designs["chain_stats"]["block"] < 1 or designs["chain"]["block"] < 1:
        fail(f"families (c) block-sparse: {check}")
    rows["c"]["block_sparse"] = check
    del wp, fp, wm, fm, lh, lt, ch, ct, frames
    free()
    return rows


#: the sharded path: SHARDED["shards"] shards of one mesh that share the
#: card (``make_local_mesh(4, 1, devices=["cuda:0"] * 4)``, each shard on a
#: stream of its own), every result against the unsharded plan on the same
#: card: (a) ``sparse(csr, mesh=mesh) @ x`` on both scale-20 graphs at
#: ``ns`` (g500 by nonzeros: psum; uniform by rows: concat), the spill inner
#: (K4/K5 + the combine a shard) at ``spill`` — (graph, N, kernel; g500's
#: window is past the default ``max_win``, so its plan takes
#: ``spill_max_win``; at N = 128 its partials would take 27 GB a shard, so
#: the N = 128 spill runs on the uniform graph); (b) the ring at ``ring_n``
#: against the blocking psum, ``autotune_overlap`` over ``ring_ns``; (c)
#: the backward at ``bwd_n``; (d) an int8 plan at ``quant_n``; (e) the GAT
#: softmax chain (d = ``chain_d``, N = ``chain_n``) on both graphs and one
#: head of Gemma-3-12B's local attention; (f) one sparse FFN layer at
#: Gemma-3-12B's widths through ``execute_pattern_sharded``, the train
#: phase's batch and steps, then the int8 error-feedback all-reduce of its
#: gradients on ``dp`` micro-batches; (g) a finalized sharded artifact
SHARDED = dict(shards=4, ns=(1, 4, 32, 128),
               spill=(("g500", 1, "nb_pr"), ("unif", 128, "nb_sr")),
               spill_max_win=8192, ring_n=512, ring_ns=(256, 512), bwd_n=32,
               quant_n=128, chain_d=64, chain_n=32, alpha=0.125,
               attn_seq=8192, train_batch=4, train_seq=512, train_steps=5,
               dp=4, reps=20, ffn_cfg=None)


def sharded_phase(ctx, sizes=SHARDED):
    """Phase ``sharded``: the sharded backend (``core/shard.py``) on one
    card, (a)-(g) of ``SHARDED``.  ``ctx`` carries the card's helpers and
    the graphs; returns the phase's rows."""
    import torch

    import repro_torch
    from repro_torch.configs import gemma3_12b
    from repro_torch.core import formats, quant, shard
    from repro_torch.core.plan import PATTERN_PREP, execute, execute_attention
    from repro_torch.kernels import tune
    from repro_torch.launch import (SPARSE_WEIGHT_RULES, make_local_mesh,
                                    resolve_rules)
    from repro_torch.models import SparseFFN, sharding_ctx, transformer
    from repro_torch.models.config import SparseFFNConfig
    from repro_torch.train import (OptConfig, TrainConfig, init_state,
                                   make_dp_compressed_allreduce,
                                   make_train_step)

    dev, fail, say, drive = ctx.dev, ctx.fail, ctx.say, ctx.drive
    n_sh, reps = sizes["shards"], sizes["reps"]
    mesh = make_local_mesh(n_sh, 1, devices=[str(dev)] * n_sh)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 32)
    rows: dict = {}

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)

    def time_ms(fn):
        return ctx.time_ms(fn, reps)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(label, got, want, tol):
        rel, diff = ctx.errors(got, want)
        print(f"[check] sharded {label}: rel_inf_err={rel:.3e} "
              f"max_abs_err={diff:.3e} tol={tol:g} "
              f"{'ok' if rel <= tol else 'MISS'}", flush=True)
        if not rel <= tol:
            fail(f"sharded {label}: {rel:.3e} > {tol:g} against the unsharded "
                 "plan")
        return rel

    def launched(label, counts, want: dict):
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"sharded {label}: launches {got}, expected {want} "
                 f"({n_sh} shards); all: { {k: v for k, v in counts.items() if v} }")
        return {k: v for k, v in counts.items() if v}

    def operand(csr, n):
        k = csr.shape[1]
        return randn(k, n) if n > 1 else randn(k)

    # (a) the products, each shard's kernel once a call, and the spill inner
    mats = {}
    for name, kind in (("g500", "nnz"), ("unif", "row")):
        csr = ctx.graphs[name]
        t0 = time.perf_counter()
        A = repro_torch.sparse(csr, mesh=mesh)
        U = repro_torch.sparse(csr, device=dev)
        mats[name] = (A, U)
        spec = A.plan.shard_spec
        if spec.kind != kind or A.plan.inner_backend != "hopper":
            fail(f"sharded {name}: partition {spec.kind} / inner "
                 f"{A.plan.inner_backend}, expected {kind} / hopper")
        for n in sizes["ns"]:
            x = operand(csr, n)
            pick = A.plan.select(n)
            kernel = kernel_of(pick, n)
            t1 = time.perf_counter()
            y, counts = drive(lambda: A @ x, "sharded")
            first_s = time.perf_counter() - t1
            launches = launched(f"(a) {name} N={n}", counts, {kernel: n_sh})
            rel = check(f"(a) {name} {kind} N={n} {pick}", y, U @ x,
                        ctx.rtol["float32"])
            parts = [y.clone() for _ in range(n_sh)]
            if spec.reduction == "psum":
                red_ms = time_ms(lambda: shard.psum(parts))
            else:
                m_pad = spec.m_pad
                red_ms = time_ms(lambda: torch.cat(
                    [p[:m_pad] for p in parts])[:csr.shape[0]])
            row = {"pick": pick, "kernel": kernel, "launches": launches,
                   "rel_err": rel, "first_call_s": first_s,
                   "ms": time_ms(lambda: A @ x),
                   "unsharded_ms": time_ms(lambda: U @ x),
                   f"{spec.reduction}_ms": red_ms}
            row["reduction_share"] = red_ms / row["ms"]
            rows[("a", name, n)] = row
            say(f"(a) {name} {kind} split N={n}", row)
        say(f"(a) {name} plan and substrate", {
            "spec": dataclasses.asdict(spec),
            "substrates": A.plan.built_substrates,
            "host_s_incl_first_calls": time.perf_counter() - t0})
    default_th = repro_torch.SelectorThresholds()
    spill_th = dataclasses.replace(default_th,
                                   max_win=sizes["spill_max_win"])
    for name, n, impl in sizes["spill"]:
        A, U = mats[name]
        S = A.with_thresholds(spill_th)
        S.plan.kernel_opts(S.plan.entry(impl))["spill"] = True
        x = operand(ctx.graphs[name], n)
        y, counts = drive(lambda: S.matmul(x, impl=impl), "sharded")
        spill = "vsr_spmv_spill" if n == 1 else "vsr_spmm_spill"
        launches = launched(f"(a) spill {name} N={n}", counts,
                            {spill: n_sh, "spill_combine": n_sh})
        rel = check(f"(a) spill {name} N={n} {impl}", y, U.matmul(x, impl=impl),
                    ctx.rtol["float32"])
        row = {"impl": impl, "launches": launches, "rel_err": rel,
               "ms": time_ms(lambda: S.matmul(x, impl=impl)),
               "unsharded_fused_ms": time_ms(lambda: U.matmul(x, impl=impl))}
        rows[("spill", name, n)] = row
        say(f"(a) spill {name} N={n}", row)
        del S
    free()

    # (b) the ring against the blocking psum, and the overlap tuner
    A, U = mats["g500"]
    ring = A.with_thresholds(dataclasses.replace(default_th, overlap_min_n=1))
    blocking = A.with_thresholds(dataclasses.replace(
        default_th, overlap_min_n=tune.OVERLAP_NEVER))
    x = operand(ctx.graphs["g500"], sizes["ring_n"])
    y_ring, counts = drive(lambda: ring @ x, "sharded")
    chunks = -(-sizes["ring_n"] // shard.RING_CHUNK)
    launches = launched("(b) ring", counts, {"vsr_spmm": n_sh * chunks})
    y_psum = blocking @ x
    rel = check(f"(b) ring vs psum g500 N={sizes['ring_n']}", y_ring, y_psum,
                1e-5)
    del y_ring, y_psum
    t0 = time.perf_counter()
    timer = tune.Timer()
    tuned = tune.autotune_overlap(ctx.graphs["g500"], mesh,
                                  ns=sizes["ring_ns"], repeats=reps,
                                  timer=timer)
    row = {"launches": launches, "rel_err": rel,
           "ring_ms": time_ms(lambda: ring @ x),
           "psum_ms": time_ms(lambda: blocking @ x),
           "unsharded_ms": time_ms(lambda: U @ x),
           "autotune_overlap": {"overlap_min_n": tuned.overlap_min_n,
                                "s": time.perf_counter() - t0,
                                "timings": timer.log}}
    rows["b"] = row
    say(f"(b) ring g500 N={sizes['ring_n']}", row)
    if any(e["mode"] != "graph" for e in timer.log):
        fail(f"sharded (b): a sharded call was not captured: {timer.log}")
    del x, ring, blocking
    free()

    # (c) the backward: dvals of a live stream (K6 a shard), dX (K1 a shard
    # on its transposed slabs)
    csr = ctx.graphs["g500"]
    x = operand(csr, sizes["bwd_n"])
    g = randn(csr.shape[0], sizes["bwd_n"])

    def grads(M):
        v = csr.data.clone().requires_grad_()
        xx = x.clone().requires_grad_()
        loss = ((M.with_values(v) @ xx) * g).sum()
        return torch.autograd.grad(loss, (v, xx))

    (dv, dx), counts = drive(lambda: grads(A), "sharded")
    launches = launched("(c) backward", counts,
                        {"sddmm": n_sh, "vsr_spmm": 2 * n_sh})
    dv_u, dx_u = grads(U)
    row = {"launches": launches,
           "dvals_rel_err": check("(c) dvals g500 N=32", dv, dv_u,
                                  ctx.rtol["float32"]),
           "dx_rel_err": check("(c) dX g500 N=32", dx, dx_u,
                               ctx.rtol["float32"]),
           "ms": time_ms(lambda: grads(A)),
           "unsharded_ms": time_ms(lambda: grads(U))}
    rows["c"] = row
    say("(c) backward g500 nnz split N=32 (forward + backward)", row)
    del dv, dx, dv_u, dx_u, x, g

    # (d) an int8 sharded plan against the unsharded product of its decoded
    # values
    Q = repro_torch.sparse(csr, mesh=mesh, quant="int8")
    Q1 = repro_torch.sparse(csr, device=dev, quant="int8")
    x = operand(csr, sizes["quant_n"])
    y, counts = drive(lambda: Q @ x, "sharded")
    sub = Q.plan.substrate("shard_balanced")
    if sub.quant != "int8":
        fail(f"sharded (d): the plan did not quantize ({sub.quant})")
    decoded = torch.zeros(csr.nnz + 1, device=dev)
    for codes, scales, src in zip(sub.vals, sub.scales, sub.src):
        slot = torch.where(src >= 0, src, csr.nnz).reshape(-1).long()
        decoded.index_put_((slot,), quant.dequantize_stream(codes, scales)
                           .reshape(-1))
    want = U.with_values(decoded[:csr.nnz]) @ x
    launches = launched("(d) int8", counts, {"vsr_spmm": n_sh})
    row = {"launches": launches,
           "rel_err": check("(d) int8 g500 N=128", y, want, ctx.rtol["float32"]),
           "f32_rel_err": ctx.errors(y, U @ x)[0],
           "ms": time_ms(lambda: Q @ x),
           "unsharded_int8_ms": time_ms(lambda: Q1 @ x)}
    rows["d"] = row
    say("(d) int8 g500 N=128", row)
    del Q, Q1, sub, decoded, want, x, y
    free()

    # (e) the chain: GAT softmax on both graphs (nnz split: K7 a shard, the
    # statistics merged, K8 a shard; row split: K8 with its K7 a shard) and
    # one head of Gemma-3-12B's local attention (row split, a block layout
    # a shard)
    for name, (A, U) in mats.items():
        csr = ctx.graphs[name]
        a = randn(csr.shape[0], sizes["chain_d"], scale=0.3)
        b = randn(csr.shape[1], sizes["chain_d"], scale=0.3)
        x = operand(csr, sizes["chain_n"])
        call = lambda: A.chain(a, b, x, alpha=sizes["alpha"])  # noqa: E731
        y, counts = drive(call, "sharded")
        launches = launched(f"(e) chain {name}", counts,
                            {"chain_stats": n_sh, "chain": n_sh})
        row = {"kind": A.plan.shard_spec.kind, "launches": launches,
               "designs": {k: v for k, v in ctx.took()["chain"].items() if v},
               "rel_err": check(f"(e) softmax chain {name} d={sizes['chain_d']}"
                                f" N={sizes['chain_n']}", y,
                                U.chain(a, b, x, alpha=sizes["alpha"]),
                                ctx.rtol["float32"]),
               "ms": time_ms(call),
               "unsharded_ms": time_ms(
                   lambda: U.chain(a, b, x, alpha=sizes["alpha"]))}
        rows[("e", name)] = row
        say(f"(e) GAT softmax chain {name}", row)
        del a, b, x, y
    gemma = dataclasses.replace(gemma3_12b.CONFIG, attn_pattern="block_sparse")
    spec = transformer._block_sparse_spec(gemma, sizes["attn_seq"], True)
    q, k, v = (randn(sizes["attn_seq"], gemma.head_dim, scale=0.3)
               for _ in range(3))
    call = lambda: repro_torch.sparse_attention(spec, q, k, v, mesh=mesh)  # noqa: E731
    y, counts = drive(call, "sharded")
    designs = ctx.took()
    launches = launched("(e) gemma head", counts,
                        {"chain_stats": n_sh, "chain": n_sh})
    if designs["chain"].get("block", 0) != n_sh:
        fail(f"sharded (e) gemma head: K8 designs {designs['chain']}")
    P = repro_torch.attention_plan(spec, device=dev, mesh=mesh)
    layouts = [o["blocks"] for o in
               P.kernel_opts(P.entry("chain"))["shards"]]
    layout_nnz = [None if b._value is None else b._value.nnz
                  for b in layouts]
    if len({id(b) for b in layouts}) != n_sh or None in layout_nnz or \
            len(set(layout_nnz)) < 2:
        fail(f"sharded (e) gemma head: the shards do not each hold their own "
             f"block layout ({layout_nnz})")
    row = {"kind": P.shard_spec.kind, "launches": launches,
           "designs": {kk: {d: c for d, c in vv.items() if c}
                       for kk, vv in designs.items()
                       if kk in ("chain_stats", "chain")},
           "layout_nnz": layout_nnz,
           "rel_err": check("(e) gemma local head seq=8192 d=256", y,
                            repro_torch.sparse_attention(spec, q, k, v),
                            ctx.rtol["float32"]),
           "facade_ms": time_ms(call),
           "unsharded_facade_ms": time_ms(
               lambda: repro_torch.sparse_attention(spec, q, k, v))}
    # the facade's call looks the plan up by the mask's fingerprint (host
    # time); the plans' own calls
    P1 = repro_torch.attention_plan(spec, device=dev)
    row["ms"] = time_ms(lambda: execute_attention(P, q, k, v))
    row["unsharded_ms"] = time_ms(lambda: execute_attention(P1, q, k, v))
    try:
        repro_torch.sparse_attention(spec, q, k, v, mesh=mesh,
                                     bias=torch.zeros(P.nnz, device=dev))
        fail("sharded (e): attention with a bias did not raise")
    except ValueError as err:
        row["bias_raises"] = type(err).__name__
    rows[("e", "gemma")] = row
    say("(e) gemma-3-12b local head", row)
    del q, k, v, y, P, P1, layouts
    free()

    # (f) one sparse FFN layer at Gemma-3-12B's widths, sharded, against the
    # same steps unsharded; then the int8 error-feedback all-reduce of its
    # gradients on dp micro-batches
    cfg = (sizes.get("ffn_cfg") or gemma3_12b.CONFIG).scaled(
        sparse_ffn=SparseFFNConfig(), param_dtype="float32",
        compute_dtype="float32")
    ffn = SparseFFN(cfg, seed=ctx.seed, device=dev)
    shape = (sizes["train_batch"], sizes["train_seq"], cfg.d_model)
    batch = {"x": randn(*shape), "y": randn(*shape)}

    def ffn_loss(p, b):
        return torch.mean((ffn(b["x"], p) - b["y"]) ** 2), {}

    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=sizes["train_steps"]))
    step = make_train_step(ffn_loss, tcfg)
    rules = resolve_rules(overrides=SPARSE_WEIGHT_RULES)
    losses = {}
    for label in ("unsharded", "sharded"):
        state = init_state(ffn.params(), tcfg)
        losses[label], step_ms, counts_each = [], [], []
        with sharding_ctx.activation_sharding(
                mesh, rules, enabled=label == "sharded"):
            for _ in range(sizes["train_steps"]):
                t0 = time.perf_counter()
                if label == "sharded":
                    (state, metrics), counts = drive(
                        lambda: step(state, batch), "sharded")
                    counts_each.append(counts)
                else:
                    state, metrics = step(state, batch)
                losses[label].append(float(metrics["loss"]))
                step_ms.append(1e3 * (time.perf_counter() - t0))
        rows[("f", label)] = {"losses": losses[label], "step_ms": step_ms}
    for i, counts in enumerate(counts_each):
        launched(f"(f) train step {i + 1}", counts,
                 {"vsr_spmm": 6 * n_sh, "sddmm": 3 * n_sh})
    rel_losses = [abs(a - b) / abs(b) for a, b in
                  zip(losses["sharded"], losses["unsharded"])]
    rows[("f", "sharded")]["loss_rel_err"] = rel_losses
    rows[("f", "sharded")]["launches_a_step"] = {
        k: v for k, v in counts_each[0].items() if v}
    say("(f) sparse FFN gemma-3-12b widths, sharded vs unsharded",
        {"unsharded": rows[("f", "unsharded")],
         "sharded": rows[("f", "sharded")]})
    if max(rel_losses) > ctx.rtol["float32"]:
        fail(f"sharded (f): losses {losses} differ by {rel_losses}")
    params = init_state(ffn.params(), tcfg)["params"]
    micro = [{k: t[i:i + 1] for k, t in batch.items()}
             for i in range(sizes["dp"])]
    grads_mb = []
    for mb in micro:
        leaves = {k: p.detach().clone().requires_grad_()
                  for k, p in params.items()}
        loss = ffn_loss(leaves, mb)[0]
        grads_mb.append(dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())))))
    dp_mesh = make_local_mesh(sizes["dp"], 1, devices=[str(dev)] * sizes["dp"])
    allreduce = make_dp_compressed_allreduce(dp_mesh, "data")
    stacked = {k: torch.stack([g_[k] for g_ in grads_mb]) for k in params}
    residuals = {k: torch.zeros_like(t) for k, t in stacked.items()}
    mean_q, new_res = allreduce(stacked, residuals)
    sync()
    # the wire protocol's mirror (per-shard int8 encode, int32 sum, one
    # decode with the mean scale) and the reference's bound on its distance
    # from the f32 mean: per shard 127·|s_i − s̄| (the mean-scale decode)
    # + s_i / 2 (the rounding), over n
    dp_rows = {}
    for k, t in stacked.items():
        want = t.mean(0)
        enc = [quant.int8_encode(t[i]) for i in range(t.shape[0])]
        codes = torch.stack([q for q, _ in enc]).to(torch.int32)
        scales = torch.stack([sc for _, sc in enc])
        mirror = codes.sum(0).float() * (scales.sum() / t.shape[0]) / t.shape[0]
        bound = float((127 * (scales - scales.mean()).abs().sum()
                       + scales.sum() / 2) / t.shape[0])
        dp_rows[k] = {"mirror_rel_err": ctx.errors(mean_q[k], mirror)[0],
                      "max_abs_err": float((mean_q[k] - want).abs().max()),
                      "bound": bound,
                      "rel_l2_err": float((mean_q[k] - want).norm()
                                          / want.norm()),
                      "scale_spread": float(scales.max() / scales.min()),
                      "residual_rel_l2": float(new_res[k].norm() / t.norm())}
        if dp_rows[k]["mirror_rel_err"] > 1e-5 or \
                dp_rows[k]["max_abs_err"] > bound:
            fail(f"sharded (f): the int8 all-reduce of {k} is not the wire "
                 f"protocol's mean or exceeds its bound: {dp_rows[k]}")
    dp_rows["ms"] = time_ms(lambda: allreduce(stacked, residuals))
    rows[("f", "dp")] = dp_rows
    say(f"(f) int8 EF all-reduce over a {sizes['dp']}-way data mesh", dp_rows)
    del ffn, batch, state, stacked, residuals, mean_q, new_res, grads_mb
    free()

    # (g) a finalized sharded artifact: no host build and no sync a call
    A, _ = mats["g500"]
    art = A.finalize(sizes["bwd_n"])
    x = operand(ctx.graphs["g500"], sizes["bwd_n"])
    want = A @ x
    builds = (dict(formats.BUILD_COUNTS), dict(PATTERN_PREP))
    sync()
    on_card = dev.type == "cuda"
    mode = torch.cuda.get_sync_debug_mode() if on_card else None
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        y, counts = drive(lambda: execute(art, x), "sharded")
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(mode)
    after = (dict(formats.BUILD_COUNTS), dict(PATTERN_PREP))
    if after != builds:
        fail(f"sharded (g): the artifact's call built on the host: {builds} "
             f"-> {after}")
    launches = launched("(g) artifact", counts, {"vsr_spmm": n_sh})
    row = {"launches": launches,
           "rel_err": check("(g) artifact vs builder g500 N=32", y, want,
                            ctx.rtol["float32"]),
           "bit_equal": bool(torch.equal(y, want)),
           "ms": time_ms(lambda: execute(art, x)),
           "builder_ms": time_ms(lambda: A @ x)}
    rows["g"] = row
    say("(g) finalized artifact g500 N=32", row)
    return rows


#: the launch path: (a) Llama-3.2-1B at full width, (b) OLMoE-1B-7B at the
#: launcher's 100m scale, (c) one dry-run cell.  (b) must end ``moe_margin``
#: nats below ln V, the loss of a uniform guess: a model that ignores the
#: context scores at least ln V on the stream's uniform targets, so only
#: learned structure gets below it (a 5-step mean covers 40,960 tokens: its
#: noise is under 0.01).  At the launcher's lr of 3e-4 the loss is
#: still above ln V after 600 steps of 8 x 256; 300 steps of 32 x 256 at
#: 3e-3 end ~0.05 below it (``PERF.md`` §7).
LAUNCH = dict(full_arch="llama3.2-1b", full_scale="full", full_steps=10,
              full_batch=4, full_seq=256, moe_arch="olmoe-1b-7b",
              moe_scale="100m", moe_steps=300, moe_lr=3e-3,
              moe_batch=32, moe_seq=256, moe_margin=0.03,
              dry_arch="llama3.2-1b", dry_shape="train_4k")


def launch_phase(ctx, sizes=LAUNCH):
    """Phase ``launch``: the training launcher on the card at full width
    and at the 100m scale, and one dry-run cell.  Runs from a temporary
    working directory (the launcher writes ``results/`` there).  ``ctx``
    carries the card's helpers; returns the phase's rows."""
    import os
    import tempfile

    import torch

    from repro_torch.launch import cost_model, dryrun, train
    from repro_torch.models import moe
    from repro_torch.models.config import ShapeCell

    fail, say = ctx.fail, ctx.say
    rows = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            # (a) full width; the checkpoint period above the steps
            n = sizes["full_steps"]
            argv = ["--arch", sizes["full_arch"], "--scale", sizes["full_scale"],
                    "--steps", str(n), "--batch", str(sizes["full_batch"]),
                    "--seq", str(sizes["full_seq"]),
                    "--ckpt-every", str(n + 1),
                    "--ckpt-dir", os.path.join(work, "ckpt_full"),
                    "--device", str(ctx.dev), "--seed", str(ctx.seed)]
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out, counts = ctx.drive(lambda: train.main(argv), "launch")
            run_s = time.perf_counter() - t0
            cfg = train.scale_config(sizes["full_arch"], sizes["full_scale"])
            losses, walls = out["losses"], out["step_s"]
            step_s = statistics.median(walls[1:])
            tokens = sizes["full_batch"] * sizes["full_seq"]
            cost = cost_model.cell_cost(cfg, ShapeCell(
                "launch", sizes["full_seq"], sizes["full_batch"], "train"))
            row = {"arch": cfg.name, "params": cost.n_params,
                   "steps": len(losses), "losses": losses,
                   "step_ms_median": 1e3 * step_s,
                   "first_step_ms": 1e3 * walls[0],
                   "tokens_per_s": tokens / step_s,
                   "model_flops_step": cost.model_flops,
                   "model_flop_share": cost.model_flops / (step_s * 989e12),
                   "analytic_flop_share": cost.flops / (step_s * 989e12),
                   "run_s_with_final_checkpoint": run_s,
                   "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                   if torch.cuda.is_available() else None),
                   "launches": {k: v for k, v in counts.items() if v}}
            say(f"(a) launch.train --scale {sizes['full_scale']}", row)
            if len(losses) != n or not all(math.isfinite(x) for x in losses):
                fail(f"launch (a): {row}")
            rows["full"] = row
            torch.cuda.empty_cache()

            # (b) the 100m MoE: the loss falls below a uniform guess's, the
            # dispatch runs on K1
            paths0 = dict(moe.DISPATCH_PATHS)
            argv = ["--arch", sizes["moe_arch"], "--scale", sizes["moe_scale"],
                    "--steps", str(sizes["moe_steps"]),
                    "--lr", str(sizes["moe_lr"]),
                    "--batch", str(sizes["moe_batch"]),
                    "--seq", str(sizes["moe_seq"]),
                    "--ckpt-every", str(sizes["moe_steps"] + 1),
                    "--ckpt-dir", os.path.join(work, "ckpt_moe"),
                    "--device", str(ctx.dev), "--seed", str(ctx.seed)]
            out, counts = ctx.drive(lambda: train.main(argv), "launch")
            losses, walls = out["losses"], out["step_s"]
            first, last = (statistics.mean(losses[:5]),
                           statistics.mean(losses[-5:]))
            uniform = math.log(train.scale_config(
                sizes["moe_arch"], sizes["moe_scale"]).vocab_size)
            paths = {k: v - paths0[k] for k, v in moe.DISPATCH_PATHS.items()}
            row = {"arch": sizes["moe_arch"], "scale": sizes["moe_scale"],
                   "steps": len(losses), "loss_first5_mean": first,
                   "loss_last5_mean": last, "uniform_loss": uniform,
                   "loss_by_25_steps": [statistics.mean(losses[i:i + 25])
                                        for i in range(0, len(losses), 25)],
                   "step_ms_median": 1e3 * statistics.median(walls[1:]),
                   "dispatch_paths": paths,
                   "launches": {k: v for k, v in counts.items() if v},
                   "k1_designs": ctx.took().get("vsr_spmm")}
            say(f"(b) launch.train --scale {sizes['moe_scale']}", row)
            print(f"[launch] moe.DISPATCH_PATHS {json.dumps(paths)}",
                  flush=True)
            if not last < min(first, uniform - sizes["moe_margin"]) or \
                    counts["vsr_spmm"] < 1 or \
                    not all(math.isfinite(x) for x in losses):
                fail(f"launch (b): {row}")
            rows["moe"] = row
            torch.cuda.empty_cache()

            # (c) one dry-run cell on the card's host, meta tensors only
            art = dryrun.run_cell(sizes["dry_arch"], sizes["dry_shape"],
                                  False, os.path.join(work, "dryrun"))
            print(f"[launch] (c) dryrun {dryrun.summarize(art)}", flush=True)
            cost = art["cost_analysis"]
            row = {"status": art["status"], "chips": art["chips"],
                   "trace_flops": cost["flops"],
                   "analytic_flops": art["cost_model"]["flops"],
                   "compile_s": art["compile_s"],
                   "peak_gb_a_device":
                       art["memory_analysis"]["peak_memory_in_bytes"] / 1e9,
                   "fits": art["memory_analysis"]["fits"],
                   "roofline": {k: art["roofline"][k] for k in
                                ("compute_s", "memory_s", "collective_s",
                                 "bottleneck")}}
            say("(c) dryrun", row)
            if art["status"] != "ok" or cost["flops"] is None or \
                    not art["memory_analysis"]["fits"]:
                fail(f"launch (c): {row}")
            rows["dryrun"] = row
        finally:
            os.chdir(cwd)
    return rows


#: the SPMD runtime (``models/spmd.py``), weight-gathered for (a)-(e) and
#: tensor-parallel for (f)-(h): (a) Llama-3.2-1B at
#: full width on a (data=2, model=2) mesh whose positions share the card,
#: ``tp_steps`` steps of ``tp_batch`` x ``tp_seq`` at lr 3e-4 against the
#: unsharded steps from the same params; (b) a prefill of ``pre_batch`` x
#: ``pre_seq``; (c) an elastic restore at the ``restore_scale``; (d) (a) and
#: (b) with a sparse FFN of ``sparse_density`` in tiles of ``sparse_tile``
#: (``examples/train_sparse_lm.py``'s settings); (e) ``family_steps`` steps
#: of each of ``families`` (arch, depth cut, (batch, seq)) and a prefill,
#: in ``family_dtype``: in bf16 AdamW's ratio turns the rounding of
#: near-zero gradient entries into whole updates of either sign, which the
#: floor run does not reproduce (Whisper's norm weights 3.7% against a
#: floor of 0.5% on an H100), so the families are held in f32 at 1e-3.
#: Decode on placed params under ``rules_for_cell``'s decode rules: (f) a
#: prefill of ``decode_batch`` x ``decode_prompt`` unsharded, its caches
#: placed, ``decode_steps`` teacher-forced steps against the unsharded
#: decode from the same caches; then batch 1 under the ``long_500k`` rules
#: on a cache of ``long_len`` positions filled from the seed (keys at
#: ``long_key_scale``), its sequence split over (data, model); both again
#: in f32 for ``witness_steps`` steps; (g) all of (f) with (d)'s sparse
#: FFN, K1 pr on each shard; (h) ``families`` at ``family_decode`` (batch,
#: prompt) in ``family_dtype``, ``family_decode_steps`` steps
TP = dict(arch="llama3.2-1b", scale="full", data=2, model=2, tp_steps=3,
          tp_batch=4, tp_seq=256, lr=3e-4, pre_batch=4, pre_seq=512,
          restore_scale="100m", restore_batch=8, restore_seq=256,
          sparse_density=0.15, sparse_tile=512, family_steps=2,
          families=(("zamba2-2.7b", {"num_layers": 12}, (4, 256)),
                    ("rwkv6-3b", {"num_layers": 4}, (4, 256)),
                    ("whisper-tiny", {}, (4, 64))),
          family_dtype="float32",
          decode_batch=4, decode_prompt=512, decode_steps=16,
          witness_steps=4, long_len=32768, long_key_scale=2.0,
          family_decode=(4, 64), family_decode_steps=4)


def _busy_ms(fn) -> tuple:
    """``(device busy ms, wall ms)`` of one call of ``fn`` under
    ``torch.profiler``: the union of the device events' intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # the device's activity alone on the card: a host-bound step's CPU
    # events (RWKV-6's token loop) cost more to collect than the step
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in device):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return out, busy_us / 1e3, 1e3 * wall


def tp_phase(ctx, sizes=TP):
    """Phase ``tp``: the weight-gathered SPMD runtime on a mesh whose
    positions share ``ctx.dev``, held to the unsharded run from the same
    params.  Returns the phase's rows."""
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist.placement import device_get
    from repro_torch.launch import make_local_mesh, train
    from repro_torch.launch.sharding_rules import SPARSE_WEIGHT_RULES
    from repro_torch.models import Model
    from repro_torch.models.config import SparseFFNConfig
    from repro_torch.models.sharding_ctx import activation_sharding
    from repro_torch.train import (OptConfig, TrainConfig, init_state,
                                   make_train_step)

    dev, fail, say = ctx.dev, ctx.fail, ctx.say
    n_pos = sizes["data"] * sizes["model"]
    rows = {}

    def mesh_of(data, model):
        return make_local_mesh(data, model, devices=[dev] * (data * model))

    def batch_of(gen, b, s, vocab):
        toks = torch.randint(0, vocab, (b, s + 1), generator=gen, device=dev)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # (a) full-width training: the unsharded steps, then the placed ones
    cfg = train.scale_config(sizes["arch"], sizes["scale"])
    model = Model(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=sizes["lr"], warmup_steps=0,
                                     total_steps=10_000))
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    init = model.init(gen, dev)
    batches = [batch_of(gen, sizes["tp_batch"], sizes["tp_seq"],
                        cfg.vocab_size) for _ in range(sizes["tp_steps"])]
    mesh = mesh_of(sizes["data"], sizes["model"])
    row, counts = _train_on_mesh(ctx, model, init, batches, mesh, tcfg)
    row = {"arch": cfg.name, "positions": n_pos, **row}
    say("(a) train", row)
    if any(n for c in counts for n in c.values()):
        fail(f"tp (a): the dense path launched {counts}")
    if not row["ok"]:
        fail(f"tp (a): {row}")
    rows["train"] = row

    # (b) prefill on the mesh against the unsharded prefill
    toks = batch_of(gen, sizes["pre_batch"], sizes["pre_seq"],
                    cfg.vocab_size)["tokens"]
    row, counts = _prefill_on_mesh(ctx, model, init, {"tokens": toks}, mesh,
                                   sizes["pre_seq"])
    row = {"batch": sizes["pre_batch"], "seq": sizes["pre_seq"], **row,
           "logits_spec": "(batch over data, vocab over model)"}
    say("(b) prefill", row)
    if not row["ok"] or any(counts.values()):
        fail(f"tp (b): {row} {counts}")
    rows["prefill"] = row
    del init
    gc_cuda()

    # (c) elastic restore at the 100m scale
    rcfg = train.scale_config(sizes["arch"], sizes["restore_scale"])
    rmodel = Model(rcfg)
    rstep = make_train_step(rmodel.loss_fn, tcfg)
    rinit = rmodel.init(torch.Generator(device=dev).manual_seed(ctx.seed), dev)
    rb = batch_of(gen, sizes["restore_batch"], sizes["restore_seq"],
                  rcfg.vocab_size)
    st, _ = train.place_state(rmodel, init_state(rinit, tcfg), mesh)
    st, _ = rstep(st, rb)
    saved = _flat_tree(device_get(st, dev))
    mesh41 = mesh_of(n_pos, 1)
    with tempfile.TemporaryDirectory() as work:
        mgr = CheckpointManager(work)
        mgr.save(1, st)
        _, sh41 = train.place_state(rmodel, init_state(rinit, tcfg), mesh41)
        back41 = mgr.restore(1, like=st, shardings=sh41)
        plain = mgr.restore(1, like=device_get(st, dev))
    same41 = all(torch.equal(v, saved[k]) for k, v in
                 _flat_tree(device_get(back41, dev)).items())
    same_plain = all(torch.equal(v, saved[k])
                     for k, v in _flat_tree(plain).items())
    # one more step from the restored state and from the state never saved,
    # both on the (4, 1) mesh: bit-equal
    direct, _ = train.place_state(rmodel, device_get(st, dev), mesh41)
    a, _ = rstep(back41, rb)
    b_, _ = rstep(direct, rb)
    step_equal = all(torch.equal(v, _flat_tree(device_get(b_, dev))[k])
                     for k, v in _flat_tree(device_get(a, dev)).items())
    row = {"scale": sizes["restore_scale"], "saved_mesh": dict(mesh.shape),
           "restored_mesh": dict(mesh41.shape),
           "restored_bit_equal": same41, "unplaced_bit_equal": same_plain,
           "next_step_bit_equal": step_equal,
           "leaves": len(saved)}
    say("(c) elastic restore", row)
    if not (same41 and same_plain and step_equal):
        fail(f"tp (c): {row}")
    rows["restore"] = row
    del st, back41, plain, direct, a, b_, rinit
    gc_cuda()

    # (d) the sparse FFN at full width: each value stream's tiles over data
    scfg = cfg.scaled(sparse_ffn=SparseFFNConfig(
        density=sizes["sparse_density"], tile=sizes["sparse_tile"]))
    smodel = Model(scfg)
    sgen = torch.Generator(device=dev).manual_seed(ctx.seed)
    sinit = smodel.init(sgen, dev)
    sbatches = [batch_of(sgen, sizes["tp_batch"], sizes["tp_seq"],
                         scfg.vocab_size) for _ in range(sizes["tp_steps"])]
    # a second floor: the unsharded step whose sparse matmuls split their
    # tiles over 2 shards of the sharded backend and sum the partials, as
    # each position's matmul does (the reference's shard_map)
    split = make_local_mesh(sizes["data"], 1,
                            devices=[dev] * sizes["data"])
    row, counts = _train_on_mesh(
        ctx, smodel, sinit, sbatches, mesh, tcfg,
        floor_scopes=[("tiles split over 2 shards",
                       lambda: activation_sharding(split,
                                                   SPARSE_WEIGHT_RULES))])
    pats = smodel.patterns
    tiles = pats["gate"][0].n_tiles
    nnz = int((pats["gate"][0].rows < scfg.d_ff).sum())
    vsh = train.param_placement(smodel, sinit, mesh)["blocks"]["ffn"]["v_up"]
    shards = sizes["data"] if vsh.spec[1] == "data" else 1
    # a step's K1 launches by the per-shard design: each position's program
    # runs one K1 a shard for each of its 3 matrices in each layer, again in
    # the recompute of the rematted block, and once more on the shard's
    # transposed slabs for dX; K6 one a shard a matrix a layer for dvals
    matmuls = n_pos * shards * 3 * scfg.num_layers
    want_k1 = matmuls * (3 if scfg.remat != "none" else 2)
    k1 = [c["vsr_spmm"] for c in counts]
    k6 = [c["sddmm"] for c in counts]
    others = {k: n for c in counts for k, n in c.items()
              if n and k not in ("vsr_spmm", "sddmm")}
    row = {"arch": scfg.name, "positions": n_pos,
           "sparse_ffn": {"density": sizes["sparse_density"],
                          "tile": sizes["sparse_tile"], "nnz_a_matrix": nnz,
                          "tiles_a_matrix": tiles,
                          "tiles_a_shard": -(-tiles // shards),
                          "v_spec": str(vsh.spec)},
           **row, "k1_launches_a_step": k1, "k1_designed_a_step": want_k1,
           "k6_launches_a_step": k6, "k6_designed_a_step": matmuls,
           "other_launches": others}
    say("(d) sparse FFN train", row)
    if not row["ok"] or any(n != want_k1 for n in k1) or \
            any(n != matmuls for n in k6) or others or shards != sizes["data"]:
        fail(f"tp (d): {row}")
    rows["sparse_train"] = row
    stoks = batch_of(sgen, sizes["pre_batch"], sizes["pre_seq"],
                     scfg.vocab_size)["tokens"]
    row, counts = _prefill_on_mesh(ctx, smodel, sinit, {"tokens": stoks},
                                   mesh, sizes["pre_seq"])
    want = n_pos * shards * 3 * scfg.num_layers
    row = {"batch": sizes["pre_batch"], "seq": sizes["pre_seq"], **row,
           "k1_launches": counts["vsr_spmm"], "k1_designed": want}
    say("(d) sparse FFN prefill", row)
    if not row["ok"] or counts["vsr_spmm"] != want or \
            any(n for k, n in counts.items() if k != "vsr_spmm"):
        fail(f"tp (d): {row} {counts}")
    rows["sparse_prefill"] = row
    del sinit, smodel, pats
    gc_cuda()

    # (e) the hybrid, SSM and audio families at full width, cut in depth
    for arch, cut, (fb, fs) in sizes["families"]:
        fcfg = train.scale_config(arch, sizes["scale"]).scaled(
            **cut, param_dtype=sizes["family_dtype"],
            compute_dtype=sizes["family_dtype"])
        fmodel = Model(fcfg)
        fgen = torch.Generator(device=dev).manual_seed(ctx.seed)
        finit = fmodel.init(fgen, dev)

        def fbatch(b, s, fcfg=fcfg, fgen=fgen):
            out = batch_of(fgen, b, s, fcfg.vocab_size)
            if fcfg.family == "audio":
                out["frames"] = torch.randn(
                    (b, fcfg.num_frames, fcfg.d_model), generator=fgen,
                    device=dev)
            return out
        fbatches = [fbatch(fb, fs) for _ in range(sizes["family_steps"])]
        row, counts = _train_on_mesh(ctx, fmodel, finit, fbatches, mesh, tcfg)
        pre = fbatch(fb, fs)
        pre.pop("labels")
        prow, pcounts = _prefill_on_mesh(ctx, fmodel, finit, pre, mesh, fs)
        row = {"arch": fcfg.name, "family": fcfg.family, "cut": cut,
               "layers": fcfg.num_layers, "batch": fb, "seq": fs,
               "positions": n_pos, **row, "prefill": prow}
        say(f"(e) {fcfg.family} {arch}", row)
        if not (row["ok"] and prow["ok"]) or \
                any(n for c in counts + [pcounts] for n in c.values()):
            fail(f"tp (e): {row} {counts} {pcounts}")
        rows[arch] = row
        del finit, fmodel, fbatches, pre
        gc_cuda()

    # (f)-(h) decode on placed params, tensor-parallel
    rows.update(_decode_parts(ctx, sizes, cfg, mesh))
    return rows


def _decode_parts(ctx, sizes, cfg, mesh) -> dict:
    """(f)-(h) of phase ``tp``: decode on placed params, tensor-parallel
    (``Model.decode_step`` on the (data, model) positions sharing the
    card, under ``rules_for_cell``'s decode rules), each held to the
    unsharded decode from the same caches.  Returns their rows."""
    import torch

    from repro_torch.launch import input_specs, train
    from repro_torch.models import SHAPES, Model
    from repro_torch.models.config import SparseFFNConfig

    dev, fail, say = ctx.dev, ctx.fail, ctx.say
    n_pos = mesh.size
    rows = {}
    cells = {c.name: c for c in SHAPES}
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 36)

    def tokens(b, n, vocab):
        return torch.randint(0, vocab, (b, n), generator=gen, device=dev)

    def rules_of(c, cell):
        return input_specs.rules_for_cell(cells[cell], c,
                                          model_axis=mesh.shape["model"])

    def long_caches(model, n):
        """Batch 1, ``long_len`` positions of keys and values from the
        seed, the last ``n`` slots free.  The keys are drawn at
        ``long_key_scale``: a query of unit-variance entries (the params'
        1/sqrt(fan_in) init on a normed input) then scores them with a
        spread of about that scale.  At 2 the softmax's mass lies on about
        600 of the 32,768 slots (N·exp(-2²)), spread over the shards, so
        the attention output is not the mean of random V and a fault in
        the split-KV merge moves the logits; at 3 (about one slot) the
        decode is chaotic: a rounding in another order picks another
        slot, and even the f32 decodes part."""
        caches = model.init_cache(1, sizes["long_len"], device=dev)
        for name, leaf in caches["kv"].items():
            x = torch.randn(leaf.shape, generator=gen, device=dev)
            leaf.copy_(x * sizes["long_key_scale"] if name == "k" else x)
        caches["length"].fill_(sizes["long_len"] - n)
        return caches

    def check(label, row, counts):
        say(label, row)
        if not row["ok"]:
            fail(f"tp {label}: {row}")
        return counts

    # (f) dense decode at full width, batch 4 after a prefill and batch 1
    # on a long cache split four ways
    def dense_and_long(model, tag, init, n):
        c = model.cfg
        prompt = tokens(sizes["decode_batch"], sizes["decode_prompt"],
                        c.vocab_size)
        steps = tokens(sizes["decode_batch"], n, c.vocab_size)
        with torch.no_grad():
            _, caches = model.prefill(init, {"tokens": prompt},
                                      sizes["decode_prompt"] + n)
        row, counts = _decode_on_mesh(ctx, model, init, caches, steps, mesh,
                                      rules_of(c, "decode_32k"))
        row = {"arch": c.name, "batch": sizes["decode_batch"],
               "prompt": sizes["decode_prompt"], **row}
        out = {"decode": (row, check(f"({tag}) decode", row, counts))}
        del caches
        gc_cuda()
        caches = long_caches(model, n)
        row, counts = _decode_on_mesh(
            ctx, model, init, caches, tokens(1, n, c.vocab_size), mesh,
            rules_of(c, "long_500k"))
        row = {"arch": c.name, "batch": 1, "cache": sizes["long_len"],
               "cache_split": "(data, model)",
               "key_scale": sizes["long_key_scale"], **row}
        out["long"] = (row, check(f"({tag}) decode long_500k", row, counts))
        del caches
        gc_cuda()
        return out

    # in bf16 first, then the same model in f32, the witness: a mesh
    # decode whose every product and merge is exact to f32 rounding
    for dtype, tag, n in (("bfloat16", "f", sizes["decode_steps"]),
                          ("float32", "f f32", sizes["witness_steps"])):
        model = Model(cfg.scaled(param_dtype=dtype, compute_dtype=dtype))
        init = model.init(torch.Generator(device=dev).manual_seed(ctx.seed),
                          dev)
        out = dense_and_long(model, tag, init, n)
        for key, (row, counts) in out.items():
            if any(counts_step[k] for counts_step in counts
                   for k in counts_step):
                fail(f"tp ({tag}) {key}: the dense path launched {counts}")
            rows[f"dense_{key}" if dtype == cfg.compute_dtype
                 else f"dense_{key}_{dtype}"] = row
        del init, model
        gc_cuda()

    # (g) the same with (d)'s sparse FFN: K1 pr on each shard's piece, in
    # bf16 and again in f32, the witness (on the long cache the bf16
    # decodes' own rounding moves the logits by tens of percent)
    scfg = cfg.scaled(sparse_ffn=SparseFFNConfig(
        density=sizes["sparse_density"], tile=sizes["sparse_tile"]))
    patterns = None
    for dtype, tag, steps in (("bfloat16", "g", sizes["decode_steps"]),
                              ("float32", "g f32", sizes["witness_steps"])):
        smodel = Model(scfg.scaled(param_dtype=dtype, compute_dtype=dtype),
                       patterns=patterns)
        patterns = smodel.patterns
        sinit = smodel.init(torch.Generator(device=dev).manual_seed(
            ctx.seed), dev)
        shards = {}
        for key, cell in (("decode", "decode_32k"), ("long", "long_500k")):
            sh = train.param_placement(smodel, sinit, mesh,
                                       rules_of(smodel.cfg, cell))
            v = sh["blocks"]["ffn"]["v_up"].spec
            shards[key] = mesh.shape["data"] if v[1] == "data" else 1
        out = dense_and_long(smodel, tag, sinit, steps)
        for key, (row, counts) in out.items():
            want = n_pos * shards[key] * 3 * scfg.num_layers
            k1 = [c["vsr_spmm"] for c in counts]
            designs = row.pop("k1_designs")
            others = {k: n for c in counts for k, n in c.items()
                      if n and k != "vsr_spmm"}
            row.update(k1_launches_a_step=k1, k1_designed_a_step=want,
                       k1_designs_a_step=designs, shards=shards[key],
                       other_launches=others)
            say(f"({tag}) sparse FFN decode {key} launches", {
                k: row[k] for k in ("k1_launches_a_step",
                                    "k1_designed_a_step",
                                    "k1_designs_a_step", "other_launches")})
            if any(n != want for n in k1) or others or \
                    any(d != {"pr": want, "sr": 0} for d in designs) or \
                    shards[key] != mesh.shape["data"]:
                fail(f"tp ({tag}) {key}: K1 {k1} by design {designs}, "
                     f"expected {want} pr a step; others {others}")
            rows[f"sparse_{key}" if dtype == cfg.compute_dtype
                 else f"sparse_{key}_{dtype}"] = row
        if dtype == cfg.compute_dtype:
            rows["k1_decode"] = _k1_decode_shard(ctx, smodel, sinit, mesh,
                                                 sizes, rows)
        del sinit, smodel
        gc_cuda()

    # (h) the hybrid, SSM and audio families at full width, cut in depth
    fb, fs = sizes["family_decode"]
    for arch, cut, _ in sizes["families"]:
        fcfg = train.scale_config(arch, sizes["scale"]).scaled(
            **cut, param_dtype=sizes["family_dtype"],
            compute_dtype=sizes["family_dtype"])
        fmodel = Model(fcfg)
        finit = fmodel.init(torch.Generator(device=dev).manual_seed(
            ctx.seed), dev)
        batch = {"tokens": tokens(fb, fs, fcfg.vocab_size)}
        if fcfg.family == "audio":
            batch["frames"] = torch.randn(
                (fb, fcfg.num_frames, fcfg.d_model), generator=gen,
                device=dev)
        with torch.no_grad():
            _, caches = fmodel.prefill(finit, batch,
                                       fs + sizes["family_decode_steps"])
        row, counts = _decode_on_mesh(
            ctx, fmodel, finit, caches,
            tokens(fb, sizes["family_decode_steps"], fcfg.vocab_size),
            mesh, rules_of(fcfg, "decode_32k"),
            memory=fcfg.num_frames if fcfg.family == "audio" else 0)
        row = {"arch": fcfg.name, "family": fcfg.family, "cut": cut,
               "layers": fcfg.num_layers, "batch": fb, "prompt": fs,
               **row}
        check(f"(h) decode {fcfg.family} {arch}", row, counts)
        if any(n for c in counts for n in c.values()):
            fail(f"tp (h) {arch}: launched {counts}")
        rows[f"decode_{arch}"] = row
        del finit, fmodel, caches
        gc_cuda()
    return rows


def _decode_on_mesh(ctx, model, init, caches, steps, mesh, rules,
                    memory: int = 0) -> tuple:
    """Teacher-forced decode of ``steps`` (B, n) from ``caches``,
    unsharded, then on ``mesh`` (params placed by ``param_placement``
    under ``rules``, the caches by ``Model.cache_shardings``; each step
    driven on path ``tp``): ``(row, each placed step's launches by
    kernel)``.  ``row["ok"]``: each step's collective log (position (0,
    0)'s program) equal to ``dryrun.plan_collectives`` record for record,
    and the outputs right.  In f32, every step's logits and every cache
    leaf after the last within ``RTOL`` (relative inf-norm) of the
    unsharded decode's.  In bf16 both decodes are held to one truth, the
    same unsharded decode in f32 (params and caches cast): the placed
    decode's logits and each cache leaf within twice the unsharded bf16
    decode's own distance from it.  A mesh rounds its split-KV merge and
    its row-parallel sums in another order, and one flipped bf16 rounding
    spreads through the layers to the size of the bf16 decode's own
    rounding error, so the distance between the two bf16 decodes
    (``logits_rel_err``, reported beside ``RTOL``) is no measure of
    either's fault; the f32 witness parts hold the mesh's arithmetic
    itself.  The last placed step runs under the profiler (device-busy
    ms)."""
    import torch

    from repro_torch.dist.placement import device_get, device_put
    from repro_torch.kernels import vsr
    from repro_torch.launch import dryrun, train
    from repro_torch.models import Model, spmd
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.sharding_ctx import activation_sharding

    dev = ctx.dev
    on_card = dev.type == "cuda"
    t_start = time.perf_counter()
    tol = ctx.rtol[model.cfg.compute_dtype]
    n = steps.shape[1]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / \
            max(float(want.float().abs().max()), 1e-30)

    with torch.no_grad():
        want, plain_ms, c = [], [], caches
        for i in range(n):
            t0 = time.perf_counter()
            logits, c = model.decode_step(init, c, steps[:, i:i + 1])
            sync()
            plain_ms.append(1e3 * (time.perf_counter() - t0))
            want.append(logits)
        want_caches = _flat_tree(c)
        del c
        # bf16: the truth both decodes are held to, the unsharded decode
        # in f32, and the unsharded bf16 decode's distance from it
        truth = truth_caches = None
        floor, floor_cache = 0.0, {}
        if model.cfg.compute_dtype != "float32":
            f32 = Model(model.cfg.scaled(param_dtype="float32",
                                         compute_dtype="float32"),
                        patterns=model.patterns)

            def up(tree):
                if isinstance(tree, dict):
                    return {k: up(v) for k, v in tree.items()}
                return tree.float() if tree.is_floating_point() else tree
            c, p32, truth = up(caches), up(init), []
            for i in range(n):
                logits, c = f32.decode_step(p32, c, steps[:, i:i + 1])
                truth.append(logits)
                floor = max(floor, rel(want[i], logits))
            truth_caches = _flat_tree(c)
            floor_cache = {k: rel(w, truth_caches[k])
                           for k, w in want_caches.items()}
            del c, p32, f32
            gc_cuda()
        placed = device_put(init, train.param_placement(model, init, mesh,
                                                        rules))
        pc = device_put(caches, model.cache_shardings(caches, mesh, rules))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        max_len = next((v.shape[-2] for key, v in _flat_tree(caches).items()
                        if key.endswith(".k")), 1)
        cell = ShapeCell("tp", max_len, steps.shape[0], "decode")
        plan = {}
        for r in dryrun.plan_collectives(model, cell, mesh, rules,
                                         memory=memory):
            key = (r.kind, r.axes, r.n, r.bytes)
            plan[key] = plan.get(key, 0) + r.count
        errs, errs_truth, walls, counts, designs, logs_ok = \
            [], [], [], [], [], []
        busy = wall_prof = None
        with activation_sharding(mesh, rules):
            for i in range(n):
                def run(i=i):
                    return ctx.drive(lambda: model.decode_step(
                        placed, pc, steps[:, i:i + 1]), "tp")
                with spmd.collective_log() as log:
                    if i == n - 1:          # the last step under the profiler
                        ((got, pc), cnt), busy, wall_prof = _busy_ms(run)
                        t = wall_prof
                    else:
                        t0 = time.perf_counter()
                        (got, pc), cnt = run()
                        t = 1e3 * (time.perf_counter() - t0)
                counts.append(cnt)
                designs.append({d: v for d, v in
                                vsr.DESIGN_LAUNCHES["vsr_spmm"].items()})
                walls.append(t)
                got = device_get(got, dev)
                errs.append(rel(got, want[i]))
                if truth is not None:
                    errs_truth.append(rel(got, truth[i]))
                ran = {}
                for r in log.program((0,) * len(mesh.axis_names)):
                    key = (r.kind, r.axes, r.n, r.bytes)
                    ran[key] = ran.get(key, 0) + r.count
                logs_ok.append(ran == plan)
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        got_caches = _flat_tree(device_get(pc, dev))
    cache_errs = {k: rel(got_caches[k], w) for k, w in want_caches.items()}
    worst = max(cache_errs, key=cache_errs.get)
    by_kind = {}
    for (kind, _, _, nbytes), cnt in plan.items():
        by_kind[kind] = by_kind.get(kind, 0) + nbytes * cnt
    finite = all(math.isfinite(e) for e in errs)
    if truth is None:
        right = max(errs) <= tol and cache_errs[worst] <= tol
        held = {}
    else:
        truth_errs = {k: rel(got_caches[k], w)
                      for k, w in truth_caches.items()}
        over = {k: [e, floor_cache[k]] for k, e in truth_errs.items()
                if not e <= 2 * floor_cache[k]}
        right = max(errs_truth) <= 2 * floor and not over
        held = {"logits_rel_err_to_f32": max(errs_truth),
                "unsharded_logits_rel_err_to_f32": floor,
                "cache_rel_err_to_f32": truth_errs,
                "unsharded_cache_rel_err_to_f32": floor_cache,
                "cache_leaves_over": over}
    ok = right and finite and all(logs_ok)
    row = {"mesh": dict(mesh.shape), "dtype": model.cfg.compute_dtype,
           "steps": n, "logits_rel_err": max(errs),
           "worst_cache_leaf": [worst, cache_errs[worst]], "tol": tol,
           **held,
           "logs_equal_plan": all(logs_ok), "plan_bytes_a_step": by_kind,
           "step_ms": walls, "step_ms_profiled_last": wall_prof,
           "device_busy_ms_last": busy, "unsharded_step_ms": plain_ms,
           "peak_gb": peak, "k1_designs": designs, "ok": ok,
           "section_s": time.perf_counter() - t_start}
    del placed, pc, got_caches, want_caches, want, truth, truth_caches
    gc_cuda()
    return row, counts


def _k1_decode_shard(ctx, smodel, sinit, mesh, sizes, rows) -> dict:
    """K1 pr on one shard of the sparse FFN at decode: layer 0's up
    projection (d_ff x d_model), the tiles of data shard 0, at the
    columns a position gives it (N = 2 at batch 4 over data, N = 1 at
    batch 1): the wrapper against its plain version on the same inputs,
    its time, the plain version's, ``torch.sparse.mm``'s on the shard's
    CSR and the bound of §2 in the stream's type (a slot's value and its
    int32 row and column, 10 bytes in bf16; x read, the f32 Y written).
    ``ms`` is one call between two events, the host's launch included;
    ``device_ms`` the device's busy time a call over 20 back-to-back
    calls under the profiler, and ``back_to_back_ms`` their wall time a
    call: what of ``ms`` is the host's."""
    import torch

    from repro_torch.core.formats import BalancedCOO
    from repro_torch.kernels import launch_counts, reset_launch_counts, vsr

    dev, fail = ctx.dev, ctx.fail
    pat = smodel.patterns["up"][0]
    n_sh = mesh.shape["data"]
    per = -(-pat.n_tiles // n_sh)
    rows_, cols_ = pat.rows[:per].contiguous(), pat.cols[:per].contiguous()
    vals = sinit["blocks"]["ffn"]["v_up"][0][:per].contiguous()
    m, k = pat.shape
    bal = BalancedCOO(rows_, cols_, vals, (m, k))
    keep = rows_.reshape(-1) < m
    nnz = int(keep.sum())
    csr = torch.sparse_coo_tensor(
        torch.stack([rows_.reshape(-1)[keep].long(),
                     cols_.reshape(-1)[keep].long()]),
        vals.reshape(-1)[keep], (m, k)).coalesce().to_sparse_csr()
    out = {"matrix": f"layer 0 up {m}x{k}, data shard 0 of {n_sh}",
           "tiles": per, "tile": pat.rows.shape[1], "slots": per *
           pat.rows.shape[1], "nnz": nnz, "dtype": str(vals.dtype)}
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 37)
    for n, key in ((2, "decode"), (1, "long")):
        x = torch.randn((k, n), generator=gen, device=dev).to(vals.dtype)
        reset_launch_counts()
        y = vsr.spmm_vsr_fused(bal, x, "pr")
        torch.cuda.synchronize()
        launched = launch_counts()["vsr_spmm"]
        pr = vsr.DESIGN_LAUNCHES["vsr_spmm"]["pr"]
        plain = vsr.spmm_vsr_plain(bal, x)
        diff = float((y.float() - plain.float()).abs().max())
        rel = diff / max(float(plain.float().abs().max()), 1e-30)
        if launched != 1 or pr != 1 or not rel <= ctx.rtol["bfloat16"]:
            fail(f"tp K1 pr decode shard N={n}: launches {launched} (pr {pr}),"
                 f" rel err {rel:.3e}")
        nbytes = ((8 + vals.element_size()) * per * pat.rows.shape[1]
                  + x.element_size() * k * n + 4 * m * n)
        flops = 2 * nnz * n
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOP_PER_S * 1e3
        step_launches = rows.get(f"sparse_{key}", {}).get(
            "k1_launches_a_step")
        try:
            lib = ctx.time_ms(lambda: torch.sparse.mm(csr, x))
            lib_dtype = str(vals.dtype)
        except RuntimeError:        # no bf16 cuSPARSE product on this build
            csr32, x32 = csr.to(torch.float32), x.float()
            lib = ctx.time_ms(lambda: torch.sparse.mm(csr32, x32))
            lib_dtype = "float32"
        def calls(reps=20):
            for _ in range(reps):
                vsr.spmm_vsr_fused(bal, x, "pr")
        _, busy, wall = _busy_ms(calls)
        out[f"N={n}"] = {
            "ms": ctx.time_ms(lambda: vsr.spmm_vsr_fused(bal, x, "pr")),
            "device_ms": busy / 20, "back_to_back_ms": wall / 20,
            "plain_ms": ctx.time_ms(lambda: vsr.spmm_vsr_plain(bal, x)),
            "library_ms": lib, "library": f"torch.sparse.mm ({lib_dtype})",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": diff, "rel_err": rel,
            "launches_a_step": step_launches[-1] if step_launches else None}
    ctx.say("(g) K1 pr on a decode shard", out)
    return out


def _leaf_errors(plain_final, flat_init, plain_m, params, moments) -> dict:
    """Each leaf's change (params − init) and f32 first moment against the
    unsharded run's: relative 2-norm errors."""
    out = {}
    for k, final in plain_final.items():
        start = flat_init[k].float()
        want = final.float() - start
        ce = float((params[k].float() - start - want).norm())
        mw = plain_m[k].float()
        me = float((moments[k].float() - mw).norm())
        out[k] = (ce / max(float(want.norm()), 1e-30),
                  me / max(float(mw.norm()), 1e-30))
    return out


#: a leaf's change and first moment on the mesh against the unsharded
#: run's (relative 2-norm), by the params' type, unless twice the floor
#: run's error is larger
LEAF_TOL = {"bfloat16": 2e-2, "float32": 1e-3}


def _train_on_mesh(ctx, model, init, batches, mesh, tcfg,
                   floor_scopes=()) -> tuple:
    """The steps of ``batches`` unsharded, then the floor runs, then on
    ``mesh`` (driven, on path ``tp``), all from the same params ``init``:
    ``(row, each placed step's launches by kernel)``.  A floor run is the
    unsharded step computed another way the mesh also computes it: in 2
    microbatches (the gradients of two halves of the rows summed, as the
    mesh's batch split sums them), and in each ``(name, scope)`` of
    ``floor_scopes``, the unsharded step run inside ``scope()``.
    ``row["ok"]``: each loss within ``RTOL`` of the params' type (relative)
    of the unsharded step's, each leaf's change and f32 first moment within
    ``LEAF_TOL`` of their size (2-norm), either or twice the floor runs'
    largest error, whichever is larger, and the collective log's bytes a
    step by kind (position (0, 0)'s program) equal to
    ``dryrun.plan_collectives``.  The last placed step runs under the
    profiler (device-busy ms)."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.dist.placement import device_get
    from repro_torch.launch import dryrun, train
    from repro_torch.models import spmd
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import init_state, make_train_step

    dev = ctx.dev
    on_card = dev.type == "cuda"
    t_start = time.perf_counter()
    dtype = model.cfg.param_dtype
    step = make_train_step(model.loss_fn, tcfg)
    state = init_state(init, tcfg)
    plain_losses, plain_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        if on_card:
            torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t0))
        plain_losses.append(float(m["loss"]))
    flat_init = _flat_tree(init)
    plain_final = _flat_tree(state["params"])
    plain_m = _flat_tree(state["opt"]["m"])
    del state, m
    gc_cuda()
    mstep = make_train_step(model.loss_fn,
                            dataclasses.replace(tcfg, microbatches=2))
    floor, floor_loss = None, 0.0
    for fstep, scope in ((mstep, contextlib.nullcontext),
                         *((step, sc) for _, sc in floor_scopes)):
        state = init_state(init, tcfg)
        with scope():
            for b, want in zip(batches, plain_losses):
                state, m = fstep(state, b)
                floor_loss = max(floor_loss,
                                 abs(float(m["loss"]) - want) / abs(want))
        errs = _leaf_errors(plain_final, flat_init, plain_m,
                            _flat_tree(state["params"]),
                            _flat_tree(state["opt"]["m"]))
        floor = errs if floor is None else {
            k: tuple(map(max, e, floor[k])) for k, e in errs.items()}
        del state, m
        gc_cuda()
    pstate, _ = train.place_state(model, init_state(init, tcfg), mesh)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, walls, logs, counts = [], [], [], []
    busy = wall_prof = None
    for i, b in enumerate(batches):
        def run(b=b):
            return ctx.drive(lambda: step(pstate, b), "tp")
        with spmd.collective_log() as log:
            if i == len(batches) - 1:       # the last step under the profiler
                ((pstate, m), c), busy, wall_prof = _busy_ms(run)
                t = wall_prof
            else:
                t0 = time.perf_counter()
                (pstate, m), c = run()
                t = 1e3 * (time.perf_counter() - t0)
        counts.append(c)
        walls.append(t)
        losses.append(float(m["loss"]))
        logs.append(log.bytes_by_kind((0, 0)))
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    got = _flat_tree(device_get(pstate["params"], dev))
    # bf16 params and gradients: a step's update of lr 3e-4 is ~2.5 spacings
    # of a weight of 0.02, and the mesh sums the bf16 gradients of its row
    # halves where the unsharded step rounds once, so each leaf is held to
    # 2e-2 of its change's (and first moment's) size or to twice the floor
    # run's error, whichever is larger (f32: 1e-3)
    errs = _leaf_errors(plain_final, flat_init, plain_m, got,
                        _flat_tree(device_get(pstate["opt"]["m"], dev)))
    bad = {k: (e, floor[k]) for k, e in errs.items()
           if any(x > max(LEAF_TOL[dtype], 2 * f)
                  for x, f in zip(e, floor[k]))}
    worst_c = max(errs, key=lambda k: errs[k][0])
    worst_m = max(errs, key=lambda k: errs[k][1])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    b0 = batches[0]["tokens"]
    cell = ShapeCell("tp", b0.shape[1], b0.shape[0], "train")
    plan = {}
    for r in dryrun.plan_collectives(model, cell, mesh,
                                     train.train_rules(model.cfg)):
        plan[r.kind] = plan.get(r.kind, 0) + r.bytes * r.count
    ok = (max(rel) <= max(ctx.rtol[dtype], 2 * floor_loss) and not bad
          and all(log == plan for log in logs)
          and all(math.isfinite(x) for x in losses))
    row = {"mesh": dict(mesh.shape), "dtype": dtype, "losses": losses,
           "unsharded_losses": plain_losses, "loss_rel_err": max(rel),
           "floor_runs": ["microbatches=2"] + [n for n, _ in floor_scopes],
           "floor_loss_rel_err": floor_loss,
           "worst_leaf_change": [worst_c, errs[worst_c][0],
                                 floor[worst_c][0]],
           "worst_leaf_m": [worst_m, errs[worst_m][1], floor[worst_m][1]],
           "leaves_over_tol": sum(max(e) > LEAF_TOL[dtype]
                                  for e in errs.values()),
           "leaves_over_bound": bad,
           "step_ms": walls, "step_ms_profiled_last": wall_prof,
           "device_busy_ms_last": busy, "unsharded_step_ms": plain_ms,
           "peak_gb": peak, "log_bytes_a_step": logs[-1],
           "plan_bytes_a_step": plan, "ok": ok,
           "section_s": time.perf_counter() - t_start}
    del pstate, got
    gc_cuda()
    return row, counts


def _prefill_on_mesh(ctx, model, init, batch, mesh, max_len) -> tuple:
    """A prefill on ``mesh`` (driven, on path ``tp``) against the unsharded
    prefill from the same params: ``(row, its launches by kernel)``;
    ``row["ok"]``: the last position's logits within ``RTOL`` of the
    params' type of the largest unsharded logit."""
    import torch

    from repro_torch.dist.placement import device_get, device_put
    from repro_torch.launch import train

    with torch.no_grad():
        want, _ = model.prefill(init, batch, max_len)
        placed = device_put(init, train.param_placement(model, init, mesh))
        t0 = time.perf_counter()
        (logits, _), counts = ctx.drive(
            lambda: model.prefill(placed, batch, max_len), "tp")
        pre_ms = 1e3 * (time.perf_counter() - t0)
        logits = device_get(logits, ctx.dev)
    err = float((logits.float() - want.float()).abs().max()) / \
        float(want.float().abs().max())
    del placed
    return {"logits_rel_err": err, "prefill_ms": pre_ms,
            "ok": err <= ctx.rtol[model.cfg.param_dtype]}, counts


def _flat_tree(tree, prefix=""):
    """``{"a.b": leaf}`` of nested dicts."""
    if isinstance(tree, dict):
        return {k: v for name in tree
                for k, v in _flat_tree(tree[name], f"{prefix}{name}.").items()}
    return {prefix[:-1]: tree}


def gc_cuda():
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


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
    from repro_torch.core import formats, quant, registry, stats
    from repro_torch.core.cache import pattern_fingerprint
    from repro_torch.core.guardrails import plan_digest
    from repro_torch.core.plan import (PATTERN_PREP, _ChainVJP,
                                       _stream_to_balanced, execute,
                                       execute_attention, pattern_prep)
    from repro_torch.core.vjp import (_fill_bsr, _stream_to_ell, attn_bwd_plain,
                                      bsr_bwd_plain, chain_bwd_plain,
                                      coo_bwd_plain)
    from repro_torch.examples import train_gat
    from repro_torch.core.rmat import rmat
    from repro_torch.kernels import (_build, attention, bsr, csc, fused_chain,
                                     launch_counts, reset_launch_counts, spmv,
                                     vsr)
    from repro_torch.models import SparseFFN, rmsnorm, transformer
    from repro_torch.models.config import SparseFFNConfig
    from repro_torch.train import (OptConfig, TrainConfig, adamw_update,
                                   init_state, make_train_step)

    t_start = time.perf_counter()

    from repro_torch.core.guardrails import HEALTH
    current_phase = [None]

    def phase(name):
        """Start phase ``name``; the phase that ends must leave the
        guardrails' ladder untouched unless it is the guardrails phase."""
        ended = current_phase[0]
        if ended is not None and ended != "guardrails":
            snap = HEALTH.snapshot()
            if snap["counters"]:
                print(f"[health] {ended} {json.dumps(snap['counters'])}",
                      flush=True)
            moved = {k: v for k, v in snap["counters"].items()
                     if k.startswith(("kernel_failure:", "kernel_reroute:",
                                      "breaker_skip:", "sentinel_fallback:"))}
            tripped = {k: b for k, b in snap["breakers"].items()
                       if b["trips"] or b["state"] != "closed"}
            if moved or tripped:
                fail(f"{ended}: a kernel of the path failed or was "
                     f"rerouted: {moved} {tripped}")
            HEALTH.reset()           # the next [health] line is its phase's
        current_phase[0] = name
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
    # the guardrails phase's "fault_launch" library, built meanwhile
    import threading
    fault_build = {}

    def build_fault_launch():
        try:
            fault_build["result"] = _build.build("fault_launch")
        except RuntimeError as err:
            print(f"[build] fault_launch: {err}", file=sys.stderr, flush=True)
    fault_thread = threading.Thread(target=build_fault_launch)
    fault_thread.start()
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
    # over the float32 checks
    max_abs = {k: 0.0 for k in (*KERNELS, *CODED_KEYS)}

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
    bals = {"g500": g500_bal, "unif": unif_bal}
    unif_ell = formats.csr_to_ell(graphs["unif"])
    k_dim = graphs["g500"].shape[1]
    empties = {name: torch.diff(csr.indptr) == 0 for name, csr in graphs.items()}

    def sddmm_plain_chunked(rows, cols, a, b, shape, tiles=2048):
        """K6's plain version, a chunk of tiles at a time (at d = 256 on g500
        its gathers would hold 16 GB each)."""
        return torch.cat([fused_chain.sddmm_plain(rows[i:i + tiles],
                                                  cols[i:i + tiles], a, b,
                                                  shape=shape)
                          for i in range(0, rows.shape[0], tiles)])

    def hold_empty(kernel, label, y):
        """The rows of the graph with no nonzero: exactly 0."""
        if not (y[empties[label.split()[0]]] == 0).all():
            fail(f"{kernel} {label}: an empty row is not exactly 0")

    # K1's two designs, forced: sr (nb_sr, the pick on g500 at N = 32 and
    # 128) and pr (nb_pr, the pick at N = 4), and each at the other's N
    for design, name, n, dtype in (
            ("sr", "g500", 32, torch.float32), ("sr", "g500", 128, torch.float32),
            ("pr", "g500", 4, torch.float32), ("pr", "unif", 4, torch.float32),
            ("pr", "g500", 32, torch.float32), ("sr", "g500", 4, torch.float32),
            ("sr", "g500", 32, torch.bfloat16), ("pr", "g500", 4, torch.bfloat16)):
        x = randn(k_dim, n, dtype=dtype)
        y = vsr.spmm_vsr_fused(bals[name], x, design)
        hold_empty("vsr_spmm", f"{name} N={n} {design}", y)
        hold("vsr_spmm", f"{name} N={n} {design}", y,
             vsr.spmm_vsr_plain(bals[name], x), str(dtype).split(".")[1])
    for name, bal in bals.items():
        x = randn(k_dim)
        y = spmv.spmv_vsr_fused(bal, x)
        hold_empty("vsr_spmv", f"{name} N=1", y)
        hold("vsr_spmv", f"{name} N=1", y, spmv.spmv_vsr_plain(bal, x), "float32")
    del y
    # K3's two designs at the main path's N (sr, the pick at 32 and 128)
    # and at N = 1 and 4 (pr, forced: the selector picks K2/K1 there)
    for design, n, dtype in (("sr", 32, torch.float32), ("sr", 128, torch.float32),
                             ("pr", 1, torch.float32), ("pr", 4, torch.float32),
                             ("sr", 32, torch.bfloat16), ("pr", 4, torch.bfloat16)):
        x = randn(k_dim, n, dtype=dtype)
        hold("csc_spmm", f"unif N={n} {design}", csc.spmm_csc(unif_ell, x, design),
             csc.spmm_csc_plain(unif_ell, x), str(dtype).split(".")[1])
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
            part = spmv.spmv_vsr_partials(unif_bal, x, base, win)
            hold("vsr_spmv_spill", f"unif N=1 partials", part,
                 vsr.spill_partials_plain(unif_bal, x[:, None], base, win)[..., 0], dt)
            hold("vsr_spmv_spill", "unif N=1", spmv.spmv_vsr(unif_bal, x, **kw),
                 spmv.spmv_vsr_spill_plain(unif_bal, x, **kw), dt)
        else:
            x = randn(k_dim, n, dtype=dtype)
            part = vsr.spmm_vsr_partials(unif_bal, x, base, win)
            hold("vsr_spmm_spill", f"unif N={n} partials", part,
                 vsr.spill_partials_plain(unif_bal, x, base, win), dt)
            hold("vsr_spmm_spill", f"unif N={n}", vsr.spmm_vsr(unif_bal, x, **kw),
                 vsr.spmm_vsr_spill_plain(unif_bal, x, **kw), dt)
        # the combine on the kernel's partials (float32 whatever X is)
        hold("spill_combine", f"unif N={n} ({dt} X)",
             vsr.spill_combine(part, base, unif_bal.shape[0]),
             vsr.spill_combine_plain(part, base, unif_bal.shape[0]), "float32")
        del part
        torch.cuda.empty_cache()

    # the coded variants of K1, K2, K4 and K5: int8 / fp8 codes with one f32
    # scale a tile (the reference's quant branches), each against its plain
    # version (decode, then the float math).  K1's sr design at N = 4 stages
    # 8 tiles of 512 a CTA, each with its own scale
    def dname(dtype):
        return str(dtype).split(".")[1]

    for mode in QUANT_MODES:
        cbals = {}
        for name, bal in bals.items():
            q, sc = quant.quantize_stream(bal.vals, mode)
            cbals[name] = (formats.BalancedCOO(bal.rows, bal.cols, q, bal.shape), sc)
        key = f"vsr_spmm:{mode}"
        for design, name, n, dtype in (
                ("sr", "g500", 32, torch.float32), ("sr", "g500", 128, torch.float32),
                ("sr", "g500", 4, torch.float32), ("pr", "g500", 4, torch.float32),
                ("pr", "unif", 4, torch.float32), ("sr", "g500", 32, torch.bfloat16),
                ("pr", "g500", 4, torch.bfloat16)):
            cb, sc = cbals[name]
            x = randn(k_dim, n, dtype=dtype)
            y = vsr.spmm_vsr_fused(cb, x, design, scales=sc)
            hold_empty(key, f"{name} N={n} {design}", y)
            hold(key, f"{name} N={n} {design}", y, vsr.spmm_vsr_plain(cb, x, sc),
                 dname(dtype))
        key = f"vsr_spmv:{mode}"
        for name, (cb, sc) in cbals.items():
            for dtype in (torch.float32, torch.bfloat16):
                x = randn(k_dim, dtype=dtype)
                y = spmv.spmv_vsr_fused(cb, x, scales=sc)
                hold_empty(key, f"{name} N=1", y)
                hold(key, f"{name} N=1", y, spmv.spmv_vsr_plain(cb, x, sc),
                     dname(dtype))
        cb, sc = cbals["unif"]
        for n, dtype in ((1, torch.float32), (4, torch.float32),
                         (32, torch.float32), (128, torch.float32),
                         (32, torch.bfloat16)):
            kw = dict(row_base=base, win=win, scales=sc)
            if n == 1:
                key = f"vsr_spmv_spill:{mode}"
                x = randn(k_dim, dtype=dtype)
                hold(key, "unif N=1 partials",
                     spmv.spmv_vsr_partials(cb, x, base, win, scales=sc),
                     vsr.spill_partials_plain(cb, x[:, None], base, win, sc)[..., 0],
                     dname(dtype))
                hold(key, "unif N=1", spmv.spmv_vsr(cb, x, **kw),
                     spmv.spmv_vsr_spill_plain(cb, x, **kw), dname(dtype))
            else:
                key = f"vsr_spmm_spill:{mode}"
                x = randn(k_dim, n, dtype=dtype)
                hold(key, f"unif N={n} partials",
                     vsr.spmm_vsr_partials(cb, x, base, win, scales=sc),
                     vsr.spill_partials_plain(cb, x, base, win, sc), dname(dtype))
                hold(key, f"unif N={n}", vsr.spmm_vsr(cb, x, **kw),
                     vsr.spmm_vsr_spill_plain(cb, x, **kw), dname(dtype))
        del cbals, cb, sc
        torch.cuda.empty_cache()

    # the chain's kernels: a GAT layer's scores A·Bᵀ, A and B (2^20, 64)
    feats = {name: (0.3 * randn(csr.shape[0], CHAIN_D),
                    0.3 * randn(csr.shape[1], CHAIN_D))
             for name, csr in graphs.items()}
    for name, bal in bals.items():
        pat = (bal.rows, bal.cols, *feats[name])
        hold("sddmm", name, fused_chain.sddmm_fused(*pat, shape=bal.shape),
             fused_chain.sddmm_plain(*pat, shape=bal.shape), "float32")
    # K6's two designs, forced: "seq" (a thread a slot) at d = 1 and 4 (the
    # backward's dvals at N = 1 and 4), "par" (lane groups split d) at the
    # GAT layer's d = 64 in float32 and bfloat16 and at d = 256 on g500;
    # padding slots exactly 0
    for design, d, dtype, names in SDDMM_FORCED:
        for name in names:
            bal = bals[name]
            m_, k_ = bal.shape
            a = 0.3 * randn(m_, d, dtype=getattr(torch, dtype))
            b = 0.3 * randn(k_, d, dtype=getattr(torch, dtype))
            reset_launch_counts()
            e = fused_chain._launch_sddmm(design, bal.rows, bal.cols, a, b,
                                          shape=bal.shape)
            if fused_chain.DESIGN_LAUNCHES["sddmm"][design] != 1:
                fail(f"sddmm {name} d={d}: {design} was not launched "
                     f"({fused_chain.DESIGN_LAUNCHES['sddmm']})")
            if not (e.reshape(-1)[graphs[name].nnz:] == 0).all():
                fail(f"sddmm {name} d={d} {design}: a padding slot is not 0")
            hold("sddmm", f"{name} d={d} {design}", e,
                 sddmm_plain_chunked(bal.rows, bal.cols, a, b, bal.shape), dtype)
            del a, b, e
    torch.cuda.empty_cache()
    # K7 (slot-tile) in its two modes: full (every row, what
    # chain_stats_fused launches) and edge (the rows of each tile's first
    # and last runs, what the fused chain launches; every other row stays
    # exactly (-1e30, 0)); then K8 alone on the edge statistics, folding
    # every other row itself
    for name, bal in bals.items():
        pat = (bal.rows, bal.cols, *feats[name])
        skw = dict(shape=bal.shape, alpha=CHAIN_ALPHA)
        reset_launch_counts()
        rm, rs = fused_chain.chain_stats_fused(*pat, **skw)
        em, es = fused_chain._launch_stats("slot", *pat, edge=True, **skw)
        if fused_chain.STATS_MODES != {"full": 1, "edge": 1}:
            fail(f"chain_stats {name}: modes {fused_chain.STATS_MODES}, "
                 "expected one full and one edge launch")
        pm, ps = fused_chain.chain_stats_plain(*pat, **skw)
        empty = torch.diff(graphs[name].indptr) == 0
        if not ((rm[empty] == -1e30).all() and (rs[empty] == 0).all()):
            fail(f"chain_stats: empty rows of {name} are not exactly (-1e30, 0)")
        hold("chain_stats", f"{name} full row max", rm[~empty], pm[~empty],
             "float32")
        hold("chain_stats", f"{name} full row sum", rs, ps, "float32")
        edge_rows = torch.zeros(bal.shape[0], dtype=torch.bool, device=dev)
        edge_rows[bal.rows[fused_chain.edge_slots(bal.rows, bal.shape[0])]
                  .long()] = True
        pe_m, pe_s = fused_chain.chain_stats_edge_plain(*pat, **skw)
        if not ((em[~edge_rows] == -1e30).all() and (es[~edge_rows] == 0).all()
                and (pe_s[~edge_rows] == 0).all()):
            fail(f"chain_stats {name}: edge mode wrote a row outside the "
                 "tiles' edge runs")
        hold("chain_stats", f"{name} edge row max ({int(edge_rows.sum())} "
             "rows)", em[edge_rows], pe_m[edge_rows], "float32")
        hold("chain_stats", f"{name} edge row sum", es[edge_rows],
             pe_s[edge_rows], "float32")
        for n in (1, 32, 128):
            x = randn(k_dim, n) if n > 1 else randn(k_dim)
            ckw = dict(shape=bal.shape, transform="softmax", alpha=CHAIN_ALPHA)
            hold("chain", f"{name} softmax N={n} on edge stats",
                 fused_chain._launch_chain(None, *pat, x, stats=(em, es),
                                           edge_stats=True, **ckw),
                 fused_chain.chain_tiles_plain(*pat, x, **ckw), "float32")
        del rm, rs, em, es, pm, ps, pe_m, pe_s, x
    empty = torch.diff(graphs["g500"].indptr) == 0
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
        if name == "gemma":
            # K7 and K8's softmax (no bias, alpha = 1/sqrt(d)) in both
            # designs, forced, against the plain versions
            ckw = dict(shape=a["csr"].shape, alpha=d ** -0.5)
            pm, ps = fused_chain.chain_stats_plain(*pat, **ckw)
            yp = fused_chain.chain_plain(*pat, v, transform="softmax",
                                         stats=(pm, ps), **ckw)
            for design in ("block", "slot"):
                dkw = dict(ckw, blocks=a["blocks"])
                reset_launch_counts()
                rm, rs = fused_chain._launch_stats(design, *pat, **dkw)
                y = fused_chain._launch_chain(design, *pat, v,
                                              transform="softmax",
                                              stats=(pm, ps), **dkw)
                torch.cuda.synchronize()
                if (fused_chain.DESIGN_LAUNCHES["chain_stats"][design],
                        fused_chain.DESIGN_LAUNCHES["chain"][design]) != (1, 1):
                    fail(f"{name}: K7/K8's {design} design did not launch "
                         f"({fused_chain.DESIGN_LAUNCHES})")
                hold("chain_stats", f"{name} {design} d={d} row max", rm, pm,
                     dt)
                hold("chain_stats", f"{name} {design} d={d} row sum", rs, ps,
                     dt)
                hold("chain", f"{name} {design} softmax d=N={d}", y, yp, dt)
                del y
            del yp
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
    w_alt = formats.csr_to_bsr(w_csr, *BSR_BLOCK_ALT)
    # both designs of K11, forced, each against the plain version: the
    # tensor-core design reads the group layout, built once a weight
    for label, wb, dtype in (("", w_bsr, torch.float32),
                             ("", w_bsr16, torch.bfloat16),
                             (f" {BSR_BLOCK_ALT}", w_alt, torch.float32)):
        dt = str(dtype).split(".")[1]
        layout = bsr.build_groups(wb)
        for n in NS:
            x = randn(d_model, n, dtype=dtype) if n > 1 else randn(d_model, dtype=dtype)
            want = bsr.spmm_bsr_plain(wb, x)
            hold("bsr_spmm", f"gemma ffn_up{label} N={n} routed",
                 bsr.spmm_bsr(wb, x, layout=layout), want, dt)
            x2 = x if n > 1 else x[:, None]
            want2 = want if n > 1 else want[:, None]
            for design in bsr.DESIGN_LAUNCHES["bsr_spmm"]:
                hold("bsr_spmm", f"gemma ffn_up{label} N={n} {design}",
                     bsr._launch(design, wb, x2, layout), want2, dt)
    del w_bsr16, w_alt, layout
    rng = np.random.default_rng(args.seed)
    ragged = ((rng.random((203, 333)) < 0.05)
              * rng.standard_normal((203, 333))).astype(np.float32)
    ragged[16:48] = 0.0                 # block rows 1 and 2 of (16, 64) empty
    ragged_bsr = formats.csr_to_bsr(formats.csr_from_dense(ragged, device=dev),
                                    *BSR_BLOCK_ALT)
    ragged_layout = bsr.build_groups(ragged_bsr)
    for n in (1, 37):
        x = randn(333, n) if n > 1 else randn(333)
        x2 = x if n > 1 else x[:, None]
        for design in (None, *bsr.DESIGN_LAUNCHES["bsr_spmm"]):
            if design is None:
                y = bsr.spmm_bsr(ragged_bsr, x)
                want = bsr.spmm_bsr_plain(ragged_bsr, x)
            else:
                y = bsr._launch(design, ragged_bsr, x2, ragged_layout)
                want = bsr.spmm_bsr_plain(ragged_bsr, x2)
            if not (y[16:48] == 0).all():
                fail("bsr_spmm: the empty block rows of the ragged matrix "
                     f"are not 0 ({design or 'routed'})")
            hold("bsr_spmm", f"ragged 203x333 {BSR_BLOCK_ALT} N={n} "
                 f"{design or 'routed'}", y, want, "float32")
    torch.cuda.synchronize()

    # -- 4. the main path through the facade -----------------------------------
    phase("main")
    #: the counters of K1, K3 and K7-K11's launches by design
    design_counts = (vsr.DESIGN_LAUNCHES, csc.DESIGN_LAUNCHES,
                     fused_chain.DESIGN_LAUNCHES, attention.DESIGN_LAUNCHES,
                     bsr.DESIGN_LAUNCHES)

    def took():
        """The designs of the K1, K3 and K7-K11 launches since the last
        reset."""
        return {kk: dict(vv) for counts in design_counts
                for kk, vv in counts.items()}

    #: the launches of each path, and those of K1, K3 and K7-K11 by design:
    #: the forward ("main"), the backward of A @ x ("backward"), the
    #: sparse-FFN training steps ("train"), the forward and backward of the
    #: GAT chain ("chain_backward"), the GAT training steps ("gat_train"),
    #: of block-sparse attention ("attention_backward") and of the block-
    #: pruned weight ("bsr_backward")
    #: the quantized value streams ("quant"), the offline half (the
    #: calibration, the frozen artifacts, the quickstart: "offline"), the
    #: tuner ("tune"), the guardrails and the models ("models"); K1,
    #: K2, K4 and K5's
    #: launches by value type (f32, bf16, int8, fp8) on each path
    path_launches = {path: {k: 0 for k in KERNELS}
                     for path in ("main", "backward", "train", "chain_backward",
                                  "gat_train", "attention_backward",
                                  "bsr_backward", "quant", "offline",
                                  "tune", "guardrails", "models", "serve",
                                  "driver", "families", "sharded",
                                  "launch", "tp")}
    value_counts = {**vsr.VALUE_LAUNCHES, **spmv.VALUE_LAUNCHES}
    path_values = {path: {k: dict.fromkeys(vv, 0) for k, vv in value_counts.items()}
                   for path in path_launches}
    path_designs = {path: {kk: dict.fromkeys(vv, 0) for counts in design_counts
                           for kk, vv in counts.items()}
                    for path in path_launches}
    launches, designs = path_launches["main"], path_designs["main"]

    def drive(call, path="main"):
        """One user call of ``path``, with the launch counts set to 0 just
        before and read just after."""
        reset_launch_counts()
        y = call()
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            path_launches[path][k] += v
        for k, by_design in took().items():
            for design, v in by_design.items():
                path_designs[path][k][design] += v
        for k, by_type in value_counts.items():
            for vt, v in by_type.items():
                path_values[path][k][vt] += v
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
            # rs_sr takes K3's sr design, nb_sr K1's sr and nb_pr K1's pr
            # (K2 at N = 1)
            design = took()[kernel] if kernel != "vsr_spmv" else None
            if design is not None and design[pick[3:]] < 1:
                fail(f"{name} N={n}: {pick} did not take {kernel}'s "
                     f"{pick[3:]} design ({design})")
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
    stats_modes = {"full": 0, "edge": 0}    # K7's launches on the main path
    for name, csr in graphs.items():
        a, b = feats[name]
        empty = torch.diff(csr.indptr) == 0
        for n in CHAIN_NS:
            x = randn(csr.shape[1], n) if n > 1 else randn(csr.shape[1])
            t0 = time.perf_counter()
            y, counts = drive(lambda: repro_torch.sparse_chain(
                csr, a, b, x, transform="softmax", alpha=CHAIN_ALPHA))
            t1 = time.perf_counter()
            modes = dict(fused_chain.STATS_MODES)
            A = repro_torch.sparse(csr, chain_op="softmax")
            if A.backend != "hopper":
                fail(f"chain {name} N={n}: backend {A.backend!r}")
            if counts["chain_stats"] < 1 or counts["chain"] < 1:
                fail(f"chain {name} N={n}: K7/K8 were not launched ({counts})")
            if modes != {"full": 0, "edge": counts["chain_stats"]}:
                # the fused chain computes the tiles' edge runs alone
                fail(f"chain {name} N={n}: K7 ran in modes {modes}, expected "
                     "edge mode alone")
            stats_modes["edge"] += modes["edge"]
            ran = took()
            if any(ran[kk]["block"] for kk in ("chain_stats", "chain")):
                # a scattered graph keeps ~1/4096 of each 64x64 block
                fail(f"chain {name} N={n}: K7/K8 left the slot-tile design "
                     f"({ran})")
            if y.shape != ((csr.shape[0], n) if n > 1 else (csr.shape[0],)) \
                    or not torch.isfinite(y).all():
                fail(f"chain {name} N={n}: output of shape {tuple(y.shape)} "
                     "is not finite or has the wrong shape")
            if name == "g500" and not (y[empty] == 0).all():
                fail(f"chain {name} N={n}: empty rows are not exactly 0")
            rel, _ = errors(y, A.chain(a, b, x, alpha=CHAIN_ALPHA,
                                       backend="torch"))
            print(f"[main] chain {name} softmax N={n}: launches={counts} "
                  f"k7_modes={modes} "
                  f"rel_err_vs_torch={rel:.3e} call_s={t1 - t0:.3f} "
                  "(host clock, plan included)", flush=True)
            if rel > RTOL["float32"]:
                fail(f"chain {name} N={n}: disagrees with the torch backend")
        e, counts = drive(lambda: repro_torch.sddmm(csr, a, b))
        rel, _ = errors(e, repro_torch.sparse(csr).sddmm(a, b, backend="torch"))
        ran = took()["sddmm"]
        print(f"[main] sddmm {name}: launches={counts} design={ran} "
              f"shape={tuple(e.shape)} rel_err_vs_torch={rel:.3e}", flush=True)
        if counts["sddmm"] < 1 or e.shape != (csr.nnz,) or rel > RTOL["float32"]:
            fail(f"sddmm {name}: not launched, misshapen or wrong")
        if ran != {"seq": 0, "par": counts["sddmm"]}:
            # d = 64 is 16 pieces of 16 bytes: lane groups split it
            fail(f"sddmm {name} d={CHAIN_D}: designs {ran}, expected par")
    # the fuse gate shut: the unfused pair of the port's own kernels
    csr = graphs["g500"]
    a, b = feats["g500"]
    x = randn(csr.shape[1], 32)
    shut = dataclasses.replace(repro_torch.SelectorThresholds(),
                               chain_fuse_min_n=1 << 30)
    y, counts = drive(lambda: repro_torch.sparse_chain(
        csr, a, b, x, alpha=CHAIN_ALPHA, thresholds=shut))
    modes = dict(fused_chain.STATS_MODES)
    stats_modes["full"] += modes["full"]
    rel, _ = errors(y, repro_torch.sparse_chain(csr, a, b, x, alpha=CHAIN_ALPHA))
    print(f"[main] chain g500 softmax N=32, fuse gate shut: launches={counts} "
          f"k7_modes={modes} rel_err_vs_fused={rel:.3e}", flush=True)
    if (counts["sddmm"], counts["chain_stats"], counts["vsr_spmm"],
            counts["chain"]) != (1, 1, 1, 0) or rel > RTOL["float32"]:
        fail("the shut fuse gate did not run K6, K7 and K1 alone, or disagrees")
    if took()["vsr_spmm"] != {"sr": 1, "pr": 0}:
        fail(f"the shut fuse gate at N=32 ran K1 in {took()['vsr_spmm']}, "
             "expected its sr design")
    if modes != {"full": 1, "edge": 0}:
        fail(f"the shut fuse gate ran K7 in modes {modes}, expected full mode")
    if took()["sddmm"] != {"seq": 0, "par": 1}:
        fail(f"the shut fuse gate ran K6 in {took()['sddmm']}, expected par")
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
        ran = {kk: vv for kk, vv in took().items()
               if kk not in ("vsr_spmm", "bsr_spmm", "csc_spmm", "sddmm")}
        want = {kk: (q.shape[1] if kk in kernels else 0) for kk in counts}
        if counts != want:
            fail(f"attention {cname}: launches {counts}, expected {want}")
        # Gemma's band and BigBird keep most of each 64x64 block they touch:
        # every K7-K10 launch must take the block design
        want_d = {kk: {"block": want[kk], "slot": 0} for kk in ran}
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
    if took()["vsr_spmm"] != {"sr": 1, "pr": 0}:
        fail(f"the shut attention gate at d={q1.shape[1]} ran K1 in "
             f"{took()['vsr_spmm']}, expected its sr design")
    if took()["sddmm"] != {"seq": 0, "par": 1}:
        fail(f"the shut attention gate at d={q1.shape[1]} ran K6 in "
             f"{took()['sddmm']}, expected its par design")
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
        # the tensor-core design from TC_MIN_N on, the fma design below
        ran_k11 = took()["bsr_spmm"]
        want_design = "tc" if n >= bsr.TC_MIN_N else "fma"
        if ran_k11 != {dd: int(dd == want_design) for dd in ran_k11}:
            fail(f"bsr N={n}: K11 took the designs {ran_k11}, expected "
                 f"{want_design}")
        if y.shape != ((d_ff, n) if n > 1 else (d_ff,)) or not torch.isfinite(y).all():
            fail(f"bsr N={n}: output of shape {tuple(y.shape)} is not finite "
                 "or has the wrong shape")
        rel_t, _ = errors(y, W.matmul(x, backend="torch"))
        rel_h, _ = errors(y, repro_torch.sparse(w_csr) @ x)
        rel_d, _ = errors(y, w_gpu.double() @ x.double())
        print(f"[main] bsr gemma ffn_up N={n}: launches={counts['bsr_spmm']} "
              f"design={want_design} "
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
    ran2 = took()["bsr_spmm"]
    rel2, _ = errors(y2, W2.matmul(x, backend="torch"))
    hit = repro_torch.cache_stats()["hits"] == hits + 1 and W2.plan is W.plan
    W3 = repro_torch.sparse(w_csr, backend="bsr", bsr_block=BSR_BLOCK_ALT)
    y3, counts3 = drive(lambda: W3 @ x)
    ran3 = took()["bsr_spmm"]
    rel3, _ = errors(y3, y)
    print(f"[main] bsr new values: cache_hit={hit} launches={counts['bsr_spmm']} "
          f"rel_err_vs_torch={rel2:.3e} | bsr_block={BSR_BLOCK_ALT}: second "
          f"plan={W3.plan is not W.plan} nblocks="
          f"{W3.plan.substrate('bsr').nblocks} launches={counts3['bsr_spmm']} "
          f"rel_err_vs_{BSR_BLOCK}={rel3:.3e} designs {ran2} / {ran3}",
          flush=True)
    if ran2["tc"] != 1 or ran3["tc"] != 1:
        fail(f"bsr N={n}: the new values or the {BSR_BLOCK_ALT} plan did not "
             "take the tensor-core design")
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
        if counts != {kk: int(kk in (kernel, "spill_combine")) for kk in KERNELS}:
            fail(f"spill unif N={n}: launches {counts}, expected one {kernel} "
                 "and one spill_combine")
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
    print(f"[main] launches on the main path: {launches}; K1, K3, K7-K11 by design: "
          f"{designs}; the slot-tile K7 by mode: {stats_modes}", flush=True)

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
                # K3 reads each stored entry (8 B) and each row's length
                sub_bytes = 8 * csr.nnz + 4 * m
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
            if kernel == "vsr_spmm":
                # each design forced beside the routed one
                row["design"] = pick[3:]
                for dd in vsr.DESIGN_LAUNCHES["vsr_spmm"]:
                    row[f"{dd}_ms"] = time_ms(lambda: vsr.spmm_vsr_fused(sub, x, dd))
            if kernel == "csc_spmm":
                row["design"] = pick[3:]
                row["lanes"] = csc.sr_lanes(n, k_dim, x.element_size())
                # X rows a one-pass kernel gathers, one per stored entry:
                # the floor of any one-pass design once X outgrows L2
                row["gather_bytes"] = csr.nnz * n * x.element_size()
            rows[(name, n)] = row
            print(f"[time] {name}_s{args.scale}_e16 N={n} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        del lib_a
        torch.cuda.empty_cache()

    # K3 off the main path's picks, on the uniform graph: the pr design
    # forced at N = 1 and 4 (the selector takes K2 and K1 there), the sr
    # design in one pass beside the routed column-slab order, and K1 forced
    # at N = 32 and 128 (the selector's alternative, on the other side of
    # sr_cv)
    ucsr = graphs["unif"]
    m, k_dim = ucsr.shape
    U = repro_torch.sparse(ucsr)
    uell, ubal = U.plan.substrate("ell"), U.plan.substrate("balanced")
    group = U.plan.kernel_opts(U.plan.entry("rs_pr"))["group"]
    lib_a = torch.sparse_csr_tensor(ucsr.indptr, ucsr.indices, ucsr.data,
                                    size=ucsr.shape, check_invariants=False)
    k3_bytes = 8 * ucsr.nnz + 4 * m
    for n in (1, 4):
        x = randn(k_dim, n) if n > 1 else randn(k_dim)
        t_bytes = (k3_bytes + 4 * k_dim * n + 4 * m * n) / H100_BYTES_PER_S
        t_ops = 2 * ucsr.nnz * n / H100_F32_FLOP_PER_S
        row = {"kernel_ms": time_ms(lambda: csc.spmm_csc(uell, x, "pr",
                                                          group=group)),
               "group": group,
               "pick": rows[("unif", n)]["pick"],
               "pick_kernel": rows[("unif", n)]["kernel"],
               "pick_kernel_ms": rows[("unif", n)]["kernel_ms"],
               "library_ms": time_ms(lambda: lib_a @ x),
               "bound_ms": 1e3 * max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"[time] csc_spmm pr forced unif_s{args.scale}_e16 N={n} "
              + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    for n in (32, 128):
        x = randn(k_dim, n)
        one_pass = csc.sr_lanes(n)
        t_bytes = (12 * ucsr.nnz + 4 * k_dim * n + 4 * m * n) / H100_BYTES_PER_S
        row = {"k3_ms": rows[("unif", n)]["kernel_ms"],
               "k3_lanes": rows[("unif", n)]["lanes"],
               "k3_one_pass_ms": time_ms(lambda: csc._launch(
                   "sr", uell, x, lanes=one_pass)),
               "k3_one_pass_lanes": one_pass,
               "k1_nb_sr_ms": time_ms(lambda: vsr.spmm_vsr_fused(ubal, x)),
               "k1_bound_ms": 1e3 * max(t_bytes, 2 * ucsr.nnz * n
                                        / H100_F32_FLOP_PER_S),
               "library_ms": rows[("unif", n)]["library_ms"]}
        print(f"[time] csc_spmm sr vs K1 unif_s{args.scale}_e16 N={n} "
              + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    del lib_a, x, U
    torch.cuda.empty_cache()

    # the chain: K6, K7, K8 alone, the fused call, the unfused pair, plain
    def bound(nbytes, flops, flop_rate=H100_F32_FLOP_PER_S):
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / flop_rate
        return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def k6_row(csr, bal, a, b):
        """K6 as routed, its plain version (a chunk of tiles at a time),
        ``sampled_addmm``, the bound, the design and the bytes it gathers:
        one B row a slot, one A row a run of equal rows in a tile."""
        m, d = csr.shape[0], a.shape[1]
        e = a.element_size()
        new_run = torch.ones_like(bal.rows, dtype=torch.bool)
        new_run[:, 1:] = bal.rows[:, 1:] != bal.rows[:, :-1]
        n_runs = int((new_run & (bal.rows < m)).sum())
        lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                        size=csr.shape, check_invariants=False)
        b_t = b.t()
        pat = (bal.rows, bal.cols, a, b)
        k_bound = bound(12 * bal.rows.numel() + sum(csr.shape) * d * e,
                        2 * csr.nnz * d)
        return {
            "kernel_ms": time_ms(lambda: fused_chain.sddmm_fused(*pat, shape=csr.shape)),
            "plain_ms": (time_ms(lambda: fused_chain.sddmm_plain(*pat, shape=csr.shape))
                         if d <= CHAIN_D else
                         time_ms(lambda: sddmm_plain_chunked(*pat, csr.shape), reps=5)),
            "library_ms": time_ms(lambda: torch.sparse.sampled_addmm(
                lib_a, a, b_t, beta=0.0)),
            "bound_ms": k_bound[0], "bound_by": k_bound[1],
            "design": fused_chain._sddmm_design(d, a.dtype),
            "gather_bytes": (csr.nnz + n_runs) * d * e}

    #: kernel -> (the timed row that stands for it in the summary, its shape)
    summary_rows = {}
    for name, csr in graphs.items():
        m, k_dim = csr.shape
        a, b = feats[name]
        A = repro_torch.sparse(csr, chain_op="softmax")
        bal = A.plan.substrate("balanced")
        # the plan's layout cache: None for the graph (slot-tile design),
        # found once rather than per timed call
        gblocks = A.plan.kernel_opts(A.plan.entry("chain"))["blocks"]
        slots = bal.rows.numel()
        pat = (bal.rows, bal.cols, a, b)
        feat_bytes = (m + k_dim) * CHAIN_D * a.element_size()
        st_bound = bound(8 * slots + feat_bytes + 8 * m, 2 * csr.nnz * CHAIN_D)
        sddmm_row = k6_row(csr, bal, a, b)
        stats_row = {
            "kernel_ms": time_ms(lambda: fused_chain.chain_stats_fused(
                *pat, shape=csr.shape, alpha=CHAIN_ALPHA, blocks=gblocks)),
            "plain_ms": time_ms(lambda: fused_chain.chain_stats_plain(
                *pat, shape=csr.shape, alpha=CHAIN_ALPHA)),
            "library_ms": None, "bound_ms": st_bound[0], "bound_by": st_bound[1]}
        stats_row["k6_ratio"] = stats_row["kernel_ms"] / sddmm_row["kernel_ms"]
        # K7's edge mode: the slots of each tile's first and last runs; its
        # bound reads the rows of the whole slab, the columns, A rows and B
        # rows of those slots, and writes the stats of their rows
        eslots = fused_chain.edge_slots(bal.rows, m)
        n_edge = int(eslots.sum())
        e_rows = torch.unique(bal.rows[eslots]).numel()
        e_cols = torch.unique(bal.cols[eslots]).numel()
        ed_bound = bound(4 * slots + 4 * n_edge
                         + (e_rows + e_cols) * CHAIN_D * a.element_size()
                         + 8 * e_rows, 2 * n_edge * CHAIN_D)
        edge_row = {
            "kernel_ms": time_ms(lambda: fused_chain._launch_stats(
                "slot", *pat, shape=csr.shape, alpha=CHAIN_ALPHA, edge=True)),
            "plain_ms": time_ms(lambda: fused_chain.chain_stats_edge_plain(
                *pat, shape=csr.shape, alpha=CHAIN_ALPHA)),
            "library_ms": None, "bound_ms": ed_bound[0],
            "bound_by": ed_bound[1], "edge_slot_share": n_edge / csr.nnz,
            "edge_rows": e_rows}
        edge_row["full_ratio"] = edge_row["kernel_ms"] / stats_row["kernel_ms"]
        for label, row in (("sddmm", sddmm_row), ("chain_stats", stats_row),
                           ("chain_stats edge", edge_row)):
            print(f"[time] {label} {name}_s{args.scale}_e16 d={CHAIN_D} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        if name == SDDMM_SUMMARY:
            summary_rows["sddmm"] = (sddmm_row, f"{name}_s{args.scale}_e16 d={CHAIN_D}")
            # K6's other widths: "seq" at d = 1 and 4 (the backward's dvals
            # at N = 1 and 4), "par" at d = 256
            for d in SDDMM_WIDTHS:
                row = k6_row(csr, bal, 0.3 * randn(m, d), 0.3 * randn(k_dim, d))
                print(f"[time] sddmm {name}_s{args.scale}_e16 d={d} "
                      + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        stats = fused_chain.chain_stats_fused(*pat, shape=csr.shape,
                                              alpha=CHAIN_ALPHA, blocks=gblocks)
        edge_stats = fused_chain._launch_stats("slot", *pat, shape=csr.shape,
                                               alpha=CHAIN_ALPHA, edge=True)
        for cname, transform, n in CHAIN_CASES:
            if cname != name:
                continue
            x = randn(k_dim, n) if n > 1 else randn(k_dim)
            kw = dict(shape=csr.shape, transform=transform, alpha=CHAIN_ALPHA)
            gkw = dict(kw, blocks=gblocks)
            if transform == "softmax":
                kw["stats"] = stats
                # K8 alone as the fused chain runs it: on K7's edge
                # statistics, which it reads for the edge rows alone
                fkw = dict(gkw, stats=edge_stats, edge_stats=True)
            else:
                fkw = gkw
            stats_in = 8 * e_rows if transform == "softmax" else 0
            ch_bound = bound(8 * slots + feat_bytes + stats_in
                             + (k_dim + m) * n * x.element_size(),
                             2 * csr.nnz * (CHAIN_D + n))
            row = {
                "kernel_ms": time_ms(lambda: fused_chain._launch_chain(
                    None, *pat, x, **fkw)),
                "plain_ms": time_ms(lambda: fused_chain.chain_plain(*pat, x, **kw)),
                "library_ms": None,
                "bound_ms": ch_bound[0], "bound_by": ch_bound[1],
                "fused_call_ms": time_ms(lambda: A.chain(
                    a, b, x, transform=transform, alpha=CHAIN_ALPHA)),
                "unfused_pair_ms": time_ms(lambda: fused_chain.chain_unfused(
                    *pat, x, shape=csr.shape, transform=transform,
                    alpha=CHAIN_ALPHA, blocks=gblocks)),
                "plain_call_ms": time_ms(lambda: A.chain(
                    a, b, x, transform=transform, alpha=CHAIN_ALPHA,
                    backend="torch")),
            }
            if transform == "softmax":
                # K8 on every row's statistics (the sharded merge's input)
                row["given_stats_ms"] = time_ms(lambda: fused_chain.chain_fused(
                    *pat, x, **kw, blocks=gblocks))
                row["fused_vs_unfused"] = (row["fused_call_ms"]
                                           / row["unfused_pair_ms"])
            print(f"[time] chain {name}_s{args.scale}_e16 {transform} N={n} "
                  + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        del stats, edge_stats
        torch.cuda.empty_cache()

    # K6 at the Gemma head (d = 256 on the band), as the shut attention gate
    # runs it
    ga = attn["gemma"]
    row = k6_row(ga["csr"], ga["bal"],
                 *(0.3 * randn(ATTN_SEQ, gemma.head_dim) for _ in range(2)))
    print(f"[time] sddmm gemma_local head d={gemma.head_dim} "
          + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)

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
            # K7 and K8's softmax: the module, its forced-design launcher
            mod, kw["alpha"] = fused_chain, sc
            pat_b, ckw = pat, dict(transform="softmax")
            stats_plain = lambda: fused_chain.chain_stats_plain(*pat, **kw)
            k10_plain = lambda: fused_chain.chain_plain(*pat, v1, stats=st,
                                                        **kw, **ckw)
            bias_bytes = 0
        else:
            mod, kw["scale"] = attention, sc
            pat_b, ckw = pat + (a["slab"],), {}
            stats_plain = lambda: attention.attn_stats_plain(*pat_b, **kw)
            k10_plain = lambda: attention.attn_chain_plain(*pat_b, v1,
                                                           stats=st, **kw)
            bias_bytes = 4 * csr.nnz
        fkw = dict(kw, blocks=a["blocks"])     # the layout built once
        stats_fn = lambda: mod._launch_stats(None, *pat_b, **fkw)
        st = stats_fn()
        k10 = lambda: mod._launch_chain(None, *pat_b, v1, stats=st, **fkw,
                                        **ckw)
        unfused = lambda: (fused_chain.chain_unfused(*pat_b, v1, **fkw, **ckw)
                           if bias is None else
                           attention.attn_unfused(*pat_b, v1, **fkw))
        # the block design reads the layout (a mask and a start per (block,
        # row), each block's column, the work list), not the slab's (rows,
        # cols), and the bias of the kept entries only; the slot-tile design
        # reads the slab's pattern and bias (12 B, or 8 B without a bias, a
        # slot)
        lay = a["blocks"](bal.rows, bal.cols, csr.shape)
        pattern_bytes = (12 * attention.BLOCK * lay.n_blocks
                         + 4 * lay.n_blocks + 16 * lay.work.shape[0])
        slot_bytes = ((8 if bias is None else 12) * slots - pattern_bytes
                      - bias_bytes)
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
        # the design the timed launches took: the block design
        took_t = {kk: [dd for dd, nn in mod.DESIGN_LAUNCHES[kk].items() if nn]
                  for kk in kernels}
        if took_t != {kk: ["block"] for kk in kernels}:
            fail(f"attention {cname}: the timed {kernels} took {took_t}, "
                 "expected the block design")
        layer_ms = time_ms(call, reps=3)
        row9 = {"kernel_ms": k9_ms, "design": took_t[kernels[0]][0],
                "plain_ms": time_ms(stats_plain, reps=3), "library_ms": None,
                "bound_ms": b9[0], "bound_by": b9[1],
                "slot_ms": time_ms(lambda: mod._launch_stats(
                    "slot", *pat_b, **fkw), reps=5),
                "slot_bound_ms": bound(base_bytes + slot_bytes,
                                       2 * csr.nnz * d)[0]}
        row10 = {"kernel_ms": k10_ms, "design": took_t[kernels[1]][0],
                 "plain_ms": time_ms(k10_plain, reps=3),
                 "library_ms": sdpa_ms(head(q), head(k), head(v), mask),
                 "bound_ms": b10[0], "bound_by": b10[1],
                 "slot_ms": time_ms(lambda: mod._launch_chain(
                     "slot", *pat_b, v1, stats=st, **fkw, **ckw), reps=5),
                 "slot_bound_ms": bound(base_bytes + slot_bytes + 2 * m * n * 4,
                                        2 * csr.nnz * (d + n))[0],
                 "fused_call_ms": time_ms(lambda: execute_attention(
                     p, q1, k1, v1, bias=bias)),
                 "unfused_pair_ms": time_ms(unfused),
                 "plain_call_ms": time_ms(lambda: execute_attention(
                     p, q1, k1, v1, bias=bias, backend="torch"), reps=3),
                 "sdpa_rel_err": sdpa_rel,
                 "layer_call_ms": layer_ms,
                 # the layer's kernels (one K9/K7 and one K10/K8 a head)
                 # and the host work around them
                 "layer_kernels_ms": q.shape[1] * (k9_ms + k10_ms),
                 "layer_outside_ms": layer_ms - q.shape[1] * (k9_ms + k10_ms),
                 "layer_sdpa_ms": sdpa_ms(q, k, v, mask, reps=3)}
        shape = (f"{cname} seq={m} d=N={d} head {h} of {q.shape[1]}")
        for label, row in ((kernels[0], row9), (kernels[1], row10)):
            print(f"[time] {label} {shape} "
                  + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        if cname in ("gemma_local", "gemma_local_alibi"):
            summary_rows[kernels[0]] = (row9, shape)
            summary_rows[kernels[1]] = (row10, shape)
            # both designs in bfloat16 at the same head, beside SDPA on the
            # bfloat16 operands and mask; bounds at the bf16 tensor-core rate
            q16, k16, v16 = (t.to(torch.bfloat16) for t in (q1, k1, v1))
            pat16 = (bal.rows, bal.cols, q16, k16) + pat_b[4:]
            st16 = mod._launch_stats(None, *pat16, **fkw)
            base16 = pattern_bytes + bias_bytes + 2 * m * d * 2 + 8 * m
            runs16 = {
                kernels[0]: (lambda dsg: mod._launch_stats(
                    dsg, *pat16, **fkw), 0, 2 * csr.nnz * d),
                kernels[1]: (lambda dsg: mod._launch_chain(
                    dsg, *pat16, v16, stats=st16, **fkw, **ckw), 2 * m * n * 2,
                    2 * csr.nnz * (d + n))}
            mask16 = mask.to(torch.bfloat16) if bias is not None else mask
            for label, (run16, yv_bytes, flops) in runs16.items():
                b16 = bound(base16 + yv_bytes, flops, H100_BF16_FLOP_PER_S)
                row = {"block_ms": time_ms(lambda: run16("block")),
                       "slot_ms": time_ms(lambda: run16("slot"), reps=5),
                       "bound_ms": b16[0], "bound_by": b16[1],
                       "slot_bound_ms": bound(base16 + slot_bytes + yv_bytes,
                                              flops, H100_BF16_FLOP_PER_S)[0],
                       "library_ms": (sdpa_ms(q16[None, None], k16[None, None],
                                              v16[None, None], mask16)
                                      if label == kernels[1] else None)}
                print(f"[time] {label} {cname} bfloat16 seq={m} d=N={d} head "
                      f"{h} " + " ".join(f"{kk}={vv}" for kk, vv in row.items()),
                      flush=True)
            del q16, k16, v16, pat16, st16, mask16
        if cname == "gemma_local":
            # the plan key's fingerprint alone at this mask (host clock,
            # median of 5): the host work each layer call repeats
            t_fp = []
            for _ in range(5):
                t0 = time.perf_counter()
                pattern_fingerprint(csr)
                t_fp.append(1e3 * (time.perf_counter() - t0))
            t_plan = []
            for _ in range(5):
                t0 = time.perf_counter()
                repro_torch.attention_plan(a["spec"])
                t_plan.append(1e3 * (time.perf_counter() - t0))
            # the digest the default cache (integrity="publish") takes of
            # a plan it inserts: the host cost a miss of this layer pays
            t_dig = []
            for _ in range(5):
                t0 = time.perf_counter()
                plan_digest(p)
                t_dig.append(1e3 * (time.perf_counter() - t0))
            print(f"[time] pattern_fingerprint {cname} nnz={csr.nnz}: "
                  f"ms={statistics.median(t_fp)} | attention_plan (a cache "
                  f"hit): ms={statistics.median(t_plan)} | plan_digest (a "
                  f"miss of the default cache, integrity="
                  f"{repro_torch.api.DEFAULT_CACHE.integrity!r}): "
                  f"ms={statistics.median(t_dig)} (host clock, median of 5)",
                  flush=True)
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
    # the group layout of the tensor-core design, built as the plan's prep
    # hook builds it (host clock): the timed calls get it prebuilt, as W @ x
    # does
    t0 = time.perf_counter()
    layout = bsr.build_groups(w_bsr)
    torch.cuda.synchronize()
    print(f"[time] bsr_spmm group layout {BSR_BLOCK}: {layout.n_groups} groups "
          f"of {layout.group_blocks} block rows, {layout.cols.shape[0]} "
          f"(group, column) entries, built in "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms (host clock)", flush=True)
    print("[time] bsr_spmm tensor-core design, -Xptxas -v:", flush=True)
    fn_name = None
    for line in built.log.splitlines():
        if "Compiling entry function" in line:
            fn_name = line.split("'")[1] if "'" in line else line
        elif fn_name and "bsr_tc_kernel" in fn_name and (
                "registers" in line or "spill" in line):
            print(f"[time]   {fn_name}: {line.strip()}", flush=True)

    def k11_bound(wb, n, rate=H100_F32_FLOP_PER_S, design="fma", lay=None):
        """K11's bound for the design: the blocks once, the pattern it
        reads (indptr and indices, or the group layout: its pointers,
        columns and eight tile rows an entry), X and Y once."""
        el = wb.blocks.element_size()
        wmb = wb.indptr.shape[0] - 1
        pattern = (4 * (lay.n_groups + 1) + 36 * lay.cols.shape[0]
                   if design == "tc" else 4 * wb.nblocks + 4 * (wmb + 1))
        return bound(el * wb.blocks.numel() + pattern
                     + el * (wb.shape[1] + wb.shape[0]) * n,
                     2 * wb.blocks.numel() * n, rate)

    for n in NS:
        x = randn(d_model, n)
        design = "tc" if n >= bsr.TC_MIN_N else "fma"
        blk_bound = k11_bound(w_bsr, n, design=design, lay=layout)
        row = {"kernel_ms": time_ms(lambda: bsr.spmm_bsr(w_bsr, x, layout=layout)),
               "design": design,
               "plain_ms": time_ms(lambda: bsr.spmm_bsr_plain(w_bsr, x), reps=5),
               "library_ms": time_ms(lambda: lib_w @ x),
               "bound_ms": blk_bound[0], "bound_by": blk_bound[1],
               "e2e_ms": time_ms(lambda: W @ x),
               "bsr_library_ms": (None if lib_wb is None else
                                  try_ms("to_sparse_bsr @ x", lambda: lib_wb @ x)),
               "dense_ms": time_ms(lambda: w_gpu @ x)}
        # both designs, forced (the routed one's time is kernel_ms)
        for dd in bsr.DESIGN_LAUNCHES["bsr_spmm"]:
            row[f"{dd}_ms"] = time_ms(lambda: bsr._launch(dd, w_bsr, x, layout))
        print(f"[time] bsr_spmm gemma ffn_up {d_ff}x{d_model} N={n} "
              + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        if n == BSR_SUMMARY_N:
            summary_rows["bsr_spmm"] = (row, f"gemma3-12b ffn_up {d_ff}x"
                                         f"{d_model} {BSR_BLOCK} N={n}")
    # K11 with bf16 blocks and activations (bound at the bf16 tensor-core
    # rate), and on the second plan's (16, 64) blocks of the same W, each
    # beside the dense product of W in its type and PyTorch's sparse.mm
    # where it takes the type
    w_alt = formats.csr_to_bsr(w_csr, *BSR_BLOCK_ALT)
    w16 = w_gpu.bfloat16()
    lib_w16 = torch.sparse_csr_tensor(w_csr.indptr, w_csr.indices,
                                      w_csr.data.bfloat16(), size=w_csr.shape,
                                      check_invariants=False)
    for label, wb, dtype, dense_w, lib in (
            ("bf16", formats.BSR(w_bsr.indptr, w_bsr.indices,
                                 w_bsr.blocks.bfloat16(), w_bsr.shape,
                                 w_bsr.block_shape), torch.bfloat16, w16, lib_w16),
            (f"f32 {BSR_BLOCK_ALT}", w_alt, torch.float32, w_gpu, lib_w)):
        rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 else H100_F32_FLOP_PER_S
        wlay = bsr.build_groups(wb)
        for n in NS:
            x = randn(d_model, n, dtype=dtype)
            design = "tc" if n >= bsr.TC_MIN_N else "fma"
            b = k11_bound(wb, n, rate, design, wlay)
            row = {"kernel_ms": time_ms(lambda: bsr.spmm_bsr(wb, x, layout=wlay)),
                   "design": design,
                   "plain_ms": time_ms(lambda: bsr.spmm_bsr_plain(wb, x), reps=5),
                   "bound_ms": b[0], "bound_by": b[1],
                   "dense_ms": time_ms(lambda: dense_w @ x),
                   "library_ms": try_ms(f"sparse.mm {label}", lambda: lib @ x),
                   "nblocks": wb.nblocks}
            for dd in bsr.DESIGN_LAUNCHES["bsr_spmm"]:
                row[f"{dd}_ms"] = time_ms(lambda: bsr._launch(dd, wb, x, wlay))
            print(f"[time] bsr_spmm gemma ffn_up {label} N={n} "
                  + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
    del w16, lib_w16, wlay, layout
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
        # the one PyTorch call that computes the combine: index_add_ on the
        # window rows' indices, made beforehand
        idx = (spill_base.long()[:, None] + torch.arange(
            spill_win, device=dev)[None, :]).reshape(-1)
        y_lib = part.new_zeros((m + spill_win + 1,) + tuple(part.shape[2:]))
        part_flat = part.reshape((-1,) + tuple(part.shape[2:]))
        row = {"kernel_ms": time_ms(run),
               "plain_ms": time_ms(lambda: vsr.spill_partials_plain(
                   sbal, x2, spill_base, spill_win), reps=5),
               "library_ms": time_ms(lambda: lib_a @ x2),
               "bound_ms": k_bound[0], "bound_by": k_bound[1],
               "combine_ms": time_ms(lambda: vsr._combine(part, spill_base, m)),
               "combine_bound_ms": c_bound[0],
               "combine_plain_ms": time_ms(lambda: vsr.spill_combine_plain(
                   part, spill_base, m)),
               "combine_library_ms": time_ms(lambda: y_lib.index_add_(
                   0, idx, part_flat)),
               "spill_call_ms": time_ms(lambda: S.matmul(x, impl="nb_pr")),
               "fused_kernel_ms": time_ms(fused)}
        row["call_vs_library"] = row["spill_call_ms"] / row["library_ms"]
        print(f"[time] {kernel} unif_s{args.scale}_e16 N={n} win={spill_win} "
              + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        shape = f"unif_s{args.scale}_e16 N={n} win={spill_win}"
        if n == SPILL_SUMMARY_N[kernel]:
            summary_rows[kernel] = (row, shape)
        if n == SPILL_SUMMARY_N["spill_combine"]:
            summary_rows["spill_combine"] = (
                {"kernel_ms": row["combine_ms"], "plain_ms": row["combine_plain_ms"],
                 "bound_ms": c_bound[0], "bound_by": c_bound[1],
                 "library_ms": row["combine_library_ms"]}, shape)
        del part, idx, y_lib, part_flat
    del lib_a
    torch.cuda.empty_cache()

    # -- 6. the backward of A @ x --------------------------------------------------
    phase("backward")

    def coo_bwd_chunked(csr, v, x, g, chunk=1 << 22):
        """The reference's ``_coo_bwd`` (``coo_bwd_plain``) on the card's
        tensors, a chunk of nonzeros at a time (at N = 128 its gathers would
        hold 8 GB each)."""
        r, c = (t.reshape(-1)[:csr.nnz] for t in formats.balanced_pattern(csr))
        dvs, dx = [], torch.zeros(x.shape, dtype=torch.float32, device=dev)
        for s0 in range(0, csr.nnz, chunk):
            rr = r[s0:s0 + chunk]
            dv, dxc = coo_bwd_plain(rr, c[s0:s0 + chunk], rr < csr.shape[0],
                                    v[s0:s0 + chunk], x.float(), g.float(),
                                    csr.shape)
            dvs.append(dv)
            dx += dxc
        return torch.cat(dvs), dx

    bwd_rows = {}
    for name, csr in graphs.items():
        m, k_dim = csr.shape
        A = repro_torch.sparse(csr)
        t0 = time.perf_counter()
        pt = A.plan.transposed()
        t_build = time.perf_counter() - t0
        st = pt.stats
        print(f"[backward] {name}: A^T M={st.m} K={st.k} nnz={st.nnz} "
              f"avg_row={st.avg_row:.2f} cv={st.cv:.2f} max_row={st.max_row} "
              f"empty_rows={st.empty_rows}; picks "
              f"{ {n: pt.select(n) for n in NS} } (A: "
              f"{ {n: A.plan.select(n) for n in NS} }); transposed plan "
              f"{t_build:.3f} s on the host", flush=True)
        lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                        size=csr.shape, check_invariants=False)
        lib_t = torch.sparse_csr_tensor(pt.csr.indptr, pt.csr.indices,
                                        pt.csr.data, size=pt.csr.shape,
                                        check_invariants=False)
        prow, pcol = A.plan.pattern()
        for n in NS:
            v = randn(csr.nnz).requires_grad_()
            x = (randn(k_dim, n) if n > 1 else randn(k_dim)).requires_grad_()
            gy = randn(m, n) if n > 1 else randn(m)
            pick, tpick = A.plan.select(n), pt.select(n)
            k_fwd, k_bwd = kernel_of(pick, n), kernel_of(tpick, n)

            def fwd_bwd():
                (A.with_values(v) @ x * gy).sum().backward()

            _, counts = drive(fwd_bwd, "backward")
            k6_design = fused_chain._sddmm_design(n, torch.float32)
            k6_took = took()["sddmm"]
            print(f"[backward] {name} N={n}: forward {pick} ({k_fwd}), A^T "
                  f"{tpick} ({k_bwd}), K6 {k6_took}; launches {counts}",
                  flush=True)
            if counts["sddmm"] != 1 or k6_took[k6_design] != 1:
                fail(f"backward {name} N={n}: K6 did not run once in its "
                     f"{k6_design} design ({counts}, {k6_took})")
            if counts[k_bwd] < 1 + int(k_bwd == k_fwd):
                fail(f"backward {name} N={n}: A^T's pick {tpick} did not "
                     f"launch {k_bwd} ({counts})")
            dv, dx = coo_bwd_chunked(csr, v.detach(), x.detach(), gy)
            hold("sddmm", f"{name} backward dvals N={n}", v.grad, dv, "float32")
            hold(k_bwd, f"{name} backward dx N={n} ({tpick} on A^T)", x.grad,
                 dx, "float32")
            # times: the whole backward, K6 alone, the SpMM of A^T alone, and
            # the yardstick: sampled_addmm plus sparse.mm on A^T
            y = A.with_values(v) @ x
            g2, x2 = (gy[:, None] if n == 1 else gy), x.detach().reshape(k_dim, n)
            entry = pt.entry(tpick)
            sub_t, opts_t = pt.substrate(entry.substrate), pt.kernel_opts(entry)
            t_sub = (8 * csr.nnz + 4 * k_dim if entry.substrate == "ell"
                     else 12 * csr.nnz)
            b_k6 = bound(12 * prow.numel() + 4 * (m + k_dim) * n, 2 * csr.nnz * n)
            b_mm = bound(t_sub + 4 * (m + k_dim) * n, 2 * csr.nnz * n)
            row = {
                "bwd_ms": time_ms(lambda: torch.autograd.grad(
                    y, (v, x), gy, retain_graph=True)),
                "k6_ms": time_ms(lambda: fused_chain.sddmm_fused(
                    prow, pcol, g2, x2, shape=csr.shape)),
                "spmm_t_ms": time_ms(lambda: entry.fn(sub_t, gy, **opts_t)),
                "library_ms": time_ms(lambda: (torch.sparse.sampled_addmm(
                    lib_a, g2, x2.t(), beta=0.0), lib_t @ gy)),
                "bound_ms": b_k6[0] + b_mm[0], "k6_bound_ms": b_k6[0],
                "spmm_t_bound_ms": b_mm[0], "k6_design": k6_design,
                "spmm_t": f"{tpick} ({k_bwd})"}
            # the glue's device work: A^T's live stream, gathered by perm
            # and laid into the pick's substrate
            perm = A.plan.transposed_perm()
            if entry.substrate == "ell":
                lay = lambda: _stream_to_ell(v.detach().index_select(0, perm),  # noqa: E731
                                             sub_t, pt.ell_src())
            else:
                lay = lambda: _stream_to_balanced(v.detach().index_select(0, perm),  # noqa: E731
                                                  sub_t)
            row["stream_t_ms"] = time_ms(lay)
            row["glue_ms"] = row["bwd_ms"] - row["k6_ms"] - row["spmm_t_ms"]
            bwd_rows[(name, n)] = row
            print(f"[time] backward {name}_s{args.scale}_e16 N={n} "
                  + " ".join(f"{k}={vv}" for k, vv in row.items()), flush=True)
            del y, v, x, gy, dv, dx
        del lib_a, lib_t
        torch.cuda.empty_cache()

    # -- 7. the sparse-FFN training step at Gemma-3-12B's FFN widths ----------------
    phase("train")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gemma3_12b.CONFIG.scaled(sparse_ffn=SparseFFNConfig(),
                                   param_dtype="float32",
                                   compute_dtype="float32")
    t0 = time.perf_counter()
    ffn = SparseFFN(cfg, seed=args.seed)
    pats = ffn.patterns
    print(f"[train] SparseFFN d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"{cfg.sparse_ffn} act={cfg.act}: nnz "
          f"{ {k: int((p.rows < p.shape[0]).sum()) for k, p in pats.items()} } "
          f"tiles { {k: p.n_tiles for k, p in pats.items()} }; patterns drawn "
          f"in {time.perf_counter() - t0:.1f} s on the host", flush=True)
    batch = {"x": randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
             "y": randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)}

    def ffn_loss(p, b):
        return torch.mean((ffn(b["x"], p) - b["y"]) ** 2), {}

    tcfg = TrainConfig(opt=OptConfig(**TRAIN_OPT))
    train_step = make_train_step(ffn_loss, tcfg)
    state = init_state(ffn.params(), tcfg)
    first = {k: p.clone() for k, p in state["params"].items()}
    builds0, losses, step_s = PATTERN_PREP["builds"], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (state, metrics), counts = drive(lambda: train_step(state, batch), "train")
        step_s.append(time.perf_counter() - t0)
        k1_took = took()["vsr_spmm"]
        losses.append(float(metrics["loss"]))
        print(f"[train] step {i + 1}: loss={losses[-1]:.7f} grad_norm="
              f"{float(metrics['grad_norm']):.6e} lr={float(metrics['lr']):.3e} "
              f"{step_s[-1]:.3f} s; launches {counts}, K1 {k1_took}",
              flush=True)
        if counts["sddmm"] != 3 or counts["vsr_spmm"] != 6 or k1_took["sr"] != 6:
            fail(f"train step {i + 1}: expected 3 K6 and 6 K1 sr launches "
                 f"(forward, A^T: nb_sr, the pattern entry's route at N = "
                 f"{TRAIN_BATCH * TRAIN_SEQ}), got {counts}, K1 {k1_took}")
    builds = PATTERN_PREP["builds"] - builds0
    if builds != 3:
        fail(f"train: {builds} per-pattern prep builds over {TRAIN_STEPS} "
             "steps, expected 3")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall: {losses}")
    # the first step's grads against torch autograd of the dense products
    leaves = {k: p.clone().requires_grad_() for k, p in first.items()}
    loss_s = ffn_loss(leaves, batch)[0]
    grads = dict(zip(leaves, torch.autograd.grad(loss_s, list(leaves.values()))))
    for k, g in grads.items():
        if not torch.isfinite(g).all() or not g.abs().max() > 0:
            fail(f"train: the grad of {k} is not finite or is all zero")
    dense = {"w_" + k: p.to_dense(first["v_" + k]).requires_grad_()
             for k, p in pats.items()}
    ln = first["ln"].clone().requires_grad_()

    def dense_ffn(w, xb):
        xn = rmsnorm(xb, w["ln"], cfg.norm_eps)
        h = (torch.nn.functional.silu(xn @ w["w_gate"].T) * (xn @ w["w_up"].T))
        return xb + h @ w["w_down"].T

    wd = dict(dense, ln=ln)
    loss_d = torch.mean((dense_ffn(wd, batch["x"]) - batch["y"]) ** 2)
    gd = dict(zip(wd, torch.autograd.grad(loss_d, list(wd.values()))))
    loss_s, loss_d = loss_s.detach(), loss_d.detach()
    rel_loss = abs(float(loss_s) - float(loss_d)) / abs(float(loss_d))
    print(f"[train] first step: sparse loss {float(loss_s):.7f}, dense "
          f"{float(loss_d):.7f} (rel {rel_loss:.2e})", flush=True)
    for k in first:
        if k == "ln":
            want = gd["ln"]
        else:
            p = pats[k[2:]]
            keep = p.rows < p.shape[0]
            want = torch.zeros_like(first[k])
            want[keep] = gd["w_" + k[2:]][p.rows[keep].long(), p.cols[keep].long()]
        rel, diff = errors(grads[k], want)
        print(f"[check] train grad {k} against the dense products' autograd: "
              f"rel_inf_err={rel:.3e} max_abs_err={diff:.3e} "
              f"tol={RTOL['float32']:g} {'ok' if rel <= RTOL['float32'] else 'MISS'}",
              flush=True)
        if rel > RTOL["float32"] or rel_loss > RTOL["float32"]:
            fail(f"train: the grad of {k} or the loss disagrees with the "
                 "dense products")
    # times: the step (host clock, the steps after the first), its split
    # into the kernels at the gate / up / down shapes and the optimizer, and
    # the dense step of the same layer
    xn = rmsnorm(batch["x"], first["ln"], cfg.norm_eps).reshape(-1, cfg.d_model)
    xt = xn.T.contiguous()
    ht = torch.randn(cfg.d_ff, TRAIN_BATCH * TRAIN_SEQ, device=dev, generator=gen)
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    split = {"fwd_spmm_ms": 0.0, "k6_ms": 0.0, "spmm_t_ms": 0.0}
    for k, p in pats.items():
        x_in = xt if k != "down" else ht
        g_out = torch.randn(p.shape[0], n_tok, device=dev, generator=gen)
        vals = first["v_" + k]
        bal = formats.BalancedCOO(p.rows, p.cols, vals, p.shape)
        bal_t, perm = pattern_prep(p.rows, p.cols, p.shape).transposed(
            p.rows, p.cols)
        bal_t = formats.BalancedCOO(bal_t.rows, bal_t.cols, _stream_to_balanced(
            vals.reshape(-1)[perm.long()], bal_t), bal_t.shape)
        split["fwd_spmm_ms"] += time_ms(lambda: vsr.spmm_vsr_fused(bal, x_in, "sr"), reps=5)
        split["k6_ms"] += time_ms(lambda: fused_chain.sddmm_fused(
            p.rows, p.cols, g_out, x_in, shape=p.shape), reps=5)
        split["spmm_t_ms"] += time_ms(lambda: vsr.spmm_vsr_fused(bal_t, g_out, "sr"), reps=5)
    split["opt_ms"] = time_ms(lambda: adamw_update(state["params"], grads,
                                                   state["opt"], tcfg.opt), reps=5)
    dense_p = {k: v.detach().clone() for k, v in wd.items()}
    dense_step = make_train_step(
        lambda w, b: (torch.mean((dense_ffn(w, b["x"]) - b["y"]) ** 2), {}), tcfg)
    dstate = init_state(dense_p, tcfg)
    dense_s = []
    for _ in range(4):
        t0 = time.perf_counter()
        dstate, _ = dense_step(dstate, batch)
        torch.cuda.synchronize()
        dense_s.append(time.perf_counter() - t0)
    train_row = {"step_ms": 1e3 * statistics.median(step_s[1:]),
                 "first_step_ms": 1e3 * step_s[0], **split,
                 "dense_step_ms": 1e3 * statistics.median(dense_s[1:]),
                 "losses": losses}
    print("[time] train step " + " ".join(f"{k}={vv}" for k, vv in train_row.items()),
          flush=True)
    # K1 pr at N = 2048 and K6 at d = 2048 on the gate pattern, beside their
    # plain versions (a chunk of tiles at a time), the library calls and the
    # bounds: the summary's "ffn" rows
    p = pats["gate"]
    vals = first["v_gate"]
    bal = formats.BalancedCOO(p.rows, p.cols, vals, p.shape)
    g_out = torch.randn(p.shape[0], n_tok, device=dev, generator=gen)
    nnz_g = int((p.rows < p.shape[0]).sum())
    lib_w = torch.sparse_coo_tensor(
        torch.stack([p.rows.reshape(-1)[:nnz_g].long(), p.cols.reshape(-1)[:nnz_g].long()]),
        vals.reshape(-1)[:nnz_g], p.shape).to_sparse_csr()

    def k1_plain_chunked(tiles=256):
        y = torch.zeros(p.shape[0], n_tok, device=dev)
        for i in range(0, p.n_tiles, tiles):
            y += vsr.spmm_vsr_plain(formats.BalancedCOO(
                p.rows[i:i + tiles], p.cols[i:i + tiles], vals[i:i + tiles],
                p.shape), xt)
        return y

    def k6_plain_chunked(tiles=256):
        return torch.cat([fused_chain.sddmm_plain(
            p.rows[i:i + tiles], p.cols[i:i + tiles], g_out, xt, shape=p.shape)
            for i in range(0, p.n_tiles, tiles)])

    want_k1 = k1_plain_chunked()
    for design in ("sr", "pr"):
        hold("vsr_spmm", f"ffn gate N={n_tok} {design}",
             vsr.spmm_vsr_fused(bal, xt, design), want_k1, "float32")
    del want_k1
    hold("sddmm", f"ffn gate d={n_tok} par", fused_chain.sddmm_fused(
        p.rows, p.cols, g_out, xt, shape=p.shape), k6_plain_chunked(), "float32")
    ffn_bound = bound(12 * p.rows.numel() + 4 * sum(p.shape) * n_tok,
                      2 * nnz_g * n_tok)
    ffn_rows = {
        "vsr_spmm": {"shape": f"ffn gate {p.shape[0]}x{p.shape[1]} N={n_tok} sr",
                     "ms": time_ms(lambda: vsr.spmm_vsr_fused(bal, xt, "sr"), reps=5),
                     "pr_ms": time_ms(lambda: vsr.spmm_vsr_fused(bal, xt, "pr"), reps=5),
                     "plain_ms": time_ms(k1_plain_chunked, reps=2),
                     "library_ms": time_ms(lambda: lib_w @ xt, reps=5),
                     "bound_ms": ffn_bound[0], "bound_by": ffn_bound[1]},
        "sddmm": {"shape": f"ffn gate {p.shape[0]}x{p.shape[1]} d={n_tok} par",
                  "ms": time_ms(lambda: fused_chain.sddmm_fused(
                      p.rows, p.cols, g_out, xt, shape=p.shape), reps=5),
                  "plain_ms": time_ms(k6_plain_chunked, reps=2),
                  "library_ms": time_ms(lambda: torch.sparse.sampled_addmm(
                      lib_w, g_out, xt.t(), beta=0.0), reps=5),
                  "bound_ms": ffn_bound[0], "bound_by": ffn_bound[1]}}
    for k, row in ffn_rows.items():
        print(f"[time] {k} " + " ".join(f"{kk}={vv}" for kk, vv in row.items()),
              flush=True)
    del state, dstate, dense, wd, gd, grads, lib_w, bal, g_out, ht, xt
    torch.cuda.empty_cache()

    # -- 8. the backward of the chain: a GAT layer on both graphs ----------------
    phase("chain_backward")

    def hold_grad(label, got, want):
        """A gradient on the card against the plain backward's."""
        rel, diff = errors(got, want)
        ok = rel <= RTOL["float32"]
        print(f"[check] {label}: rel_inf_err={rel:.3e} max_abs_err={diff:.3e} "
              f"tol={RTOL['float32']:g} {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"{label} disagrees with the plain backward")

    spmms = ("vsr_spmm", "vsr_spmv", "csc_spmm")
    from repro_torch.core import spmm as plain_spmm, vjp as vjp_mod

    def no_plain(call, label):
        """``call()`` with every plain version a backward could reach
        counted — the ``"torch"`` registry entries, the flat SDDMM and the
        local softmax statistics — failing if any ran on the card's path."""
        ran = []
        saved = {key: e for key, e in registry._REGISTRY.items()
                 if key[1] == "torch"}
        funcs = [(plain_spmm, "_sddmm_flat"), (vjp_mod, "_sddmm_flat"),
                 (plain_spmm, "_softmax_stats")]
        real = {(mod, nm): getattr(mod, nm) for mod, nm in funcs}

        def counting(fn, nm):
            def wrapped(*args, **kw):
                ran.append(nm)
                return fn(*args, **kw)
            return wrapped
        try:
            for key, e in saved.items():
                registry._REGISTRY[key] = dataclasses.replace(
                    e, fn=counting(e.fn, key[0]))
            for (mod, nm), fn in real.items():
                setattr(mod, nm, counting(fn, nm))
            out = call()
        finally:
            registry._REGISTRY.update(saved)
            for (mod, nm), fn in real.items():
                setattr(mod, nm, fn)
        if ran:
            fail(f"{label}: plain versions ran on the card's path: {ran}")
        return out

    def spmm_bound(p_, n, d_in=None):
        """The SpMM's bound on ``p_``'s pick at N = n: its substrate's bytes
        (ELL: 8·nnz + 4·M, balanced 12·nnz) + X read and Y written."""
        m_, k_ = p_.csr.shape
        sub = p_.entry(p_.select(n)).substrate
        pb = 8 * p_.csr.nnz + 4 * m_ if sub == "ell" else 12 * p_.csr.nnz
        return bound(pb + 4 * (m_ + k_) * n, 2 * p_.csr.nnz * n)[0]

    chain_bwd_rows, k7_rows = {}, {}
    for name, csr in graphs.items():
        m, k_dim = csr.shape
        plans = {tr: repro_torch.sparse(csr, chain_op=tr)
                 for tr in ("softmax", "identity", "scale")}
        lib_a = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data,
                                        size=csr.shape, check_invariants=False)
        for tr, n in (("softmax", 1), ("softmax", 32), ("softmax", 128),
                      ("identity", 32), ("scale", 32)):
            A = plans[tr]
            p = A.plan
            a = (0.3 * randn(m, CHAIN_D)).requires_grad_()
            b = (0.3 * randn(k_dim, CHAIN_D)).requires_grad_()
            x = (randn(k_dim, n) if n > 1 else randn(k_dim)).requires_grad_()
            gy = randn(m, n) if n > 1 else randn(m)
            soft = tr == "softmax"

            def fwd_bwd():
                (A.chain(a, b, x, transform=tr, alpha=CHAIN_ALPHA) * gy).sum().backward()

            _, counts = no_plain(lambda: drive(fwd_bwd, "chain_backward"),
                                 f"chain_backward {name} {tr} N={n}")
            modes = dict(fused_chain.STATS_MODES)
            k6_took = took()["sddmm"]
            n_spmm = sum(counts[kk] for kk in spmms)
            print(f"[chain_backward] {name} {tr} N={n}: launches {counts}, "
                  f"K6 {k6_took}, K7 modes {modes}, A^T picks "
                  f"{p.transposed().select(CHAIN_D)} (d) / "
                  f"{p.transposed().select(n)} (N)", flush=True)
            if (counts["sddmm"] != 2 or counts["chain"] != 1
                    or counts["chain_stats"] != 2 * soft
                    or (soft and modes != {"full": 1, "edge": 1})
                    or n_spmm != 3 + soft):
                fail(f"chain_backward {name} {tr} N={n}: launches {counts}, "
                     f"K7 modes {modes}: expected the fused forward, K6 twice, "
                     "K7 full for softmax and 3 SpMMs (+ the row sum)")
            prow, pcol = p.pattern()
            want = chain_bwd_plain(prow, pcol, a.detach(), b.detach(),
                                   x.detach(), gy, csr.shape, tr, CHAIN_ALPHA,
                                   chunk=1 << 20)
            for label, got, w in (("dA", a.grad, want[0]), ("dB", b.grad, want[1]),
                                  ("dX", x.grad, want[2])):
                hold_grad(f"chain_backward {name} {tr} N={n} {label}", got, w)
            del want
            # times: the whole backward on a kept graph, and its split
            ad, bd, xd = a.detach(), b.detach(), x.detach()
            y = A.chain(a, b, x, transform=tr, alpha=CHAIN_ALPHA)
            vjp = _ChainVJP(p, None, entry=p.entry("chain"), transform=tr,
                            alpha=CHAIN_ALPHA)
            with torch.no_grad():
                w = vjp.weights(ad, bd)
                dw = vjp.sample(gy, xd)
                de = (CHAIN_ALPHA * w * (dw - vjp.rowsum(w * dw)[vjp.row_ids()])
                      if soft else dw * (CHAIN_ALPHA if tr == "scale" else 1.0))
                pt, perm = p.transposed(), p.transposed_perm()
                de_t, w_t = de.index_select(0, perm), w.index_select(0, perm)
                g2, x2 = gy.reshape(m, -1), xd.reshape(k_dim, -1)
                row = {"bwd_ms": time_ms(lambda: torch.autograd.grad(
                           y, (a, b, x), gy, retain_graph=True)),
                       "recompute_ms": time_ms(lambda: vjp.weights(ad, bd)),
                       "dw_ms": time_ms(lambda: vjp.sample(gy, xd)),
                       "rowsum_ms": (time_ms(lambda: vjp.rowsum(w * dw))
                                     if soft else 0.0),
                       "da_ms": time_ms(lambda: vjp.spmm(de, bd)),
                       "db_ms": time_ms(lambda: execute(pt, ad, vals=de_t)),
                       "dx_ms": time_ms(lambda: execute(pt, gy, vals=w_t)),
                       "streams_t_ms": 2 * time_ms(lambda: de.index_select(0, perm))}
                lib_de = torch.sparse_csr_tensor(csr.indptr, csr.indices, de,
                                                 size=csr.shape,
                                                 check_invariants=False)
                lib_t = [torch.sparse_csr_tensor(pt.csr.indptr, pt.csr.indices,
                                                 vv, size=pt.csr.shape,
                                                 check_invariants=False)
                         for vv in (de_t, w_t)]
                row["library_ms"] = time_ms(lambda: (
                    torch.sparse.sampled_addmm(lib_a, ad, bd.t(), beta=0.0),
                    torch.sparse.sampled_addmm(lib_a, g2, x2.t(), beta=0.0),
                    lib_de @ bd, lib_t[0] @ ad, lib_t[1] @ gy))
            slots = prow.numel()
            nnz = csr.nnz
            b_k6 = bound(12 * slots + 4 * (m + k_dim) * CHAIN_D, 2 * nnz * CHAIN_D)[0]
            b_k7 = bound(8 * slots + 4 * (m + k_dim) * CHAIN_D + 8 * m,
                         2 * nnz * CHAIN_D)[0] if soft else 0.0
            b_dw = bound(12 * slots + 4 * (m + k_dim) * n, 2 * nnz * n)[0]
            row["bound_ms"] = (b_k6 + b_k7 + b_dw + (spmm_bound(p, 1) if soft else 0.0)
                               + spmm_bound(p, CHAIN_D) + spmm_bound(pt, CHAIN_D)
                               + spmm_bound(pt, n))
            row["rest_ms"] = row["bwd_ms"] - sum(
                row[kk] for kk in ("recompute_ms", "dw_ms", "rowsum_ms", "da_ms",
                                   "db_ms", "dx_ms", "streams_t_ms"))
            row["picks"] = {"rowsum": p.select(1), "dA": p.select(CHAIN_D),
                            "dB": pt.select(CHAIN_D), "dX": pt.select(n)}
            if soft and n == 1:
                # K7 in full mode, the recompute's statistics, alone: its
                # bound and plain version (the kernel table's backward row)
                b7 = bound(8 * slots + 4 * (m + k_dim) * CHAIN_D + 8 * m,
                           2 * nnz * CHAIN_D)
                k7_rows[name] = {
                    "ms": time_ms(lambda: fused_chain.chain_stats_fused(
                        prow, pcol, ad, bd, shape=csr.shape, alpha=CHAIN_ALPHA,
                        blocks=p.kernel_opts(p.entry("chain"))["blocks"])),
                    "plain_ms": time_ms(lambda: fused_chain.chain_stats_plain(
                        prow, pcol, ad, bd, shape=csr.shape, alpha=CHAIN_ALPHA),
                        reps=3),
                    "bound_ms": b7[0], "bound_by": b7[1], "library_ms": None,
                    "shape": f"{name}_s{args.scale}_e16 d={CHAIN_D} full mode "
                             "(the chain's backward)"}
            chain_bwd_rows[(name, tr, n)] = row
            print(f"[time] chain_backward {name}_s{args.scale}_e16 {tr} d={CHAIN_D} "
                  f"N={n} " + " ".join(f"{kk}={vv}" for kk, vv in row.items()),
                  flush=True)
            del y, w, dw, de, de_t, w_t, lib_de, lib_t, a, b, x, gy
        del plans, lib_a
        torch.cuda.empty_cache()

    # -- 9. the GAT training path at the GAT cell's width -------------------------
    phase("gat_train")
    ends = []

    def on_step(i, loss):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    t0 = time.perf_counter()
    gat_losses, counts = no_plain(lambda: drive(lambda: train_gat.train(
        scale=args.scale, edge_factor=16, d_in=CHAIN_D, d_head=CHAIN_D,
        steps=GAT_STEPS, seed=args.seed, on_step=on_step), "gat_train"),
        "gat_train")
    t_gat = time.perf_counter() - t0
    steps_ms = [1e3 * (t1 - t0_) for t0_, t1 in zip(ends, ends[1:])]
    gat_row = {"step_ms": statistics.median(steps_ms), "steps_ms": steps_ms,
               "launches_a_step": {kk: vv / GAT_STEPS for kk, vv in counts.items() if vv},
               "losses": gat_losses, "total_s": t_gat}
    print("[time] gat_train " + " ".join(f"{kk}={vv}" for kk, vv in gat_row.items()),
          flush=True)
    if not all(np.isfinite(gat_losses)) or not gat_losses[-1] < gat_losses[0]:
        fail(f"gat_train: the loss did not fall: {gat_losses}")
    if (counts["chain"] != GAT_STEPS or counts["sddmm"] != 2 * GAT_STEPS
            or counts["chain_stats"] != 2 * GAT_STEPS
            or sum(counts[kk] for kk in spmms) != 4 * GAT_STEPS):
        fail(f"gat_train: launches {counts}, expected a step the fused chain, "
             "K6 twice, K7 twice and 4 SpMMs")
    torch.cuda.empty_cache()

    # -- 10. the backward of block-sparse attention: Gemma-3-12B's local layer ----
    phase("attention_backward")
    g = attn["gemma"]
    p_att = repro_torch.attention_plan(g["spec"])
    sc = gemma.head_dim ** -0.5
    gcsr = g["csr"]
    arows, acols = p_att.pattern()
    rep = gemma.num_heads // gemma.num_kv_heads
    qt, kt, vt = (t.detach().clone().requires_grad_() for t in (gq, gk, gv))
    gyl = randn(*gq.shape)

    def layer_fwd_bwd():
        (transformer._block_sparse_attention(qt, kt, vt, gemma, True) * gyl).sum().backward()

    _, counts = no_plain(lambda: drive(layer_fwd_bwd, "attention_backward"),
                         "attention_backward layer")
    att_took = took()
    nh = gemma.num_heads
    print(f"[attention_backward] gemma_local layer: launches {counts}, K7 "
          f"{att_took['chain_stats']}, K8 {att_took['chain']}", flush=True)
    if (counts["sddmm"] != 2 * nh or counts["chain_stats"] != 2 * nh
            or counts["chain"] != nh or att_took["chain_stats"]["block"] != 2 * nh
            or sum(counts[kk] for kk in spmms) != 4 * nh):
        fail(f"attention_backward: launches {counts}, designs {att_took}: "
             "expected a head the block K7 twice, K8, K6 twice and 4 SpMMs")
    h = CHECK_HEAD
    q1, k1, v1 = (gq[0, h].clone(), gk[0, h // rep].clone(), gv[0, h // rep].clone())
    gy1 = gyl[0, h].contiguous()
    zero_slab = torch.zeros(arows.shape, device=dev)
    want = attn_bwd_plain(arows, acols, q1, k1, zero_slab, v1, gy1, gcsr.shape,
                          sc, chunk=1 << 19)
    hold_grad(f"attention_backward layer head {h} dQ", qt.grad[0, h], want[0])
    # one head through execute_attention, without and with the ALiBi bias
    att_rows = {}
    for label, bias in (("gemma_local", None), ("gemma_local_alibi", g["bias"])):
        ql, kl, vl = (t.clone().requires_grad_() for t in (q1, k1, v1))
        bl = None if bias is None else bias.clone().requires_grad_()
        leaves = (ql, kl, vl) if bl is None else (ql, kl, vl, bl)

        def head_fwd_bwd():
            (execute_attention(p_att, ql, kl, vl, bias=bl) * gy1).sum().backward()

        _, counts = no_plain(lambda: drive(head_fwd_bwd, "attention_backward"),
                             f"attention_backward {label}")
        slab = zero_slab if bias is None else _stream_to_balanced(bias, g["bal"])
        want = attn_bwd_plain(arows, acols, q1, k1, slab, v1, gy1, gcsr.shape,
                              sc, chunk=1 << 19)
        for nm, got, w in (("dQ", ql.grad, want[0]), ("dK", kl.grad, want[1]),
                           ("dV", vl.grad, want[3])):
            hold_grad(f"attention_backward {label} head {h} {nm}", got, w)
        if bl is not None:
            hold_grad(f"attention_backward {label} head {h} dBias", bl.grad,
                      want[2].reshape(-1)[:gcsr.nnz])
        y1 = execute_attention(p_att, ql, kl, vl, bias=bl)
        entry = p_att.entry("chain" if bl is None else "attn_chain")
        vjp = _ChainVJP(p_att, None, entry=entry, transform="softmax", alpha=sc)
        with torch.no_grad():
            slab_d = None if bl is None else slab
            w = vjp.weights(q1, k1, slab_d)
            dw = vjp.sample(gy1, v1)
            dz = w * (dw - vjp.rowsum(w * dw)[vjp.row_ids()])
            pt, perm = p_att.transposed(), p_att.transposed_perm()
            de_t, w_t = (sc * dz).index_select(0, perm), w.index_select(0, perm)
            row = {"bwd_ms": time_ms(lambda: torch.autograd.grad(
                       y1, leaves, gy1, retain_graph=True)),
                   "recompute_ms": time_ms(lambda: vjp.weights(q1, k1, slab_d)),
                   "dw_ms": time_ms(lambda: vjp.sample(gy1, v1)),
                   "rowsum_ms": time_ms(lambda: vjp.rowsum(w * dw)),
                   "dq_ms": time_ms(lambda: vjp.spmm(sc * dz, k1)),
                   "dk_ms": time_ms(lambda: execute(pt, q1, vals=de_t)),
                   "dv_ms": time_ms(lambda: execute(pt, gy1, vals=w_t)),
                   "streams_t_ms": 2 * time_ms(lambda: dz.index_select(0, perm))}
            mask = dense_mask(gcsr, bias)
            qs, ks, vs = (t[None, None].clone().requires_grad_() for t in (q1, k1, v1))
            sdpa = torch.nn.functional.scaled_dot_product_attention
        row["fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            execute_attention(p_att, ql, kl, vl, bias=bl), leaves, gy1))
        row["library_ms"] = time_ms(lambda: torch.autograd.grad(
            sdpa(qs, ks, vs, attn_mask=mask), (qs, ks, vs), gy1[None, None]))
        d_ = gemma.head_dim
        m_ = gcsr.shape[0]
        b_k6 = bound(12 * arows.numel() + 8 * m_ * d_, 2 * gcsr.nnz * d_)[0]
        row["bound_ms"] = (3 * b_k6 + spmm_bound(p_att, 1) + spmm_bound(p_att, d_)
                           + 2 * spmm_bound(pt, d_))
        row["rest_ms"] = row["bwd_ms"] - sum(
            row[kk] for kk in ("recompute_ms", "dw_ms", "rowsum_ms", "dq_ms",
                               "dk_ms", "dv_ms", "streams_t_ms"))
        att_rows[label] = row
        print(f"[time] attention_backward {label} head {h} seq={m_} d=N={d_} "
              + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        del y1, w, dw, dz, de_t, w_t, mask, qs, ks, vs
    # the layer: its backward on a kept graph, beside SDPA forward and
    # backward over all heads on the dense boolean mask
    yl = transformer._block_sparse_attention(qt, kt, vt, gemma, True)
    layer_row = {"layer_bwd_ms": time_ms(lambda: torch.autograd.grad(
                     yl, (qt, kt, vt), gyl, retain_graph=True), reps=3),
                 "layer_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                     transformer._block_sparse_attention(qt, kt, vt, gemma, True),
                     (qt, kt, vt), gyl), reps=3)}
    del yl
    mask = dense_mask(gcsr, None)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (gq, gkr, gvr))
    try:
        layer_row["sdpa_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            sdpa(qs, ks, vs, attn_mask=mask), (qs, ks, vs), gyl), reps=3)
    except (RuntimeError, torch.OutOfMemoryError) as err:
        layer_row["sdpa_fwd_bwd_ms"] = None
        print(f"[time] sdpa backward failed: {err}", flush=True)
    print(f"[time] attention_backward gemma_local layer {nh} heads seq={ATTN_SEQ} "
          + " ".join(f"{kk}={vv}" for kk, vv in layer_row.items()), flush=True)
    del mask, qs, ks, vs, qt, kt, vt, gyl, want, zero_slab
    torch.cuda.empty_cache()

    # -- 11. the backward of the block-pruned weight on the "bsr" backend ---------
    phase("bsr_backward")
    W = repro_torch.sparse(w_csr, backend="bsr")
    t0 = time.perf_counter()
    wpt = W.plan.transposed()
    wsub_t = wpt.substrate("bsr")
    torch.cuda.synchronize()
    print(f"[bsr_backward] A^T {wpt.csr.shape} block {wsub_t.block_shape}: "
          f"{wsub_t.nblocks} blocks (A: {w_bsr.nblocks}); transposed plan and "
          f"its BSR {time.perf_counter() - t0:.3f} s (host clock)", flush=True)
    if wsub_t.nblocks != w_bsr.nblocks or wsub_t.block_shape != BSR_BLOCK[::-1]:
        fail("bsr_backward: A^T's BSR is not the block transpose of A's")
    wperm = W.plan.transposed_perm()
    lib_wt = torch.sparse_csr_tensor(wpt.csr.indptr, wpt.csr.indices,
                                     wpt.csr.data, size=wpt.csr.shape,
                                     check_invariants=False)
    wrows, wcols = W.plan.pattern()
    brow = W.plan.bsr_brow()
    bsr_bwd_rows = {}
    for n in NS:
        v = w_csr.data.clone().requires_grad_()
        x = (randn(d_model, n) if n > 1 else randn(d_model)).requires_grad_()
        gy = randn(d_ff, n) if n > 1 else randn(d_ff)
        g2, x2 = gy.reshape(d_ff, -1), x.detach().reshape(d_model, -1)

        def fwd_bwd():
            (W.with_values(v) @ x * gy).sum().backward()

        _, counts = no_plain(lambda: drive(fwd_bwd, "bsr_backward"),
                             f"bsr_backward N={n}")
        k11_took = took()["bsr_spmm"]
        t_design = bsr._design(wsub_t, g2)
        print(f"[bsr_backward] N={n}: launches {counts}, K11 {k11_took} "
              f"(A^T: {t_design})", flush=True)
        if counts["sddmm"] != 1 or counts["bsr_spmm"] != 2 \
                or sum(counts.values()) != 3 or k11_took[t_design] < 1:
            fail(f"bsr_backward N={n}: launches {counts}, K11 {k11_took}: "
                 "expected K11 forward, K6 and K11 on A^T")
        dblocks, dx = bsr_bwd_plain(w_bsr, brow, x.detach(), gy)
        hold_grad(f"bsr_backward N={n} dvals", v.grad,
                  dblocks[tuple(W.plan.bsr_map().long())])
        hold_grad(f"bsr_backward N={n} dX", x.grad, dx)
        hold("bsr_spmm", f"gemma ffn_up A^T {wsub_t.block_shape} N={n} {t_design}",
             bsr.spmm_bsr(wsub_t, gy), bsr.spmm_bsr_plain(wsub_t, gy), "float32")
        del dblocks, dx
        y = W.with_values(v) @ x
        with torch.no_grad():
            vt_ = v.detach().index_select(0, wperm)
            live_t = _fill_bsr(wsub_t, wpt.bsr_map(), vt_, False)
            t_layout = wpt.kernel_opts(wpt.entry("nb_pr"))["layout"]
            row = {"bwd_ms": time_ms(lambda: torch.autograd.grad(
                       y, (v, x), gy, retain_graph=True)),
                   "k6_ms": time_ms(lambda: W.plan.pattern_prep().sample(
                       wrows, wcols, g2, x2, "hopper")),
                   "k11_t_ms": time_ms(lambda: bsr.spmm_bsr(live_t, gy,
                                                            layout=t_layout)),
                   "k11_t_design": t_design,
                   "k11_t_plain_ms": time_ms(lambda: bsr.spmm_bsr_plain(live_t, gy),
                                             reps=5),
                   "stream_t_ms": time_ms(lambda: _fill_bsr(
                       wsub_t, wpt.bsr_map(), v.detach().index_select(0, wperm),
                       False)),
                   "dense_ms": time_ms(lambda: (g2 @ x2.t(), w_gpu.t() @ g2)),
                   "library_ms": time_ms(lambda: lib_wt @ gy)}
        nbw = w_bsr.nblocks * BSR_BLOCK[0] * BSR_BLOCK[1]
        b6 = bound(12 * wrows.numel() + 4 * (d_ff + d_model) * n, 2 * w_csr.nnz * n)
        b11 = bound(4 * nbw + 4 * wsub_t.nblocks + 4 * (d_ff + d_model) * n,
                    2 * nbw * n)
        row.update({"bound_ms": b6[0] + b11[0], "k6_bound_ms": b6[0],
                    "k11_t_bound_ms": b11[0], "k11_t_bound_by": b11[1]})
        row["rest_ms"] = row["bwd_ms"] - row["k6_ms"] - row["k11_t_ms"] - row["stream_t_ms"]
        bsr_bwd_rows[n] = row
        print(f"[time] bsr_backward gemma ffn_up N={n} "
              + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        del y, v, x, gy, live_t, vt_
    del W, lib_wt
    torch.cuda.empty_cache()


    # -- 12. quant ----------------------------------------------------------------
    phase("quant")

    def coded_launches():
        return {k: {vt: nn for vt, nn in by_type.items() if nn}
                for k, by_type in value_counts.items() if any(by_type.values())}

    def coded_bound(nnz, n_tiles, m_, k_, n):
        """The coded SpMM's least time: 9 B a nonzero (int32 row and column,
        one code), 4 B a tile's scale, X read and Y written once (f32)."""
        return bound(9 * nnz + 4 * n_tiles + 4 * k_ * n + 4 * m_ * n, 2 * nnz * n)

    quant_rows, coded_rows = {}, {}
    for mode in QUANT_MODES:
        for name, csr in graphs.items():
            m, k_dim = csr.shape
            F = repro_torch.sparse(csr)                   # the float plan
            fbal = F.plan.substrate("balanced")
            t0 = time.perf_counter()
            Q = repro_torch.sparse(csr, quant=mode, cache=False)
            qbal, sc = Q.plan.substrate("balanced"), Q.plan.quant_scales()
            plan_s = time.perf_counter() - t0
            if Q.plan.quant != mode or qbal.vals.dtype != quant.quant_dtype(mode):
                fail(f"quant {mode} {name}: the plan holds {qbal.vals.dtype} "
                     f"(quant={Q.plan.quant!r})")
            # the codes made on the card, bit-equal to those made on the CPU
            q_cpu, sc_cpu = quant.quantize_stream(fbal.vals.cpu(), mode)
            same = (torch.equal(qbal.vals.view(torch.uint8).cpu(),
                                q_cpu.view(torch.uint8))
                    and torch.equal(sc.cpu(), sc_cpu))
            print(f"[quant] {mode} {name}: plan {plan_s:.1f} s, {qbal.n_tiles} "
                  f"tiles, scales {float(sc.min()):.3e}..{float(sc.max()):.3e}, "
                  f"codes bit-equal to the CPU's: {same}", flush=True)
            if not same:
                fail(f"quant {mode} {name}: the card's codes or scales differ "
                     "from the CPU's")
            del q_cpu, sc_cpu
            decoded = quant.dequantize_stream(qbal.vals, sc).reshape(-1)[:csr.nnz]
            lib_q = torch.sparse_csr_tensor(csr.indptr, csr.indices, decoded,
                                            size=csr.shape, check_invariants=False)
            for n in NS:
                x = randn(k_dim, n) if n > 1 else randn(k_dim)
                pick, fpick = Q.plan.select(n), F.plan.select(n)
                if not pick.startswith("nb_") or pick[3:] != fpick[3:]:
                    fail(f"quant {mode} {name} N={n}: picked {pick} (float "
                         f"plan {fpick}); expected nb_{fpick[3:]}")
                kernel = kernel_of(pick, n)
                label = f"{name} N={n}"
                y, counts = no_plain(lambda: drive(lambda: Q @ x, "quant"),
                                     f"quant {mode} {label}")
                took_q, coded = took(), coded_launches()
                if counts != {kk: int(kk == kernel) for kk in KERNELS} \
                        or coded != {kernel: {mode: 1}}:
                    fail(f"quant {mode} {label}: launches {counts}, by value "
                         f"{coded}; expected one coded {kernel}")
                if kernel == "vsr_spmm" and took_q["vsr_spmm"][pick[3:]] != 1:
                    fail(f"quant {mode} {label}: {pick} did not take K1's "
                         f"{pick[3:]} design ({took_q['vsr_spmm']})")
                key = f"{kernel}:{mode}"
                hold_empty(key, label, y)
                hold(key, f"{label} plan vs the torch backend", y,
                     Q.matmul(x, backend="torch"), "float32")
                if n > 1:
                    run = lambda b, s_=None: vsr.spmm_vsr_fused(b, x, pick[3:], scales=s_)
                    plain = lambda: vsr.spmm_vsr_plain(qbal, x, sc)
                else:
                    run = lambda b, s_=None: spmv.spmv_vsr_fused(b, x, scales=s_)
                    plain = lambda: spmv.spmv_vsr_plain(qbal, x, sc)
                b_ms, b_by = coded_bound(csr.nnz, qbal.n_tiles, m, k_dim, n)
                f_ms, _ = bound(12 * csr.nnz + 4 * k_dim * n + 4 * m * n,
                                2 * csr.nnz * n)
                row = {"pick": pick, "kernel": kernel,
                       "kernel_ms": time_ms(lambda: run(qbal, sc)),
                       "call_ms": time_ms(lambda: Q @ x),
                       "f32_kernel_ms": time_ms(lambda: run(fbal)),
                       "f32_call_ms": time_ms(lambda: F @ x),
                       "f32_pick": fpick,
                       "plain_ms": time_ms(plain, reps=5),
                       "library_ms": time_ms(lambda: lib_q @ x),
                       "bound_ms": b_ms, "bound_by": b_by, "f32_bound_ms": f_ms}
                quant_rows[(mode, name, n)] = row
                if CODED_SHAPE[kernel] == (name, n):
                    coded_rows[key] = dict(row, shape=f"{name}_s{args.scale}_e16 N={n}")
                if (kernel, name, n) == ("vsr_spmm", "g500", 4):
                    coded_rows[f"{key}:pr"] = dict(row, shape=f"{name}_s{args.scale}_e16 N={n}")
                print(f"[time] quant {mode} {name}_s{args.scale}_e16 N={n} "
                      + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
            # the spill opt on the quantized uniform plan: K5 at N = 1, K4
            # above, on the codes
            if name == "unif":
                sopts = Q.plan.kernel_opts(Q.plan.entry("nb_pr"))
                sopts["spill"] = True
                s_base, s_win = sopts["windows"](qbal)
                for n in NS:
                    x = randn(k_dim, n) if n > 1 else randn(k_dim)
                    kernel = "vsr_spmv_spill" if n == 1 else "vsr_spmm_spill"
                    label = f"{name} N={n} spill"
                    y, counts = no_plain(lambda: drive(
                        lambda: Q.matmul(x, impl="nb_pr"), "quant"),
                        f"quant {mode} {label}")
                    coded = coded_launches()
                    if counts != {kk: int(kk in (kernel, "spill_combine"))
                                  for kk in KERNELS} \
                            or coded != {kernel: {mode: 1}}:
                        fail(f"quant {mode} {label}: launches {counts}, by "
                             f"value {coded}; expected one coded {kernel} and "
                             "the combine")
                    key = f"{kernel}:{mode}"
                    hold(key, label, y, Q.matmul(x, impl="nb_pr", backend="torch"),
                         "float32")
                    x2 = x if n > 1 else x[:, None]
                    if n > 1:
                        run = lambda b, s_=None: vsr.spmm_vsr_partials(
                            b, x, s_base, s_win, scales=s_)
                    else:
                        run = lambda b, s_=None: spmv.spmv_vsr_partials(
                            b, x, s_base, s_win, scales=s_)
                    part_bytes = 4 * qbal.n_tiles * s_win * n
                    b_ms, b_by = bound(9 * csr.nnz + 4 * qbal.n_tiles + 4 * k_dim * n
                                       + part_bytes, 2 * csr.nnz * n)
                    f_ms, _ = bound(12 * csr.nnz + 4 * k_dim * n + part_bytes,
                                    2 * csr.nnz * n)
                    row = {"kernel": kernel, "win": s_win,
                           "kernel_ms": time_ms(lambda: run(qbal, sc)),
                           "call_ms": time_ms(lambda: Q.matmul(x, impl="nb_pr")),
                           "f32_kernel_ms": time_ms(lambda: run(fbal)),
                           "plain_ms": time_ms(lambda: vsr.spill_partials_plain(
                               qbal, x2, s_base, s_win, sc), reps=5),
                           "library_ms": time_ms(lambda: lib_q @ x),
                           "bound_ms": b_ms, "bound_by": b_by, "f32_bound_ms": f_ms}
                    if CODED_SHAPE[kernel] == (name, n):
                        coded_rows[key] = dict(
                            row, shape=f"{name}_s{args.scale}_e16 N={n} win={s_win}")
                    print(f"[time] quant {mode} spill {name}_s{args.scale}_e16 N={n} "
                          + " ".join(f"{kk}={vv}" for kk, vv in row.items()),
                          flush=True)
                sopts["spill"] = False
            # a backward through the baked plan: the forward coded, dX on
            # A^T's unquantized plan over the decoded stream
            n = 32
            xg = randn(k_dim, n).requires_grad_()
            gy = randn(m, n)
            _, counts = no_plain(lambda: drive(
                lambda: (Q @ xg * gy).sum().backward(), "quant"),
                f"quant {mode} {name} backward")
            coded = coded_launches()
            if coded.get("vsr_spmm", {}).get(mode) != 1 or sum(
                    nn for k, by in coded.items() for vt, nn in by.items()
                    if vt == mode) != 1:
                fail(f"quant {mode} {name} backward: launches by value {coded}; "
                     "expected one coded forward")
            want_dx = coo_bwd_chunked(csr, decoded, xg.detach(), gy)[1]
            hold_grad(f"quant {mode} {name} N={n} baked dX against the decoded "
                      "A^T G", xg.grad, want_dx)
            print(f"[quant] {mode} {name} backward N={n}: launches "
                  f"{ {k: v for k, v in counts.items() if v} }, by value {coded}",
                  flush=True)
            del xg, gy, want_dx, lib_q, decoded, Q, F, qbal, sc, fbal
            torch.cuda.empty_cache()

    # pattern_matmul(quant="int8") on the Gemma-3-12B FFN gate pattern at
    # 2,048 tokens: the live values quantized on the card, coded K1 sr; the
    # backward straight through (K6 and K1 on W^T's slabs, f32)
    gp, gv = pats["gate"], first["v_gate"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    xp = randn(gp.shape[1], tokens)
    gyp = randn(gp.shape[0], tokens)
    vq = gv.clone().requires_grad_()
    xq = xp.clone().requires_grad_()
    reset_launch_counts()
    yq, counts = no_plain(lambda: drive(lambda: repro_torch.pattern_matmul(
        gp.rows, gp.cols, vq, gp.shape, xq, quant="int8"), "quant"),
        "quant pattern_matmul forward")
    coded = coded_launches()
    if counts["vsr_spmm"] != 1 or coded != {"vsr_spmm": {"int8": 1}}:
        fail(f"quant pattern_matmul: launches {counts}, by value {coded}; "
             "expected one int8 K1")
    _, bcounts = no_plain(lambda: drive(lambda: (yq * gyp).sum().backward(),
                                        "quant"), "quant pattern_matmul backward")
    bcoded = coded_launches()
    if bcounts["sddmm"] != 1 or bcounts["vsr_spmm"] != 1 or "int8" in str(bcoded):
        fail(f"quant pattern_matmul backward: launches {bcounts}, by value "
             f"{bcoded}; expected K6 and one f32 K1 on W^T")
    q_g, sc_g = quant.quantize_stream(gv, "int8")
    w_dec = gp.to_dense(quant.dequantize_stream(q_g, sc_g))
    w_f = gp.to_dense(gv)
    hold("vsr_spmm:int8", "gemma ffn_gate pattern_matmul N=2048", yq.detach(),
         w_dec @ xp, "float32")
    keep = gp.rows < gp.shape[0]
    want_dv = torch.zeros_like(gv)
    want_dv[keep] = (gyp @ xp.T)[gp.rows[keep].long(), gp.cols[keep].long()]
    hold_grad("quant pattern_matmul dvals (straight through) against the dense "
              "product", vq.grad, want_dv)
    hold_grad("quant pattern_matmul dX (straight through) against W^T G",
              xq.grad, w_f.T @ gyp)
    lib_w = w_dec.to_sparse_csr()
    nnz_g = int(keep.sum())
    b_ms, b_by = coded_bound(nnz_g, gp.n_tiles, *gp.shape, tokens)
    qb = formats.BalancedCOO(gp.rows, gp.cols, q_g, gp.shape)
    fb = formats.BalancedCOO(gp.rows, gp.cols, gv, gp.shape)
    pm_row = {"kernel_ms": time_ms(lambda: vsr.spmm_vsr_fused(qb, xp, "sr", scales=sc_g)),
              "call_ms": time_ms(lambda: repro_torch.pattern_matmul(
                  gp.rows, gp.cols, gv, gp.shape, xp, quant="int8")),
              "f32_kernel_ms": time_ms(lambda: vsr.spmm_vsr_fused(fb, xp, "sr")),
              "f32_call_ms": time_ms(lambda: repro_torch.pattern_matmul(
                  gp.rows, gp.cols, gv, gp.shape, xp)),
              "library_ms": time_ms(lambda: lib_w @ xp),
              "dense_ms": time_ms(lambda: w_dec @ xp),
              "bound_ms": b_ms, "bound_by": b_by,
              "launches_fwd": {k: v for k, v in counts.items() if v},
              "launches_bwd": {k: v for k, v in bcounts.items() if v}}
    print("[time] quant pattern_matmul gemma ffn_gate int8 N=2048 "
          + " ".join(f"{kk}={vv}" for kk, vv in pm_row.items()), flush=True)
    del vq, xq, yq, xp, gyp, w_dec, w_f, lib_w, qb, fb, q_g, sc_g
    torch.cuda.empty_cache()

    # -- 13. offline ----------------------------------------------------------------
    phase("offline")
    import os
    import tempfile
    from repro_torch.core.rmat import rmat_suite
    from repro_torch.core.selector import (THRESHOLDS_ENV, default_thresholds,
                                           select_kernel, slowdown_vs_oracle)
    from repro_torch.core.stats import matrix_stats
    from repro_torch.examples import quickstart

    def multi_rows(csr, tile):
        """Rows three or more tiles hold: the NB kernels add their partial
        sums by atomics, in no fixed order (rows of one or two tiles have
        one order)."""
        ip = csr.indptr.long()
        return (ip[1:] > ip[:-1]) & ((ip[1:] - 1) // tile - ip[:-1] // tile >= 2)

    def agree(got, want, multi):
        """``(bit_equal, ok, max_abs_diff)``: bit-equal on every row outside
        ``multi``, within 1e-6 of the largest magnitude on ``multi``."""
        diff = float((got - want).abs().max()) if got.numel() else 0.0
        keep = ~multi if got.ndim == 1 else (~multi)[:, None].expand_as(got)
        ok = torch.equal(got[keep], want[keep]) and \
            diff <= 1e-6 * max(float(want.abs().max()), 1e-30)
        return diff == 0.0, ok, diff

    def host_builds():
        return (dict(formats.BUILD_COUNTS), PATTERN_PREP["builds"])

    def guarded(call):
        """``call()`` with a device sync turned into an error."""
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def capture(call):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = guarded(call)
        return graph, out

    # (a) the selector's calibration over the paper's R-MAT suite
    t0 = time.perf_counter()
    suite = rmat_suite(seed=args.seed, device=dev)
    suite_stats = {name: matrix_stats(c) for name, c in suite.items()}
    print(f"[offline] rmat_suite: {len(suite)} matrices in "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    for name, st in suite_stats.items():
        # the ELL the rs kernels need, reckoned before calibrate builds it
        print(f"[offline] {name}: M={st.m} nnz={st.nnz} avg_row={st.avg_row:.2f} "
              f"cv={st.cv:.2f} max_row={st.max_row} ell="
              f"{st.m * max(st.max_row, 1) * 8 / 1e9:.3f} GB", flush=True)
    t0 = time.perf_counter()
    (best, report), cal_counts = drive(lambda: repro_torch.calibrate_backend(
        matrices=suite, ns=CAL_NS, repeats=CAL_REPEATS, backend="hopper"),
        "offline")
    cal_s = time.perf_counter() - t0
    cal_times = {}
    for key, t in report["times"].items():
        mname, n_s, kname = key.split("|")
        cal_times[(mname, int(n_s[2:]), kname)] = t
    if len(cal_times) != len(suite) * len(CAL_NS) * 4 or \
            not all(np.isfinite(t) and t > 0 for t in cal_times.values()):
        fail(f"offline: calibration times {len(cal_times)}, not all finite")
    loss_default = slowdown_vs_oracle(suite_stats, CAL_NS, cal_times, default_th)
    loss_best = report["geomean_slowdown_vs_oracle"]
    for mname, st in suite_stats.items():
        for n in CAL_NS:
            ts = {k: 1e3 * cal_times[(mname, n, k)] for k in ("rs_sr", "rs_pr",
                                                             "nb_sr", "nb_pr")}
            print(f"[offline] cal {mname} N={n} "
                  + " ".join(f"{k}={v:.4f}" for k, v in ts.items())
                  + f" oracle={min(ts, key=ts.get)}"
                  f" default={select_kernel(st, n, default_th)}"
                  f" calibrated={select_kernel(st, n, best)}", flush=True)
    cal_row = {"n_threshold": best.n_threshold, "pr_avg_row": best.pr_avg_row,
               "sr_cv": best.sr_cv, "loss_calibrated": loss_best,
               "loss_default": loss_default, "seconds": round(cal_s, 1),
               "timing": {m: list(report["timing"].values()).count(m)
                          for m in set(report["timing"].values())},
               "launches": {k: v for k, v in cal_counts.items() if v}}
    print("[offline] calibration " + json.dumps(cal_row), flush=True)
    if not loss_best <= loss_default:
        fail(f"offline: the calibrated loss {loss_best} exceeds the "
             f"defaults' {loss_default}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "thresholds.json")
        save_to_env = os.environ.get(THRESHOLDS_ENV)
        repro_torch.api.save_thresholds(best, path)
        os.environ[THRESHOLDS_ENV] = path
        try:
            reloaded = default_thresholds()
        finally:
            if save_to_env is None:
                os.environ.pop(THRESHOLDS_ENV)
            else:
                os.environ[THRESHOLDS_ENV] = save_to_env
    if reloaded != best:
        fail(f"offline: $REPRO_THRESHOLDS reloaded {reloaded}, not {best}")

    # the same grid search on device time alone: each (matrix, N, kernel)
    # from a full-coverage artifact, its call captured in a CUDA graph, the
    # mean of CAL_REPEATS back-to-back replays (calibrate_backend's times
    # hold the host's dispatch too, which a call of these sizes waits on)
    def graph_times():
        out = {}
        for mname, c in suite.items():
            art = repro_torch.sparse(c, cache=False).finalize()
            for n in CAL_NS:
                x = randn(c.shape[1], n) if n > 1 else randn(c.shape[1])
                for kname in ("rs_sr", "rs_pr", "nb_sr", "nb_pr"):
                    graph, _ = capture(
                        lambda: repro_torch.execute(art, x, impl=kname))
                    graph.replay()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(CAL_REPEATS):
                        graph.replay()
                    end.record()
                    end.synchronize()
                    out[(mname, n, kname)] = (start.elapsed_time(end) / 1e3
                                              / CAL_REPEATS)
        return out
    t0 = time.perf_counter()
    g_times, g_counts = drive(graph_times, "offline")
    g_best, g_report = repro_torch.calibrate(suite, CAL_NS, times=g_times)
    for mname, st in suite_stats.items():
        for n in CAL_NS:
            ts = {k: 1e3 * g_times[(mname, n, k)] for k in ("rs_sr", "rs_pr",
                                                           "nb_sr", "nb_pr")}
            print(f"[offline] cal_graph {mname} N={n} "
                  + " ".join(f"{k}={v:.4f}" for k, v in ts.items())
                  + f" oracle={min(ts, key=ts.get)}"
                  f" default={select_kernel(st, n, default_th)}"
                  f" calibrated={select_kernel(st, n, g_best)}", flush=True)
    graph_row = {"n_threshold": g_best.n_threshold,
                 "pr_avg_row": g_best.pr_avg_row, "sr_cv": g_best.sr_cv,
                 "loss_calibrated": g_report["geomean_slowdown_vs_oracle"],
                 "loss_default": slowdown_vs_oracle(suite_stats, CAL_NS,
                                                    g_times, default_th),
                 "loss_eager_winner": slowdown_vs_oracle(suite_stats, CAL_NS,
                                                         g_times, best),
                 "seconds": round(time.perf_counter() - t0, 1),
                 "launches": {k: v for k, v in g_counts.items() if v}}
    print("[offline] calibration_graph " + json.dumps(graph_row), flush=True)
    if not all(np.isfinite(t) and t > 0 for t in g_times.values()):
        fail("offline: graph-replay calibration times not all finite")
    del suite
    torch.cuda.empty_cache()

    # (b) the frozen artifacts at full size
    offline_rows = {}

    def artifact_case(label, A, art, n, impl, kernel, multi, bound_ms):
        """One artifact call against the builder's: launches, host builds,
        agreement, graph replays and the three times."""
        m_, k_ = A.shape
        x = randn(k_, n) if n > 1 else randn(k_)
        y_b = A.matmul(x, impl=impl)
        before = host_builds()
        y_a, counts = drive(lambda: guarded(
            lambda: repro_torch.execute(art, x, impl=impl)), "offline")
        if host_builds() != before:
            fail(f"offline {label}: execute(artifact) built on the host")
        if counts[kernel] != 1 or sum(counts.values()) != 1:
            fail(f"offline {label}: {counts}, not one launch of {kernel}")
        bit, ok, diff = agree(y_a, y_b, multi)
        rel_p, _ = errors(y_a, A.matmul(x, impl=impl, backend="torch"))
        if not ok or rel_p > 1e-4:
            fail(f"offline {label}: artifact against builder {diff} "
                 f"(bit-equal {bit}), against the plain version {rel_p}")
        graph, y_g = capture(lambda: repro_torch.execute(art, x, impl=impl))
        replays = []
        for _ in range(GRAPH_REPLAYS):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(agree(y_g, y_a, multi))
        if not all(r[1] for r in replays):
            fail(f"offline {label}: graph replays {replays}")
        row = {"kernel": kernel, "multi_rows": int(multi.sum()),
               "bit_equal": bit, "max_abs_diff": diff, "rel_err_plain": rel_p,
               "replays_bit_equal": sum(r[0] for r in replays),
               "builder_ms": time_ms(lambda: A.matmul(x, impl=impl)),
               "artifact_ms": time_ms(lambda: repro_torch.execute(art, x, impl=impl)),
               "graph_ms": time_ms(graph.replay), "bound_ms": bound_ms}
        offline_rows[label] = row
        print(f"[offline] artifact {label} "
              + " ".join(f"{kk}={vv}" for kk, vv in row.items()), flush=True)
        del graph
        return x

    def grads_case(label, A, art, n, multi):
        """Grads of ``sum(G ∘ execute(art, x, vals))`` in both against the
        builder's; no host build in the forward and backward."""
        x = randn(A.shape[1], n)
        gy = randn(A.shape[0], n)

        def grads(target):
            v = A.values.detach().clone().requires_grad_()
            xx = x.clone().requires_grad_()
            y = repro_torch.execute(target, xx, vals=v)
            return torch.autograd.grad((y * gy).sum(), [v, xx])
        want = grads(A.plan)
        before = host_builds()
        got, counts = drive(lambda: guarded(lambda: grads(art)), "offline")
        if host_builds() != before:
            fail(f"offline {label}: the backward through the artifact built "
                 "on the host")
        rel = [errors(g, w)[0] for g, w in zip(got, want)]
        row = {"rel_dvals": rel[0], "rel_dx": rel[1],
               "launches": {k: v for k, v in counts.items() if v}}
        print(f"[offline] grads {label} " + json.dumps(row), flush=True)
        if max(rel) > 1e-4 or counts["sddmm"] != 1:
            fail(f"offline {label}: grads {row}")
        offline_rows[f"{label} grads"] = row

    def nb_bound(csr, n):
        return bound(12 * csr.nnz + 4 * csr.shape[1] * n + 4 * csr.shape[0] * n,
                     2 * csr.nnz * n)[0]

    def pick_case(csr, tile, pick, n):
        """The rows an NB pick sums by atomics, and the pick's bound (§2:
        12 B a nonzero for K1/K2, 8 B + 4 B a row for K3)."""
        if pick.startswith("nb_"):
            return multi_rows(csr, tile), nb_bound(csr, n)
        return (torch.zeros(csr.shape[0], dtype=torch.bool, device=dev),
                bound(8 * csr.nnz + 4 * csr.shape[0] + 4 * csr.shape[1] * n
                      + 4 * csr.shape[0] * n, 2 * csr.nnz * n)[0])

    for name, n in ARTIFACT_CASES:
        csr = graphs[name]
        A = repro_torch.sparse(csr)
        t0 = time.perf_counter()
        art = A.finalize(n)
        fin_s = time.perf_counter() - t0
        pick = art.select(n)
        multi, b = pick_case(csr, A.plan.tile, pick, n)
        print(f"[offline] finalize {name} N={n}: {pick}, {fin_s:.2f} s, "
              f"substrates {sorted(art.substrates)}", flush=True)
        artifact_case(f"{name} N={n}", A, art, n, None, kernel_of(pick, n),
                      multi, b)
        if (name, n) == ("g500", 32):
            grads_case(f"{name} N={n}", A, art, n, multi)
        del art
    U = repro_torch.sparse(graphs["unif"])
    t0 = time.perf_counter()
    full = U.finalize()
    print(f"[offline] finalize unif (full coverage): {time.perf_counter() - t0:.2f} s, "
          f"substrates {sorted(full.substrates)}", flush=True)
    for impl in ("rs_sr", "rs_pr", "nb_sr", "nb_pr"):
        artifact_case(f"unif full {impl} N={FULL_N}", U, full, FULL_N, impl,
                      kernel_of(impl, FULL_N),
                      *pick_case(graphs["unif"], U.plan.tile, impl, FULL_N))
    del full
    W = repro_torch.sparse(w_csr, backend="bsr")
    t0 = time.perf_counter()
    w_art = W.finalize(BSR_ARTIFACT_N)
    print(f"[offline] finalize gemma ffn_up bsr N={BSR_ARTIFACT_N}: "
          f"{time.perf_counter() - t0:.2f} s, substrates {sorted(w_art.substrates)}",
          flush=True)
    nbw = w_bsr.nblocks * BSR_BLOCK[0] * BSR_BLOCK[1]
    d_ff, d_model = w_csr.shape
    no_multi = torch.zeros(d_ff, dtype=torch.bool, device=dev)
    artifact_case(f"gemma ffn_up bsr N={BSR_ARTIFACT_N}", W, w_art,
                  BSR_ARTIFACT_N, None, "bsr_spmm", no_multi,
                  bound(4 * nbw + 4 * w_bsr.nblocks
                        + 4 * (d_ff + d_model) * BSR_ARTIFACT_N,
                        2 * nbw * BSR_ARTIFACT_N)[0])
    grads_case(f"gemma ffn_up bsr N={BSR_ARTIFACT_N}", W, w_art,
               BSR_ARTIFACT_N, no_multi)
    del w_art
    torch.cuda.empty_cache()

    # (c) the quickstart example on the card
    qs, qs_counts = drive(quickstart.main, "offline")
    if not (qs["agree_n1"] and qs["agree_n4"] and qs["agree_n64"]) or \
            max(qs[k] for k in ("hopper_nb_pr", "hopper_rs_sr", "hopper_spmv",
                                 "artifact", "graph")) > 1e-3:
        fail(f"offline: quickstart {qs}")
    print("[offline] quickstart " + json.dumps(qs), flush=True)

    # -- 14. tune: the nnz quota and the fuse gates, measured -----------------
    phase("tune")
    from repro_torch.core.selector import geometry_key
    from repro_torch.kernels import tune
    timers = []

    def timed(label, call, timer):
        """``call()`` on the tune path, its timer's new entries printed."""
        start = len(timer.log)
        out, _ = drive(call, "tune")
        for e in timer.log[start:]:
            print(f"[tune] {label} {e['key']} ms={1e3 * e['seconds']:.4f} "
                  f"mode={e['mode']}"
                  + (f" reason={e['reason']}" if e["reason"] else ""),
                  flush=True)
        return out, timer.log[start:]

    def ms(entry):
        return round(1e3 * entry["seconds"], 4)

    # (a) the nnz quota: HOPPER_CANDIDATES at each N on the pick's NB kernel
    # (nb_sr forced where the pick is K3), two sweeps
    t0 = time.perf_counter()
    sweeps = []
    geometry_rows = {}
    for sweep in range(2):
        timer = tune.Timer()
        timers.append(timer)
        th = default_th
        for name, csr in graphs.items():
            for n in NS:
                pick = PICKS[name][n]
                impl = pick if pick.startswith("nb_") else "nb" + pick[2:]
                th, entries = timed(
                    f"geometry sweep {sweep + 1} {name}", lambda: (
                        tune.autotune_geometry(
                            csr, ns=(n,), impl=impl, thresholds=th,
                            repeats=TUNE_REPEATS, include_wildcard=False,
                            timer=timer)), timer)
                row = geometry_rows.setdefault((name, n), {
                    "pick": pick, "impl": impl, "forced": impl != pick,
                    "ms": []})
                row["ms"].append({g.tile: ms(e) for g, e in
                                  zip(tune.HOPPER_CANDIDATES, entries)})
        sweeps.append(th)
    sweeps_agree = sweeps[0].geometries == sweeps[1].geometries
    tuned = sweeps[0]
    for (name, n), row in geometry_rows.items():
        csr = graphs[name]
        key = geometry_key("hopper", pattern_fingerprint(csr), n)
        tiles = [dict(s.geometries)[key][0] for s in sweeps]
        x = randn(csr.shape[1], n) if n > 1 else randn(csr.shape[1])
        A_t = repro_torch.sparse(csr, thresholds=tuned, n_hint=n, cache=False)
        A_d = repro_torch.sparse(csr, n_hint=n, cache=False)
        if A_t.plan.tile != tiles[0] or A_d.plan.tile != 512:
            fail(f"tune {name} N={n}: the tuned plan's tile {A_t.plan.tile} "
                 f"(winner {tiles[0]}), the default's {A_d.plan.tile}")
        y, counts = drive(lambda: A_t.matmul(x, impl=row["impl"]), "tune")
        rel, _ = errors(y, A_t.matmul(x, impl=row["impl"], backend="torch"))
        if rel > RTOL["float32"] or counts[kernel_of(row["impl"], n)] != 1:
            fail(f"tune {name} N={n}: tuned plan rel err {rel}, {counts}")
        call_timer = tune.Timer()
        timers.append(call_timer)
        (t_tuned, t_default), _ = drive(lambda: (
            call_timer(lambda: A_t.matmul(x, impl=row["impl"]), dev,
                       TUNE_REPEATS, f"call tuned {name} N={n}"),
            call_timer(lambda: A_d.matmul(x, impl=row["impl"]), dev,
                       TUNE_REPEATS, f"call tile=512 {name} N={n}")), "tune")
        row.update({"winners": tiles, "rel_err_plain": rel,
                    "tuned_ms": round(1e3 * t_tuned, 4),
                    "default_ms": round(1e3 * t_default, 4),
                    "modes": sorted({e["mode"] for e in call_timer.log})})
        print(f"[tune] geometry {name} N={n} " + json.dumps(row), flush=True)
        del A_t, A_d, x, y
    print(f"[tune] geometry sweeps agree: {sweeps_agree} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.empty_cache()

    # (b) the quant crossover on g500: each mode, each N, the pick's design
    t0 = time.perf_counter()
    quant_rows = {}
    for mode in QUANT_MODES:
        timer = tune.Timer()
        timers.append(timer)
        wins = []
        for n in NS:
            pick = PICKS["g500"][n]
            th_q, entries = timed(f"quant {mode}", lambda: tune.autotune_quant(
                graphs["g500"], ns=(n,), quant=mode, impl=pick,
                repeats=TUNE_REPEATS, timer=timer), timer)
            quant_rows[(mode, n)] = {"coded_ms": ms(entries[0]),
                                     "f32_ms": ms(entries[1])}
            if th_q.quant_min_n == n:
                wins.append(n)
        quant_rows[mode] = min(wins) if wins else tune.QUANT_NEVER
        print(f"[tune] quant {mode} quant_min_n={quant_rows[mode]} "
              + json.dumps({n: quant_rows[(mode, n)] for n in NS}), flush=True)
    print(f"[tune] quant ({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.empty_cache()

    # (c) the chain gate on g500 at the GAT width; identity and scale retimed
    t0 = time.perf_counter()
    timer = tune.Timer()
    timers.append(timer)
    th_chain, _ = timed("chain", lambda: tune.autotune_chain(
        graphs["g500"], ns=TUNE_CHAIN_NS, d=TUNE_CHAIN_D, transform="softmax",
        repeats=TUNE_REPEATS, timer=timer), timer)
    chain_rows = {}
    for transform in ("identity", "scale"):
        for n in TUNE_CHAIN_NS:
            (f_s, u_s), _ = timed(f"chain {transform}", lambda: tuple(
                tune.measure_chain(graphs["g500"], n, TUNE_CHAIN_D,
                                   fused=fused, transform=transform,
                                   repeats=TUNE_REPEATS, timer=timer)
                for fused in (True, False)), timer)
            chain_rows[(transform, n)] = {"fused_ms": round(1e3 * f_s, 4),
                                          "unfused_ms": round(1e3 * u_s, 4)}
    print(f"[tune] chain softmax chain_fuse_min_n={th_chain.chain_fuse_min_n}; "
          + json.dumps({f"{t} N={n}": r for (t, n), r in chain_rows.items()})
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.empty_cache()

    # (d) the attention gate over Gemma's local band, one head of 256, with
    # the ALiBi bias (K9 + K10) and without (K7 + K8); both arms at every seq
    t0 = time.perf_counter()
    timer = tune.Timer()
    timers.append(timer)
    specs = [transformer._block_sparse_spec(gemma, s, True)
             for s in TUNE_ATTN_SEQS]
    attn_gates = {}
    for bias in (True, False):
        th_a, _ = timed(f"attention bias={bias}", lambda: (
            tune.autotune_attention(specs, d=TUNE_ATTN_D, repeats=TUNE_REPEATS,
                                    bias=bias, timer=timer)), timer)
        attn_gates[bias] = th_a.attn_fuse_min_seq
        timed_seqs = {int(e["key"].split("seq=")[1].split("|")[0])
                      for e in timer.log
                      if ("|bias|" if bias else "|nobias|") in e["key"]}
        for spec in specs:
            if spec.seq in timed_seqs:
                continue
            mask = patterns.build_mask(spec)
            timed(f"attention bias={bias}", lambda: [
                tune.measure_attention(mask, TUNE_ATTN_D, fused=fused,
                                       bias=bias, repeats=TUNE_REPEATS,
                                       timer=timer)
                for fused in (True, False)], timer)
    print(f"[tune] attention attn_fuse_min_seq with bias "
          f"{attn_gates[True]}, without {attn_gates[False]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.empty_cache()

    # (e) calibrate_backend with both tuners on three matrices of the suite,
    # saved with the gates and reloaded through $REPRO_THRESHOLDS
    t0 = time.perf_counter()
    skews = {"uniform": (0.25, 0.25, 0.25), "mild": (0.45, 0.22, 0.22),
             "skewed": (0.57, 0.19, 0.19)}
    # rmat_suite's seeds count up over scale x edge factor x skew from the
    # base: scale 14 at edge factor 16 takes the seeds 21, 22 and 23
    suite3 = {f"rmat_s14_e16_{sk}": rmat(14, 16, *abc, seed=args.seed + 21 + i,
                                         device=dev)
              for i, (sk, abc) in enumerate(skews.items())}
    (cal_th, cal_report), _ = drive(lambda: repro_torch.calibrate_backend(
        matrices=suite3, tune_geometry=True, tune_quant=True,
        backend="hopper", repeats=TUNE_REPEATS), "tune")
    modes = {}
    for mode in cal_report["timing"].values():
        modes[mode] = modes.get(mode, 0) + 1
    print("[tune] calibrate_backend " + json.dumps({
        "thresholds": [cal_th.n_threshold, cal_th.pr_avg_row, cal_th.sr_cv],
        "loss": cal_report["geomean_slowdown_vs_oracle"],
        "geometries": cal_report["geometries"],
        "quant_min_n": cal_report["quant_min_n"], "modes": modes,
        "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    saved = dataclasses.replace(cal_th,
                                chain_fuse_min_n=th_chain.chain_fuse_min_n,
                                attn_fuse_min_seq=attn_gates[True])
    heavy = max(suite3, key=lambda k: suite3[k].nnz)
    gate_shut = {}

    def demotions(counter):
        return HEALTH.snapshot()["counters"].get(counter, 0)

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "tuned.json")
        repro_torch.api.save_thresholds(saved, path)
        save_to_env = os.environ.get(THRESHOLDS_ENV)
        os.environ[THRESHOLDS_ENV] = path
        try:
            if default_thresholds() != saved:
                fail(f"tune: $REPRO_THRESHOLDS reloaded {default_thresholds()}")
            table = dict(saved.geometries)
            for mname, c in suite3.items():
                A = repro_torch.sparse(c, n_hint=8, cache=False)
                want = table[geometry_key("hopper", pattern_fingerprint(c), 8)]
                if A.plan.tile != want[0] or A.plan.thresholds != saved:
                    fail(f"tune: sparse({mname}) tile {A.plan.tile}, saved "
                         f"{want}")
            for n in NS:
                Q = repro_torch.sparse(suite3[heavy], quant="int8", n_hint=n,
                                       cache=False)
                if (Q.plan.quant == "int8") != (n >= saved.quant_min_n):
                    fail(f"tune: quant gate at N={n}: {Q.plan.quant}, "
                         f"quant_min_n {saved.quant_min_n}")
            c = suite3[heavy]
            a_c, b_c = randn(c.shape[0], 16), randn(c.shape[1], 16)
            for n in (1, 128):
                x = randn(c.shape[1], n)
                before = demotions("demote:chain_fuse")
                drive(lambda: repro_torch.sparse_chain(c, a_c, b_c, x,
                                                       cache=False), "tune")
                shut = demotions("demote:chain_fuse") > before
                gate_shut[f"chain N={n}"] = shut
                if shut != (n < saved.chain_fuse_min_n):
                    fail(f"tune: chain gate at N={n} shut={shut}, "
                         f"chain_fuse_min_n {saved.chain_fuse_min_n}")
            for spec in (specs[0], specs[-1]):
                q = randn(spec.seq, TUNE_ATTN_D)
                bias_s = tune._alibi(patterns.build_mask(spec).csr.to(dev))
                before = demotions("demote:attn_fuse")
                drive(lambda: repro_torch.sparse_attention(
                    spec, q, q, q, bias=bias_s, cache=False), "tune")
                shut = demotions("demote:attn_fuse") > before
                gate_shut[f"attention seq={spec.seq}"] = shut
                if shut != (spec.seq < saved.attn_fuse_min_seq):
                    fail(f"tune: attention gate at seq {spec.seq} shut={shut}, "
                         f"attn_fuse_min_seq {saved.attn_fuse_min_seq}")
        finally:
            if save_to_env is None:
                os.environ.pop(THRESHOLDS_ENV)
            else:
                os.environ[THRESHOLDS_ENV] = save_to_env
    print("[tune] reloaded: tiles and gates resolved from $REPRO_THRESHOLDS "
          + json.dumps({"quant_min_n": saved.quant_min_n,
                        "chain_fuse_min_n": saved.chain_fuse_min_n,
                        "attn_fuse_min_seq": saved.attn_fuse_min_seq,
                        "shut": gate_shut}), flush=True)
    del suite3
    entries = [e for t in timers for e in t.log]
    uncaptured = {e["key"]: e["reason"] for e in entries if e["mode"] != "graph"}
    print(f"[tune] timing: {len(entries)} entries, "
          f"{len(entries) - len(uncaptured)} from CUDA graphs; "
          f"calibrate_backend {modes}; not captured: {json.dumps(uncaptured)}",
          flush=True)
    torch.cuda.empty_cache()

    # -- 15. the guardrails on the card's kernels --------------------------------
    phase("guardrails")
    from repro_torch.core import guardrails
    from repro_torch.core.cache import PlanCache
    from repro_torch.core.plan import (_artifact_entry, _artifact_run,
                                       _check_call)
    from repro_torch.runtime.faults import FaultInjector, FaultSpec, inject_faults
    g500 = graphs["g500"]
    m_g, k_g = g500.shape
    A = repro_torch.sparse(g500)
    x1, x128 = randn(k_g), randn(k_g, 128)
    W = repro_torch.sparse(w_csr, backend="bsr")
    xw = randn(w_csr.shape[1], BSR_ARTIFACT_N)

    def say(label, row):
        print(f"[guardrails] {label} " + json.dumps(row, default=str), flush=True)

    def attempt(call):
        """``call()`` through ``drive``: ``(error, y, launch counts)``, the
        error the text of a ``RuntimeError`` it raised (then y is None)."""
        try:
            y_, counts_ = drive(call, "guardrails")
            return None, y_, counts_
        except RuntimeError as err:
            return str(err), None, launch_counts()

    def ladder_moves():
        return {k: v for k, v in HEALTH.snapshot()["counters"].items()
                if k.startswith(("kernel_failure:", "kernel_reroute:",
                                 "breaker_skip:"))}

    # (a) the fault matrix: threshold 2, cooldown 0, three failures; on the
    # card each raises (there is no rung below), and the probe launches
    for label, M_, x_, backend, kernel in (
            ("g500 K2 N=1", A, x1, "hopper", "vsr_spmv"),
            ("g500 K1 sr N=128", A, x128, "hopper", "vsr_spmm"),
            (f"gemma ffn_up bsr K11 N={BSR_ARTIFACT_N}", W, xw, "bsr",
             "bsr_spmm")):
        HEALTH.reset()
        HEALTH.configure(threshold=2, cooldown_s=0.0)
        name = M_.plan.select(1 if x_.ndim == 1 else x_.shape[1])
        t0 = time.perf_counter()
        want = M_.matmul(x_, backend="torch")
        fi = FaultInjector({f"kernel_execute:{backend}": FaultSpec(fail=3)})
        raised, fm_launches = [], []
        with inject_faults(fi):
            for i in range(4):
                err, y, counts = attempt(lambda: M_ @ x_)
                fm_launches.append(counts[kernel])
                raised.append(err is not None and "injected fault" in err)
        probe_rel = errors(y, want)[0] if y is not None else float("inf")
        breaker = HEALTH.snapshot()["breakers"].get(f"{backend}:{name}")
        row = {"pick": name, "raised": raised, "probe_rel_err": probe_rel,
               "launches": fm_launches, "counters": ladder_moves(),
               "breaker": breaker, "seconds": time.perf_counter() - t0,
               "kernel_ms": time_ms(lambda: M_ @ x_)}
        say(f"fault_matrix {label}", row)
        if raised != [True, True, True, False] or \
                probe_rel > RTOL["float32"] or \
                fm_launches != [0, 0, 0, 1] or \
                row["counters"] != {f"kernel_failure:{backend}:{name}": 3} \
                or breaker != {"state": "closed", "failures": 0, "trips": 2,
                               "recoveries": 1}:
            fail(f"guardrails: fault matrix {label}: {row}")
    del want, y

    # (b) the "fault_launch" build: a real launch error, raised and counted,
    # then the default build's half-open probe
    fault_thread.join()
    if "result" not in fault_build:
        fail("guardrails: the fault_launch variant did not build")
    print(f"[guardrails] fault_launch build: {fault_build['result'].seconds:.1f} s "
          "(beside the other phases)", flush=True)
    HEALTH.reset()
    HEALTH.configure(threshold=1, cooldown_s=0.0)
    U = repro_torch.sparse(graphs["unif"])
    xu = randn(graphs["unif"].shape[1], 128)
    launch_cases = (("g500 K2 N=1", A, x1, "vsr_spmv"),
                    ("g500 K1 sr N=128", A, x128, "vsr_spmm"),
                    ("unif K3 sr N=128", U, xu, "csc_spmm"))
    errs = {}
    with _build.variant("fault_launch"):
        for label, M_, x_, kernel in launch_cases:
            err, y, counts = attempt(lambda: M_ @ x_)
            if err is None or counts[kernel]:
                fail(f"guardrails: the fault_launch build launched {label}")
            errs[label] = err
    torch.cuda.synchronize()                  # a launch error is not sticky
    recovered = {}
    for label, M_, x_, kernel in launch_cases:
        y, counts = drive(lambda: M_ @ x_, "guardrails")
        recovered[label] = {"launches": counts[kernel],
                            "rel_err": errors(y, M_.matmul(x_, backend="torch"))[0]}
    snap = HEALTH.snapshot()
    row = {"errors": errs, "counters": ladder_moves(),
           "breakers": {k: b for k, b in snap["breakers"].items()
                        if k.startswith("hopper:")}, "probe": recovered}
    say("fault_launch", row)
    if any("cudaError_t 9" not in e for e in errs.values()) or \
            len(row["counters"]) != 3 or \
            any(v != 1 for v in row["counters"].values()) or \
            any(r["launches"] != 1 or r["rel_err"] > RTOL["float32"]
                for r in recovered.values()) or \
            any(b != {"state": "closed", "failures": 0, "trips": 1,
                      "recoveries": 1} for k, b in snap["breakers"].items()
                if k.startswith("hopper:")):
        fail(f"guardrails: fault_launch {row}")

    # (c) sentinels on K1 sr at N = 128: a NaN in X
    HEALTH.reset()
    HEALTH.configure()
    art = A.finalize(128)
    name = art.select(128)
    xn = x128.clone()
    xn[int(g500.indices[0])] = float("nan")
    y = repro_torch.execute(art, xn)
    try:
        repro_torch.execute(art, xn, sentinel="raise")
        fail("guardrails: sentinel='raise' did not raise on a NaN output")
    except guardrails.NumericFault:
        pass
    ys, _ = drive(lambda: repro_torch.execute(art, xn, sentinel="sanitize"),
                  "guardrails")
    zero = torch.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0)
    # on the card there is no rung below: "fallback" is the sanitize pass
    fb, fb_counts = drive(lambda: repro_torch.execute(art, xn,
                                                      sentinel="fallback"),
                          "guardrails")
    fb_launched = fb_counts["vsr_spmm"] == 1
    # under capture (no eager warm-up: the kernels ran above): "sanitize"
    # and "fallback" the same pass in the graph, "raise" refused, no counter
    graph, graph_fb = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg = repro_torch.execute(art, xn, sentinel="sanitize")
    with torch.cuda.graph(graph_fb):
        ygf = repro_torch.execute(art, xn, sentinel="fallback")
    graph.replay()
    graph_fb.replay()
    torch.cuda.synchronize()
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            repro_torch.execute(art, x128, sentinel="raise")
        refused = False
    except ValueError:
        refused = True
    counters = HEALTH.snapshot()["counters"]
    row = {"pick": name, "nonfinite_rows": int((~torch.isfinite(y)).any(1).sum()),
           "sanitize_finite": bool(torch.isfinite(ys).all()),
           "sanitize_rel_err": errors(ys, zero)[0],
           "fallback_finite": bool(torch.isfinite(fb).all()),
           "fallback_rel_err": errors(fb, zero)[0],
           "fallback_launched_kernel": fb_launched,
           "graph_sanitize_finite": bool(torch.isfinite(yg).all()),
           "graph_fallback_rel_err": errors(ygf, zero)[0],
           "graph_raise_refused": refused, "counters": counters}
    if not (row["sanitize_finite"] and row["sanitize_rel_err"] <= 1e-6
            and row["fallback_finite"] and row["fallback_rel_err"] <= 1e-6
            and fb_launched and row["graph_sanitize_finite"]
            and row["graph_fallback_rel_err"] <= 1e-6 and refused
            and counters == {f"sentinel:execute:{name}": 3}):
        fail(f"guardrails: sentinels {row}")
    del graph, graph_fb, yg, ygf, ys, fb, zero, y, xn
    # their cost on a finite X (CUDA events, median of 20), eager and replayed
    for policy in (None, "sanitize", "raise", None, "sanitize", "raise"):
        key = f"{policy or 'off'}_ms"
        row.setdefault(key, []).append(time_ms(
            lambda: repro_torch.execute(art, x128, sentinel=policy)))
    for policy in ("off", "sanitize"):
        graph, _ = capture(lambda: repro_torch.execute(art, x128,
                                                       sentinel=policy))
        row[f"graph_{policy}_ms"] = time_ms(graph.replay)
        del graph
    say(f"sentinels g500 K1 sr N=128 ({name})", row)
    guard_rows = {"sentinels": row}

    # (d) the guard's cost: the eager artifact call with and without it
    def unguarded(art_, x_):
        """``execute(art_, x_)`` less the guardrails: the same checks,
        selection and dispatch."""
        n_ = _check_call(art_.meta.shape, art_.meta.nnz, art_.aux.get("vals"),
                         x_, None, None)
        entry, sub = _artifact_entry(art_, art_.select(n_), art_.meta.backend)
        return _artifact_run(art_, entry, sub, x_, None, None)

    def host_us(fn, reps=2000):
        """Host µs a call, back to back: the card's work on the small matrix
        is shorter than the host's dispatch, so the loop waits on the host."""
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / reps

    art1 = A.finalize(1)
    small = rmat(12, 8, seed=args.seed, device=dev)
    art_s = repro_torch.sparse(small, cache=False).finalize(1)
    xs = randn(small.shape[1])
    cost = {"g500 K2 N=1": {}, "g500 K1 sr N=128": {}, "small K2 N=1 host": {}}
    for _ in range(2):
        for label, art_, x_ in (("g500 K2 N=1", art1, x1),
                                ("g500 K1 sr N=128", art, x128)):
            cost[label].setdefault("guarded_ms", []).append(
                time_ms(lambda: repro_torch.execute(art_, x_)))
            cost[label].setdefault("unguarded_ms", []).append(
                time_ms(lambda: unguarded(art_, x_)))
        for _ in range(3):
            cost["small K2 N=1 host"].setdefault("guarded_us", []).append(
                host_us(lambda: repro_torch.execute(art_s, xs)))
            cost["small K2 N=1 host"].setdefault("unguarded_us", []).append(
                host_us(lambda: unguarded(art_s, xs)))
    t0 = time.perf_counter()
    for _ in range(100000):
        guardrails.guarded_call("nb_pr", "hopper", int, on_card=True)
    cost["guarded_call_alone_us"] = 10 * (time.perf_counter() - t0)
    say("guard_cost", cost)
    guard_rows["guard_cost"] = cost
    del art, art1, art_s, small

    # (e) pattern validation on g500, the repaired dirty copy through the
    # cache, and the digests
    t0 = time.perf_counter()
    report = guardrails.inspect_csr(g500)
    inspect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fixed = guardrails.repair_csr(g500)
    repair_s = time.perf_counter() - t0
    same = all(torch.equal(getattr(fixed, f), getattr(g500, f))
               for f in ("indptr", "indices", "data"))
    if not report.ok or not same:
        fail(f"guardrails: g500 inspected as {report.issues}, or its repair "
             "changed it")
    del fixed
    ip, idx, dat = (formats.host(t) for t in (g500.indptr, g500.indices,
                                              g500.data))
    rng = np.random.default_rng(args.seed)
    rows_np = formats.row_ids_from_indptr(ip, len(idx))
    dup = rng.random(len(idx)) < 0.01        # 1% split into two halves
    dat2 = dat.copy()
    dat2[dup] *= 0.5
    r_all = np.concatenate([rows_np, rows_np[dup]])
    order = np.lexsort((rng.random(len(r_all)), r_all))   # shuffled in rows
    ip2 = np.concatenate([[0], np.cumsum(np.bincount(r_all, minlength=m_g))])
    dirty = interop.csr_from_arrays(
        ip2, np.concatenate([idx, idx[dup]])[order],
        np.concatenate([dat2, dat2[dup]])[order], g500.shape, device=dev)
    del rows_np, dup, dat2, r_all, order, ip2
    dirty_issues = guardrails.inspect_csr(dirty).issues
    vcache = PlanCache(8)
    A0 = repro_torch.sparse(g500, cache=vcache)
    y0 = A0 @ x128
    t0 = time.perf_counter()
    Ad = repro_torch.sparse(dirty, validate="repair", cache=vcache)
    sparse_repair_s = time.perf_counter() - t0
    yd = Ad @ x128
    bit, ok, diff = agree(yd, y0, multi_rows(g500, A0.plan.tile))
    vrow = {"dirty_issues": dirty_issues, "dirty_nnz": dirty.nnz,
            "inspect_s": inspect_s, "repair_s": repair_s,
            "sparse_validate_repair_s": sparse_repair_s,
            "cache": vcache.stats(), "same_plan": Ad.plan is A0.plan,
            "output_bit_equal": bit, "max_abs_diff": diff}
    if set(dirty_issues) != {"unsorted", "duplicates"} or not ok or \
            Ad.plan is not A0.plan or vcache.stats()["hits"] != 1 or \
            vcache.stats()["builds"] != 1:
        fail(f"guardrails: validate='repair' {vrow}")
    del dirty, Ad, yd, y0, A0, vcache
    # a corrupted cached plan under integrity="hit" is rebuilt
    hcache = PlanCache(4, integrity="hit")
    Ah = repro_torch.sparse(g500, cache=hcache)
    key = next(iter(hcache._entries))
    corrupt = repro_torch.sparse(graphs["unif"], cache=False).plan
    with hcache._lock:
        hcache._entries[key] = (corrupt, hcache._entries[key][1])
    t0 = time.perf_counter()
    Ah2 = repro_torch.sparse(g500, cache=hcache)
    hit_s = time.perf_counter() - t0
    rel_h = errors(Ah2 @ x1, A @ x1)[0]
    vrow["integrity_hit"] = {"cache": hcache.stats(), "rebuild_s": hit_s,
                             "rel_err": rel_h}
    if hcache.stats()["digest_mismatches"] != 1 or Ah2.plan is corrupt or \
            hcache.stats()["builds"] != 2 or rel_h > RTOL["float32"]:
        fail(f"guardrails: integrity='hit' {vrow['integrity_hit']}")
    del Ah, Ah2, corrupt, hcache
    art = A.finalize(128)
    for label, value in (("builder", A.plan), ("artifact N=128", art)):
        t0 = time.perf_counter()
        guardrails.plan_digest(value)
        vrow[f"digest_{label}_s"] = time.perf_counter() - t0
    # a sparse() cache miss with and without the published digest (the
    # facade's default cache publishes none)
    for _ in range(2):
        for integrity in ("off", "publish"):
            t0 = time.perf_counter()
            repro_torch.sparse(g500, cache=PlanCache(2, integrity=integrity))
            vrow.setdefault(f"sparse_miss_{integrity}_s", []).append(
                time.perf_counter() - t0)
    vrow["default_cache_integrity"] = repro_torch.api.DEFAULT_CACHE.integrity
    say("validate_and_digest g500", vrow)
    guard_rows["validate"] = vrow
    del art
    torch.cuda.empty_cache()

    # (f) the FFN train step with skip_nonfinite off and on, and one
    # poisoned step kept
    skip_row = {}
    for skip in (False, True):
        tc = TrainConfig(opt=OptConfig(**TRAIN_OPT), skip_nonfinite=skip)
        step = make_train_step(ffn_loss, tc)
        st = init_state(ffn.params(), tc)
        step_s = []
        for _ in range(4):
            t0 = time.perf_counter()
            st, metrics = step(st, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        skip_row[f"skip_{'on' if skip else 'off'}_step_ms"] = \
            1e3 * statistics.median(step_s[1:])
    bad_batch = {"x": batch["x"].clone(), "y": batch["y"]}
    bad_batch["x"][0, 0, 0] = float("nan")
    st2, m2 = step(st, bad_batch)
    kept = all(torch.equal(st2["params"][k], st["params"][k]) for k in st["params"]) \
        and all(torch.equal(st2["opt"][s_][k], st["opt"][s_][k])
                for s_ in ("m", "v") for k in st["params"]) \
        and torch.equal(st2["opt"]["step"], st["opt"]["step"])
    skip_row.update(poisoned_skipped=int(m2["skipped_nonfinite"]),
                    poisoned_state_kept=kept,
                    finite_skipped=int(metrics["skipped_nonfinite"]))
    say("skip_nonfinite ffn step", skip_row)
    if skip_row["poisoned_skipped"] != 1 or not kept or \
            skip_row["finite_skipped"] != 0:
        fail(f"guardrails: skip_nonfinite {skip_row}")
    guard_rows["skip_nonfinite"] = skip_row
    del st, st2, bad_batch, ffn
    HEALTH.reset()
    HEALTH.configure()
    torch.cuda.empty_cache()

    # -- 16. the models: OLMoE-1B-7B prefill and decode at full width -----------
    phase("models")
    t_models = time.perf_counter()
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.models import Model, moe
    from repro_torch.models import params as model_params
    torch.backends.cuda.matmul.allow_tf32 = False

    def tree_leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from tree_leaves(tree[k])
        else:
            yield tree

    def say_m(label, row):
        print(f"[models] {label} " + json.dumps(row, default=str)
              + f" ({card})", flush=True)

    def paths_moved(before):
        return {k: v - before[k] for k, v in moe.DISPATCH_PATHS.items()
                if v != before[k]}

    mcfg = olmoe_1b_7b.CONFIG
    n_moe = mcfg.num_layers
    model = Model(mcfg)
    t0 = time.perf_counter()
    mp = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p_bytes = model_params.param_bytes(model.specs)
    held = sum(t.numel() * t.element_size() for t in tree_leaves(mp))
    if held != p_bytes or any(t.device != dev for t in tree_leaves(mp)):
        fail(f"models: the parameters hold {held} bytes, the specs say {p_bytes}")
    say_m("params", {"config": mcfg.name, "layers": n_moe,
                     "d_model": mcfg.d_model, "heads": mcfg.num_heads,
                     "experts": mcfg.moe.num_experts, "top_k": mcfg.moe.top_k,
                     "d_ff_expert": mcfg.moe.d_ff_expert,
                     "vocab": mcfg.vocab_size, "dtype": mcfg.param_dtype,
                     "param_count": model_params.param_count(model.specs),
                     "param_bytes": p_bytes, "init_on_card_s": init_s})

    # (prefill) MODEL_BATCH x MODEL_SEQ tokens: "sort" → moe_spmm, K1 sr for
    # each MoE layer's dispatch and combine
    n_tok = MODEL_BATCH * MODEL_SEQ
    max_len = MODEL_SEQ + MODEL_DECODE + MODEL_DECODE_SPMM
    toks = torch.randint(0, mcfg.vocab_size, (MODEL_BATCH, max_len),
                         device=dev, generator=gen)
    if moe.select_dispatch(n_tok, mcfg.moe) != "sort" or \
            moe.capacity(n_tok, mcfg.moe) != 320:
        fail("models: the prefill's dispatch is not 'sort' at capacity 320")
    models_row = {}
    with torch.no_grad():
        before = dict(moe.DISPATCH_PATHS)
        t0 = time.perf_counter()
        (logits, caches), counts = drive(lambda: model.prefill(
            mp, {"tokens": toks[:, :MODEL_SEQ]}, max_len), "models")
        first_s = time.perf_counter() - t0
        k1 = took()["vsr_spmm"]
        others = {k: v for k, v in counts.items() if v and k != "vsr_spmm"}
        row = {"k1_launches": counts["vsr_spmm"], "k1_designs": k1,
               "dispatch_paths": paths_moved(before), "other_kernels": others,
               "first_call_s": first_s}
        if counts["vsr_spmm"] != 2 * n_moe or k1["sr"] != 2 * n_moe or \
                others or row["dispatch_paths"] != {"spmm": n_moe}:
            fail(f"models: prefill launched {row}; expected {2 * n_moe} K1 sr "
                 "launches (vsr.DESIGN_LAUNCHES), two a MoE layer")
        if logits.shape != (MODEL_BATCH, mcfg.vocab_size) or \
                not torch.isfinite(logits).all():
            fail(f"models: prefill logits of shape {tuple(logits.shape)} are "
                 "not finite or of the wrong shape")
        pre_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            model.prefill(mp, {"tokens": toks[:, :MODEL_SEQ]}, max_len)
            torch.cuda.synchronize()
            pre_s.append(time.perf_counter() - t0)
        row["prefill_ms"] = 1e3 * statistics.median(pre_s)
        row["tokens_per_s"] = n_tok / statistics.median(pre_s)
        say_m(f"prefill B={MODEL_BATCH} S={MODEL_SEQ}", row)
        models_row["prefill"] = row

        # (decode) the selector's path at B = 4 (one-hot: no kernel), then
        # dispatch="spmm" forced (K1 sr twice a MoE layer, tile 32)
        spmm_model = Model(dataclasses.replace(
            mcfg, moe=dataclasses.replace(mcfg.moe, dispatch="spmm")))
        dec = {}
        pos = MODEL_SEQ
        for label, m_, steps, want_k1 in (
                ("onehot", model, MODEL_DECODE, 0),
                ("spmm", spmm_model, MODEL_DECODE_SPMM, 2 * n_moe)):
            step_s = []
            for _ in range(steps):
                tok = toks[:, pos:pos + 1]
                before = dict(moe.DISPATCH_PATHS)
                t0 = time.perf_counter()
                (ld, caches), counts = drive(
                    lambda: m_.decode_step(mp, caches, tok), "models")
                step_s.append(time.perf_counter() - t0)
                moved = paths_moved(before)
                k1 = took()["vsr_spmm"]
                if counts["vsr_spmm"] != want_k1 or k1["sr"] != want_k1 or \
                        sum(counts.values()) != want_k1 or \
                        moved != {label: n_moe} or not torch.isfinite(ld).all():
                    fail(f"models: decode step at {pos} on {label}: launches "
                         f"{counts}, K1 {k1}, paths {moved}")
                pos += 1
            dec[label] = {"steps": steps, "step_ms": 1e3 * statistics.median(
                step_s[1:]), "first_step_ms": 1e3 * step_s[0],
                "k1_launches_per_step": want_k1}
        if int(caches["length"]) != max_len:
            fail(f"models: cache length {int(caches['length'])} != {max_len}")
        # the two decode paths on one step: the same slotting, no drop at B=4;
        # their difference in bf16 over 16 layers is printed, not bounded
        tok = toks[:, -1:]
        l_one, _ = model.decode_step(mp, caches, tok)
        l_spmm, _ = spmm_model.decode_step(mp, caches, tok)
        dec["onehot_vs_spmm_rel_err"] = errors(l_spmm, l_one)[0]
        say_m(f"decode B={MODEL_BATCH} (onehot runs no kernel; spmm forced: "
              "K1 sr)", dec)
        if not (torch.isfinite(l_one).all() and torch.isfinite(l_spmm).all()):
            fail(f"models: decode logits are not finite {dec}")
        models_row["decode"] = dec
        del caches, logits, l_one, l_spmm

        # (a) one MoE layer at T = n_tok on "hopper" against "torch", f32 and
        # bf16 weights, the router's ids equal on both
        p0 = {k: v[0] for k, v in mp["blocks"]["ffn"].items() if k != "ln"}
        xa = randn(n_tok, mcfg.d_model)
        check_a = {}
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            pp = {k: v if k == "w_router" else v.to(dt) for k, v in p0.items()}
            xx = xa.to(dt)
            sinks = (moe.RoutingSink(), moe.RoutingSink())
            reset_launch_counts()
            with moe.record_routing(sinks[0], 0):
                y_h, aux_h = moe.moe_apply(pp, xx, mcfg.moe)
            torch.cuda.synchronize()
            n_k1 = launch_counts()["vsr_spmm"]
            reset_launch_counts()
            with repro_torch.use_backend("torch"), \
                    moe.record_routing(sinks[1], 0):
                y_t, aux_t = moe.moe_apply(pp, xx, mcfg.moe)
            torch.cuda.synchronize()
            ids = [s_.drain_routing(0)[0] for s_ in sinks]
            rel, diff = errors(y_h, y_t)
            check_a[dt_name] = {"rel_inf_err": rel, "max_abs_err": diff,
                                "aux_equal": float(aux_h) == float(aux_t),
                                "ids_equal": bool(np.array_equal(*ids)),
                                "k1_launches": n_k1,
                                "torch_launches": sum(launch_counts().values())}
            print(f"[check] models (a) moe_apply layer 0 T={n_tok} hopper vs "
                  f"torch {dt_name}: {json.dumps(check_a[dt_name])} "
                  f"tol={RTOL[dt_name]:g}", flush=True)
            if rel > RTOL[dt_name] or not check_a[dt_name]["ids_equal"] or \
                    n_k1 != 2 or check_a[dt_name]["torch_launches"]:
                fail(f"models (a): {dt_name} {check_a[dt_name]}")
            del pp, y_h, y_t
        models_row["check_a"] = check_a

        # K1 alone at the prefill's shapes: layer 0's dispatch and combine
        pb = {k: v for k, v in p0.items()}
        xk = xa.to(torch.bfloat16)
        cap, e_, k_ = 320, mcfg.moe.num_experts, mcfg.moe.top_k
        gate, idx, _ = moe.router(pb, xk, mcfg.moe)
        slot_u = moe._slots(idx.reshape(-1), e_, cap)
        tile = min(512, n_tok * k_)
        dr, dc = moe.dispatch_pattern(slot_u, k_, e_, cap, tile)
        dv = moe._as_tiles(torch.ones(n_tok * k_, device=dev), tile, 0.0)
        cr, cc = moe.combine_pattern(slot_u, n_tok, k_, tile)
        cv = moe._as_tiles(gate.reshape(-1).float(), tile, 0.0)
        bal_d = formats.BalancedCOO(dr, dc, dv, (e_ * cap, n_tok))
        bal_c = formats.BalancedCOO(cr, cc, cv, (n_tok, e_ * cap + 1))
        hp = randn(e_ * cap + 1, mcfg.d_model, dtype=torch.bfloat16)
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            hold("vsr_spmm", f"olmoe dispatch {e_ * cap}x{n_tok} N={mcfg.d_model} sr",
                 vsr.spmm_vsr_fused(bal_d, xk.to(dt), "sr"),
                 vsr.spmm_vsr_plain(bal_d, xk.to(dt)), dt_name)
            hold("vsr_spmm", f"olmoe combine {n_tok}x{e_ * cap + 1} N={mcfg.d_model} sr",
                 vsr.spmm_vsr_fused(bal_c, hp.to(dt), "sr"),
                 vsr.spmm_vsr_plain(bal_c, hp.to(dt)), dt_name)
        kept = int((dr < e_ * cap).sum())       # the dispatch's nonzeros
        used = int(torch.unique(cc.reshape(-1)[:n_tok * k_]).numel())
        d_bytes = 12 * dr.numel() + 2 * n_tok * mcfg.d_model \
            + 2 * e_ * cap * mcfg.d_model
        c_bytes = 12 * cr.numel() + 2 * used * mcfg.d_model \
            + 2 * n_tok * mcfg.d_model
        k1_bound = bound(d_bytes + c_bytes,
                         2 * (kept + n_tok * k_) * mcfg.d_model)

        def lib_csr(bal, m_):
            """The pattern as a bf16 CSR (its padding dropped) for
            ``torch.sparse.mm``."""
            keep = bal.rows.reshape(-1) < m_
            return torch.sparse_coo_tensor(
                torch.stack([bal.rows.reshape(-1)[keep].long(),
                             bal.cols.reshape(-1)[keep].long()]),
                bal.vals.reshape(-1)[keep].to(torch.bfloat16),
                bal.shape).coalesce().to_sparse_csr()
        try:
            lib_d = lib_csr(bal_d, e_ * cap)
            lib_c = lib_csr(bal_c, n_tok)
            library_ms = time_ms(lambda: (lib_d @ xk, lib_c @ hp))
        except RuntimeError as err:
            print(f"[models] torch.sparse.mm in bfloat16: {err}", flush=True)
            library_ms = None
        k1_row = {
            "shape": f"olmoe layer dispatch {e_ * cap}x{n_tok} + combine "
                     f"{n_tok}x{e_ * cap + 1}, N={mcfg.d_model} bf16, tile {tile}",
            "nnz": kept, "ms": time_ms(lambda: (
                vsr.spmm_vsr_fused(bal_d, xk, "sr"),
                vsr.spmm_vsr_fused(bal_c, hp, "sr"))),
            "dispatch_ms": time_ms(lambda: vsr.spmm_vsr_fused(bal_d, xk, "sr")),
            "combine_ms": time_ms(lambda: vsr.spmm_vsr_fused(bal_c, hp, "sr")),
            "plain_ms": time_ms(lambda: (vsr.spmm_vsr_plain(bal_d, xk),
                                         vsr.spmm_vsr_plain(bal_c, hp)), reps=5),
            "library_ms": library_ms, "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1]}
        k1_row["share_of_prefill"] = n_moe * k1_row["ms"] / models_row[
            "prefill"]["prefill_ms"]
        say_m("K1 one layer (CUDA events, median of 20)", k1_row)
        models_row["k1"] = k1_row
        del p0, pb, xa, xk, hp, bal_d, bal_c, gate, idx, slot_u
        try:
            del lib_d, lib_c
        except NameError:
            pass

    # the float32 cut: MODEL_CUT layers at full width, the first layers'
    # weights in float32, capacity factor 8 (as the SMOKE configs: no token
    # drops, which would tell a prefill of n + 1 tokens from a decode of one)
    cut = mcfg.scaled(num_layers=MODEL_CUT, param_dtype="float32",
                      compute_dtype="float32",
                      moe=dataclasses.replace(mcfg.moe, capacity_factor=8.0))
    cut_model = Model(cut)
    cp = {k: v.float() for k, v in mp.items() if k != "blocks"}
    cp["blocks"] = {g_: {k: v[:MODEL_CUT].float() for k, v in grp.items()}
                    for g_, grp in mp["blocks"].items()}
    del mp
    torch.cuda.empty_cache()
    t2 = toks[:CUT_BATCH, :CUT_SEQ + 1]
    with torch.no_grad():
        # (b) decode_step(prefill(t[:n])) ≈ prefill(t[:n + 1])
        _, c2 = cut_model.prefill(cp, {"tokens": t2[:, :CUT_SEQ]}, CUT_SEQ + 8)
        ld, _ = cut_model.decode_step(cp, c2, t2[:, CUT_SEQ:])
        lp2, _ = cut_model.prefill(cp, {"tokens": t2}, CUT_SEQ + 8)
    rel_b = errors(ld, lp2)[0]
    print(f"[check] models (b) {MODEL_CUT}-layer f32 cut: decode_step(prefill("
          f"t[:{CUT_SEQ}])) vs prefill(t[:{CUT_SEQ + 1}]) rel_inf_err={rel_b:.3e}"
          f" tol=2e-2 {'ok' if rel_b < 2e-2 else 'MISS'}", flush=True)
    if rel_b >= 2e-2 or not torch.isfinite(ld).all():
        fail(f"models (b): prefill and decode disagree, rel {rel_b}")
    del c2, ld, lp2

    # (d) loss_fn forward and backward on the cut, against "torch"
    batch_c = {"tokens": t2[:, :CUT_SEQ], "labels": t2[:, 1:CUT_SEQ + 1]}

    def loss_and_grads():
        flat = [(g_, k, v.clone().requires_grad_())
                for g_, grp in cp["blocks"].items() for k, v in grp.items()]
        top = {k: v.clone().requires_grad_() for k, v in cp.items()
               if k != "blocks"}
        tree = dict(top, blocks={})
        for g_, k, v in flat:
            tree["blocks"].setdefault(g_, {})[k] = v
        loss, metrics = cut_model.loss_fn(tree, batch_c)
        names = [f"blocks/{g_}/{k}" for g_, k, _ in flat] + list(top)
        grads = torch.autograd.grad(loss, [v for *_, v in flat]
                                    + list(top.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))

    builds0 = PATTERN_PREP["builds"]
    t0 = time.perf_counter()
    (loss_h, met_h, g_h), counts = drive(loss_and_grads, "models")
    step_s = time.perf_counter() - t0
    builds, k1_took = PATTERN_PREP["builds"] - builds0, took()["vsr_spmm"]
    reset_launch_counts()
    with repro_torch.use_backend("torch"):
        loss_t, met_t, g_t = loss_and_grads()
    torch.cuda.synchronize()
    torch_launches = sum(launch_counts().values())
    rels = {k: errors(g, g_t[k])[0] for k, g in g_h.items()}
    check_d = {"loss": float(loss_h), "loss_rel_err": errors(loss_h, loss_t)[0],
               "aux_loss": float(met_h["aux_loss"]),
               "max_grad_rel_err": max(rels.values()),
               "worst": max(rels, key=rels.get), "launches": counts,
               "k1_designs": k1_took, "torch_launches": torch_launches,
               "pattern_prep_builds": builds, "step_s": step_s}
    print(f"[check] models (d) {MODEL_CUT}-layer f32 cut loss_fn + backward "
          f"hopper vs torch: {json.dumps(check_d)} tol={RTOL['float32']:g}; "
          f"PATTERN_PREP builds {builds} (one transpose a MoE matrix: "
          f"dispatch and combine x {MODEL_CUT} layers)", flush=True)
    if check_d["loss_rel_err"] > RTOL["float32"] or \
            check_d["max_grad_rel_err"] > RTOL["float32"] or \
            counts["sddmm"] != MODEL_CUT or counts["vsr_spmm"] < 4 * MODEL_CUT \
            or builds != 2 * MODEL_CUT or not check_d["aux_loss"] > 0 \
            or torch_launches:
        fail(f"models (d): {check_d}")
    models_row["check_b_rel_err"], models_row["check_d"] = rel_b, check_d
    del cp, g_h, g_t, loss_and_grads
    torch.cuda.empty_cache()
    models_row["param_bytes"] = p_bytes
    models_row["phase_s"] = time.perf_counter() - t_models
    print(f"[models] phase {models_row['phase_s']:.1f} s ({card}); "
          f"[health] models {json.dumps(HEALTH.snapshot()['counters'])}",
          flush=True)

    # -- 17. serve ------------------------------------------------------------
    phase("serve")
    t_serve = time.perf_counter()

    def say_s(label, row):
        print(f"[serve] {label} " + json.dumps(row, default=str)
              + f" ({card})", flush=True)
    ctx = types.SimpleNamespace(dev=dev, seed=args.seed, fail=fail, say=say_s,
                                drive=drive, took=took, errors=errors,
                                rtol=RTOL["float32"], olmoe=None, llama=None,
                                cut_layers=MODEL_CUT)
    serve_rows = serve_phase(ctx)
    print(f"[serve] phase {time.perf_counter() - t_serve:.1f} s ({card}); "
          f"[health] serve {json.dumps(HEALTH.snapshot()['counters'])}",
          flush=True)

    # -- 18. driver -----------------------------------------------------------
    phase("driver")
    t_driver = time.perf_counter()
    ctx.say = lambda label, row: print(
        f"[driver] {label} " + json.dumps(row, default=str) + f" ({card})",
        flush=True)
    driver_row = driver_phase(ctx)
    print(f"[driver] phase {time.perf_counter() - t_driver:.1f} s ({card})",
          flush=True)

    # -- 19. families -----------------------------------------------------------
    phase("families")
    t_families = time.perf_counter()
    ctx.say = lambda label, row: print(
        f"[families] {label} " + json.dumps(row, default=str) + f" ({card})",
        flush=True)
    ctx.hold, ctx.bound, ctx.time_ms = hold, bound, time_ms
    ctx.rwkv = ctx.zamba = ctx.whisper = None
    families_rows = families_phase(ctx)
    print(f"[families] phase {time.perf_counter() - t_families:.1f} s "
          f"({card}); [health] families "
          f"{json.dumps(HEALTH.snapshot()['counters'])}", flush=True)

    # -- 20. sharded --------------------------------------------------------------
    phase("sharded")
    t_sharded = time.perf_counter()
    torch.cuda.empty_cache()
    sctx = types.SimpleNamespace(
        dev=dev, seed=args.seed, fail=fail, drive=drive, took=took,
        errors=errors, time_ms=time_ms, rtol=RTOL, graphs=graphs,
        say=lambda label, row: print(
            f"[sharded] {label} " + json.dumps(row, default=str)
            + f" ({card})", flush=True))
    sharded_phase(sctx)
    print(f"[sharded] phase {time.perf_counter() - t_sharded:.1f} s ({card}); "
          f"[health] sharded {json.dumps(HEALTH.snapshot()['counters'])}",
          flush=True)

    # -- 21. launch ---------------------------------------------------------------
    phase("launch")
    t_launch = time.perf_counter()
    # the full-width step holds two train states at once (the functional
    # AdamW returns a new one): free what the earlier phases cached first
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    repro_torch.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[launch] card memory of the earlier phases {held / 1e9:.2f} GB, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB with the plan cache "
          f"cleared, free {torch.cuda.mem_get_info()[0] / 1e9:.2f} GB",
          flush=True)
    lctx = types.SimpleNamespace(
        dev=dev, seed=args.seed, fail=fail, drive=drive, took=took,
        say=lambda label, row: print(
            f"[launch] {label} " + json.dumps(row, default=str)
            + f" ({card})", flush=True))
    launch_phase(lctx)
    print(f"[launch] phase {time.perf_counter() - t_launch:.1f} s ({card}); "
          f"[health] launch {json.dumps(HEALTH.snapshot()['counters'])}",
          flush=True)

    # -- 22. tp -------------------------------------------------------------------
    phase("tp")
    t_tp = time.perf_counter()
    repro_torch.clear_cache()
    gc_cuda()
    print(f"[tp] card memory of the earlier phases "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, free "
          f"{torch.cuda.mem_get_info()[0] / 1e9:.2f} GB", flush=True)
    tctx = types.SimpleNamespace(
        dev=dev, seed=args.seed, fail=fail, drive=drive, rtol=RTOL,
        time_ms=time_ms,
        say=lambda label, row: print(
            f"[tp] {label} " + json.dumps(row, default=str)
            + f" ({card})", flush=True))
    tp_rows = tp_phase(tctx)
    print(f"[tp] phase {time.perf_counter() - t_tp:.1f} s ({card})",
          flush=True)

    # -- 23. summary --------------------------------------------------------------
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
                        "launches_by_path": {path: counts[kernel] for path, counts
                                             in path_launches.items()},
                        "max_abs_err": max_abs[kernel], "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": shape})
        if kernel in designs:
            # the design each launch on the main path took, and on each path
            summary[-1]["design"] = {dd: nn for dd, nn in
                                     designs[kernel].items() if nn}
            summary[-1]["design_by_path"] = {
                path: {dd: nn for dd, nn in by_kernel[kernel].items() if nn}
                for path, by_kernel in path_designs.items()}
        if kernel == "vsr_spmm":
            # each of K1's designs at the pick that routes to it
            summary[-1]["designs"] = {
                dd: {"shape": f"{name}_s{args.scale}_e16 N={nn}",
                     "ms": rows[(name, nn)][f"{dd}_ms"],
                     "bound_ms": rows[(name, nn)]["bound_ms"],
                     "library_ms": rows[(name, nn)]["library_ms"]}
                for dd, (name, nn) in (("sr", SUMMARY_SHAPE[kernel]),
                                       ("pr", ("g500", 4)))}
        if kernel in ffn_rows:
            # the new widths of the training step: K1 sr at N = 2048, K6 at
            # d = 2048
            summary[-1]["ffn"] = ffn_rows[kernel]
        if kernel == "vsr_spmm":
            # one OLMoE-1B-7B layer's dispatch and combine at the prefill,
            # and the served model's launches by engine call; the pr design
            # on a shard of the sparse Llama FFN at placed decode
            summary[-1]["models"] = models_row["k1"]
            summary[-1]["serve"] = serve_rows["launches_by_call"]
            summary[-1]["tp_decode"] = tp_rows["k1_decode"]
        if kernel == "chain_stats":
            # K7 in full mode, as the chain's backward recomputes it
            summary[-1]["backward"] = k7_rows
        if kernel in ("chain_stats", "chain"):
            # one head of Zamba2-2.7B's shared attention (d = 80), block
            # design, and its launches in phase families
            summary[-1]["families"] = families_rows[
                "k7_d80" if kernel == "chain_stats" else "k8_d80"]
        if kernel in CODED:
            # launches by the value type of the slab read, on each path
            summary[-1]["launches_by_value"] = {
                path: {vt: nn for vt, nn in by_kernel[kernel].items() if nn}
                for path, by_kernel in path_values.items()}
        if kernel == "bsr_spmm":
            # K11 on A^T's blocks, the backward's dX, at N = 128
            r = bsr_bwd_rows[BSR_SUMMARY_N]
            summary[-1]["transposed"] = {
                "shape": f"gemma ffn_up A^T {tuple(BSR_BLOCK[::-1])} N={BSR_SUMMARY_N}",
                "ms": r["k11_t_ms"], "design": r["k11_t_design"],
                "plain_ms": r["k11_t_plain_ms"], "bound_ms": r["k11_t_bound_ms"],
                "bound_by": r["k11_t_bound_by"], "library_ms": r["library_ms"]}
    # the coded variants of K1, K2, K4 and K5: launches on the quant path,
    # times at the summary shape beside the f32 kernel of the same design
    for kernel, (replaces, branch) in CODED.items():
        for mode in QUANT_MODES:
            key = f"{kernel}:{mode}"
            row = coded_rows[key]
            summary.append({
                "name": key, "route": "cuda", "source": KERNELS[kernel]["source"],
                "replaces": replaces, "quant_branch": branch,
                "launches": path_values["quant"][kernel][mode],
                "launches_by_path": {path: by_kernel[kernel][mode]
                                     for path, by_kernel in path_values.items()},
                "max_abs_err": max_abs[key], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "f32_ms": row["f32_kernel_ms"], "f32_bound_ms": row["f32_bound_ms"],
                "shape": row["shape"]})
            if kernel == "vsr_spmm":
                pr = coded_rows[f"{key}:pr"]
                summary[-1]["designs"] = {
                    "pr": {"shape": pr["shape"], "ms": pr["kernel_ms"],
                           "f32_ms": pr["f32_kernel_ms"], "bound_ms": pr["bound_ms"],
                           "library_ms": pr["library_ms"]}}
                if mode == "int8":
                    summary[-1]["pattern_matmul"] = dict(
                        pm_row, shape="gemma ffn_gate 15360x3840 N=2048")
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
