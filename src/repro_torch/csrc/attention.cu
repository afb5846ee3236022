// K9 and K10 — block-sparse attention over the BalancedCOO pattern:
// y = softmax_mask(scale·Q·Kᵀ + bias) · V, the mask being the pattern and
// the bias an additive per-edge stream (ALiBi, relative position) laid out
// like the pattern's slabs.  K9 and K10 are K7 and K8 with z = scale·e +
// bias[slot]: the bias is read once per valid slot, padding reads none.
//
// K9 replaces the TPU kernel src/repro/kernels/attention.py::
// _attn_stats_kernel (pallas_call in _attn_stats_call): each row's max rm of
// z and sum rs of exp(z − rm), empty rows left at (−1e30, 0).  The TPU folds
// (max, sum) over consecutive visits of one (mb, wb) output block on its
// sequential grid; the port keeps one packed (rm, rs) pair a row and lets
// the CTAs of a row's tiles run at once.
//
// K10 replaces src/repro/kernels/attention.py::_attn_kernel (pallas_call in
// _attn_apply_call): recompute z, form w = exp(z − rm) / max(rs, 1e-30) in
// registers, accumulate w·V[col] into Y[row].  The TPU's one-hot MXU
// reduction into revisited (wb, tile_n) blocks is not carried over.
//
// Bound on H100.  Per kept entry K9 reads the bias (4 B; the slot-tile
// design also the pattern, 8 B) and does 2·d flops for the score; Q and K
// are read once (4·(M+K)·d B in f32).  At a head width of d = 256 that is
// 512 flops to 12 B, above the balance point even of the f32 tensor-core
// route (3×TF32, 495/3 ≈ 165 TFLOP/s over 3.35 TB/s ≈ 49 flops a byte): K9
// is bound by operations, and so is K10 at N = 256 (2·(d + N) flops an
// entry).  At d = N = 64 both are bound by bytes.
//
// Two designs, routed per call by kernels/blocks.py::_route: the block
// design when the pattern keeps at least a quarter of the entries of the
// 64×64 blocks it touches (BLOCK_FILL_MIN), d ≤ 256, and Q, K, V share one
// type whose rows take 16-byte loads; the slot-tile design otherwise (a
// scattered graph, fill ≈ 1/4096).
//
// The block design also runs K7 and K8's softmax (the TPU kernels
// src/repro/kernels/fused_chain.py::_chain_stats_kernel and _chain_kernel)
// on attention patterns, the model's path without a bias: a NULL bias
// instantiates both block kernels with HasBias = false, which drops the
// bias gather and its 16 registers a thread, and z = alpha·s.  The same
// bound holds without the 4·nnz bias bytes; at d = 256 it is set by
// operations.  csrc/chain.cu keeps K7/K8's slot-tile design for scattered
// graphs, identity and scale.
//
// ---------------------------------------------------------------------------
// The slot-tile design, one balanced tile a CTA on the CUDA cores.  What it
// moves is more than its bound: every slot gathers the d-wide rows Q[row]
// (reused along the row's run, from L1) and K[col] (a key row is shared by
// the ~1k queries that attend to it, so mostly from L2), and K10 a V row too.
//
// Design, K9: one CTA per balanced tile.  The CTA computes its tile's z once
// (score.cuh) into shared memory.  Every row of an attention pattern spans
// whole tiles (Gemma's local layer at 8,192 tokens: 1,088 keys a row, 2–3
// rows a tile), so a walk of each run by one thread would leave 255 of 256
// threads idle.  Instead the tile's runs are folded by the segmented
// shuffle scan of the online-softmax pair (m, s) that K7 and K8 share
// (score.cuh::scan_runs): a run that holds neither the tile's first nor its
// last slot is stored, the others may continue in a neighbouring tile and
// are merged into the row's packed 64-bit (rm, rs) by atomicCAS
// (score.cuh::merge_stats).  Each slot starts from (max(z, −1e30),
// exp(z − that)), which is the reference's scatter-max with a −1e30 floor,
// so a bias of −inf gives a weight of 0 and no NaN.
//
// Design, K10: one CTA per (tile, column block of up to 128 columns of V);
// step 1 computes w for the tile's slots into shared memory, step 2 is the
// tile accumulation of common.cuh::accumulate_tile.  At
// N = 256 each of the two column blocks recomputes the scores.  An empty row
// receives nothing and stays exactly 0.
//
// ---------------------------------------------------------------------------
// The block design, one CTA per chunk of a 64-query-row block, on the tensor
// cores.  The host (BlockLayout) lists the 64×64 blocks each row block
// touches, each (block, row)'s 64-bit mask of kept keys and the slot of its
// first kept key, and a work list that cuts a row block of more than twice
// the mean number of blocks into chunks of about the mean (BigBird's global
// rows: 64 blocks into 7 chunks; Gemma's band stays whole), the paper's
// workload balancing at the block granule.
//
// Grid and staging.  A CTA of 4 warps, each owning 16 query rows, stages its
// 64 rows of Q in shared memory once, then walks its blocks in stages of 32
// keys (half a block): the K rows (and, in K10, the V rows of the CTA's
// column chunk) of stage s + 1 are copied by cp.async while stage s
// computes, two buffers each.  Rows past M or K and depth past d are filled
// with zeros, so ragged edges read nothing out of bounds.  Every key row
// staged is used by all 64 query rows: the slot-tile design fetched it
// once per query.  32-key stages keep K10 at d = N = 256 in f32 within one
// block's shared memory: Q 66 KB + 2 × (K 33 + V 32.5) KB = 197 KB (K9:
// 132 KB), one CTA an SM; a warp skips a stage none of its rows keeps.
//
// Scores.  S = Q·Kᵀ for a warp's 16 rows × 32 keys is mma.sync on the
// tensor cores: bf16 operands as they are (m16n8k16, f32 accumulation);
// f32 operands by the 3×TF32 split (m16n8k8; x = hi + lo, hi·hi + hi·lo +
// lo·hi), since one TF32 pass errs by ≈ 2⁻¹¹ relative in a product, ≈ 5e-4
// in z at d = 256, over the 1e-4 f32 tolerance.  The split keeps ≈ 2⁻²².
// The depth order of a k-step is permuted (MMA k = t, t + 4 ↔ depth 2t,
// 2t + 1) so each fragment is one 8-byte shared load.  Row strides padded
// by 8 elements (V in f32 by 4) put a fragment load's rows in distinct
// banks.
//
// Masking.  z = scale·s + bias at the kept keys, the bias gathered at slot
// start + popcount(mask & ((1 << c) − 1)) (the kept keys of a row in a
// block are one run of slots in the CSR stream); masked keys get −inf, by
// selection, so a non-finite K row at a masked key reaches no row.  Each
// row's max starts from −1e30, so a bias of −inf gives weight 0, no NaN.
// The gather is issued before the stage's products and each stage's masks
// are read a stage ahead: with one CTA an SM no other warp hides a load's
// latency, and a gather issued after the products waited in full.
//
// K9.  Each thread folds the online-softmax pair (max, sum) of its two rows
// over the stages in registers, the four lanes of a row fold by shuffles at
// the end, and the row's packed 64-bit (rm, rs) is stored — or, for a chunk
// of a split row block, merged by atomicCAS (score.cuh::merge_stats).
//
// K10.  With the statistics known the weights need no rescaling across
// blocks: p = exp(z − rm) in registers is the A operand of O += P·V_blk on
// the tensor cores (f32: 3×TF32, the keys of a k-step permuted so that S's
// C fragment is P's A fragment as it stands; bf16: P rounded to bf16, the C
// fragments of two key tiles are one A fragment).  The CTA owns up to 256
// output columns (8, 64, 128 or 256, by N; N = 1 pads V's width to 8 in
// shared memory), so the scores are computed once; above 256 columns each
// chunk of 256 recomputes them.  A warp's accumulator is 16 rows × N
// columns (128 f32 a lane at N = 256).  At the end y = O / max(rs, 1e-30),
// stored for a whole row block, atomicAdd-ed into the zeroed y by the
// chunks of a split one (given the statistics the partial sums add
// linearly; their order varies from run to run).  A row with no kept key
// gets exactly 0.
//
// One barrier a stage (both kernels): stage s + 1's copies are waited for
// at the end of stage s, and one barrier publishes them and frees the
// buffer stage s used.
//
// Non-finite V.  P·V over a whole tile would multiply a masked key's weight
// 0 by its V row, and 0·inf or 0·NaN would reach rows that do not attend
// the key; the 3×TF32 split of an inf is NaN as well (lo = inf − inf).  So
// once a stage's V tile has landed, each thread zeroes the inf and NaN
// entries among the elements it copied and marks their keys in a 32-bit
// word in shared memory (when V is finite, a branch-free pass over its
// 16-byte chunks; the stage's barrier is a __syncthreads_or that says
// whether any thread found one).  Only then, for each marked key, the rows
// that keep it add w·V[key][col] from device memory in f32 at the columns
// where V is not finite: inf for w > 0, NaN for w = 0 or a NaN, as the
// reference gives.
#include "mma.cuh"
#include "score.cuh"

namespace repro_torch {

template <typename TA>
__global__ void __launch_bounds__(kChainThreads)
attn_stats_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                  const TA* __restrict__ q, const TA* __restrict__ k,
                  const float* __restrict__ bias,
                  unsigned long long* __restrict__ stats, int tile, int m,
                  int d, int g, bool vec, float scale) {
  extern __shared__ int smem[];
  const ScanPieces<SoftmaxOp> pieces(smem, (tile + 31) / 32);
  int* s_rows = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) +
                                       scan_pieces_bytes(tile));
  float* s_z = reinterpret_cast<float*>(s_rows + tile);
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for_each_score<TA>(rows, cols, q, k, base, tile, m, d, g, vec,
                     [&](int slot, int r, int, bool valid, float e) {
                       s_rows[slot] = valid ? r : m;
                       s_z[slot] = valid ? scale * e + bias[base + slot] : 0.f;
                     });
  __syncthreads();
  // the tile's first and last runs may continue in another tile and are
  // merged, the others stored
  const int n_chunks = (tile + 31) / 32;
  scan_runs<SoftmaxOp, false>(
      s_rows, tile, m, n_chunks, n_chunks, pieces, nullptr,
      [&](int slot, int) { return SoftmaxOp::of(s_z[slot]); },
      [&](int r, float2 v, bool edge) {
        if (edge)
          merge_stats(&stats[r], v.x, v.y);
        else
          stats[r] = pack_stats(v.x, v.y);
      });
}

template <typename TA, typename TX, int CPL>
__global__ void __launch_bounds__(kChainThreads)
attn_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
            const TA* __restrict__ q, const TA* __restrict__ k,
            const float* __restrict__ bias, const float2* __restrict__ stats,
            const TX* __restrict__ v, float* __restrict__ y, int tile, int m,
            int n, int d, int g, bool vec, float scale, int lanes_n) {
  extern __shared__ int smem[];
  int* s_rows = smem;
  int* s_cols = s_rows + tile;
  float* s_w = reinterpret_cast<float*>(s_cols + tile);
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for_each_score<TA>(
      rows, cols, q, k, base, tile, m, d, g, vec,
      [&](int slot, int r, int c, bool valid, float e) {
        float w = 0.f;
        if (valid) {
          const float2 st = stats[r];
          w = expf(scale * e + bias[base + slot] - st.x) /
              fmaxf(st.y, kSoftmaxEps);
        }
        s_rows[slot] = valid ? r : m;
        s_cols[slot] = c;
        s_w[slot] = w;
      });
  __syncthreads();
  accumulate_tile<TX, CPL>(s_rows, s_cols, s_w, v, y, tile, m, n, lanes_n);
}

template <typename TA>
int launch_attn_stats(const int* rows, const int* cols, const void* q,
                      const void* k, const float* bias, float* stats,
                      int n_tiles, int tile, int m, int d, float scale,
                      cudaStream_t stream) {
  const bool vec = score_vec<TA>(q, k, d);
  const int g = score_lanes<TA>(d, vec);
  const size_t smem = scan_pieces_bytes(tile) +
                      static_cast<size_t>(tile) * 2 * sizeof(int);
  attn_stats_kernel<TA><<<n_tiles, kChainThreads, smem, stream>>>(
      rows, cols, static_cast<const TA*>(q), static_cast<const TA*>(k), bias,
      reinterpret_cast<unsigned long long*>(stats), tile, m, d, g, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TX>
int launch_attn(const int* rows, const int* cols, const void* q,
                const void* k, const float* bias, const float* stats,
                const void* v, float* y, int n_tiles, int tile, int m, int n,
                int d, float scale, cudaStream_t stream) {
  const bool vec = score_vec<TA>(q, k, d);
  const int g = score_lanes<TA>(d, vec);
  const int lanes_n = lanes_per_row(n);
  const int cpl = columns_per_lane(n);
  const dim3 grid(n_tiles, (n + lanes_n * cpl - 1) / (lanes_n * cpl));
  const size_t smem = static_cast<size_t>(tile) * 3 * sizeof(int);
  const TA* qq = static_cast<const TA*>(q);
  const TA* kk = static_cast<const TA*>(k);
  const float2* st = reinterpret_cast<const float2*>(stats);
  const TX* vv = static_cast<const TX*>(v);
  if (cpl == 1)
    attn_kernel<TA, TX, 1><<<grid, kChainThreads, smem, stream>>>(
        rows, cols, qq, kk, bias, st, vv, y, tile, m, n, d, g, vec, scale, lanes_n);
  else if (cpl == 2)
    attn_kernel<TA, TX, 2><<<grid, kChainThreads, smem, stream>>>(
        rows, cols, qq, kk, bias, st, vv, y, tile, m, n, d, g, vec, scale, lanes_n);
  else
    attn_kernel<TA, TX, 4><<<grid, kChainThreads, smem, stream>>>(
        rows, cols, qq, kk, bias, st, vv, y, tile, m, n, d, g, vec, scale, lanes_n);
  return static_cast<int>(cudaGetLastError());
}


// ===========================================================================
// The block design.
// ===========================================================================

// Shared-memory row padding, in elements: a row of Q or K (f32 or bf16) and
// a row of V in bf16 are 8 elements longer than their padded width, a row of
// V in f32 4 longer, which puts the rows that one fragment load touches in
// distinct banks.
constexpr int kQkPad = 8;
template <typename T>
__host__ __device__ constexpr int v_pad() { return sizeof(T) == 4 ? 4 : 8; }

constexpr int kBlk = 64;          // query rows of a row block, keys of a block
constexpr int kStage = 32;        // keys staged at a time: half a block
constexpr int kBlkThreads = 128;  // 4 warps, 16 query rows each

// The top bit of each value in a 32-bit word of T values whose exponent
// field is all ones (adding 1 to an all-ones field carries into it), the
// other bits 0, branch-free.
template <typename T>
__device__ __forceinline__ unsigned nonfinite_bits(unsigned w) {
  constexpr unsigned kExp = sizeof(T) == 4 ? 0x7f800000u : 0x7f807f80u;
  constexpr unsigned kOne = sizeof(T) == 4 ? 0x00800000u : 0x00800080u;
  constexpr unsigned kTop = sizeof(T) == 4 ? 0x80000000u : 0x80008000u;
  return ((w & kExp) + kOne) & kTop;
}

// Zero the inf and NaN entries among the elements of a staged kStage × NC
// tile that this thread wrote (stage_tile's assignment: its cp.async
// chunks — the i-th 16-byte chunk of the tile, i = threadIdx.x + k·128 — or
// its elements on the synchronous path), and set bit r of *bad for every
// row r that held one.  The thread's own copies have landed once its
// cp.async group is waited for, so no barrier is needed first; the
// caller's barrier publishes the zeros and the bits.  Returns whether the
// thread found any.  With 16-byte chunks, a branch-free pass over them
// comes first, and the element walk runs only where it finds one.
template <typename T, int NC>
__device__ __forceinline__ bool clear_nonfinite(T* s, int ss, bool vec,
                                                unsigned* bad) {
  constexpr int E = elems16<T>(), kPerRow = NC / E;
  constexpr int kChunks = kStage * kPerRow;
  if (vec) {
    // four chunks in flight: the accumulators of P·V are live here, and a
    // fully unrolled pass (16 chunks at 256 f32 columns) pushed the kernel
    // past 255 registers
    unsigned any = 0;
#pragma unroll 4
    for (int i0 = 0; i0 < kChunks; i0 += kBlkThreads) {
      const int i = i0 + threadIdx.x;
      if (kChunks % kBlkThreads == 0 || i < kChunks) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            s + (i / kPerRow) * ss + (i % kPerRow) * E);
        any |= nonfinite_bits<T>(w.x) | nonfinite_bits<T>(w.y) |
               nonfinite_bits<T>(w.z) | nonfinite_bits<T>(w.w);
      }
    }
    if (!any) return false;
  }
  bool found = false;
  const int n_el = vec ? E : 1;
  for (int i = threadIdx.x; i < (vec ? kChunks : kStage * NC);
       i += kBlkThreads) {
    const int per = vec ? kPerRow : NC;
    const int r = i / per;
    T* x = s + r * ss + (i - r * per) * n_el;
    for (int e = 0; e < n_el; ++e)
      if (nonfinite(x[e])) {
        x[e] = T(0.f);
        found = true;
        atomicOr(bad, 1u << r);
      }
  }
  return found;
}

// One warp's scores S = Q·Kᵀ for its 16 query rows (sq) and the 32 staged
// keys (sk), over the padded depth dp: acc[j] is the m16n8 C fragment of
// keys 8j .. 8j + 7 (c0, c1: row g, keys 8j + 2t, +1; c2, c3: row g + 8).
// f32: 3×TF32 m16n8k8, the depth order permuted so that the A fragment's k
// = t and t + 4 are the depths 2t and 2t + 1 (one 8-byte load each).
__device__ __forceinline__ void warp_scores(const float* sq, const float* sk,
                                            int ss, int dp,
                                            float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < dp; k0 += 8) {
    const float2 qa = *reinterpret_cast<const float2*>(sq + g * ss + k0 + 2 * t);
    const float2 qb =
        *reinterpret_cast<const float2*>(sq + (g + 8) * ss + k0 + 2 * t);
    unsigned ah[4], al[4];
    split_tf32(qa.x, ah[0], al[0]);
    split_tf32(qb.x, ah[1], al[1]);
    split_tf32(qa.y, ah[2], al[2]);
    split_tf32(qb.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 kv =
          *reinterpret_cast<const float2*>(sk + (8 * j + g) * ss + k0 + 2 * t);
      unsigned bh[2], bl[2];
      split_tf32(kv.x, bh[0], bl[0]);
      split_tf32(kv.y, bh[1], bl[1]);
      mma_3xtf32(acc[j], ah, al, bh, bl);
    }
  }
}

// bf16: m16n8k16 on the operands as they are, f32 accumulation.
__device__ __forceinline__ void warp_scores(const __nv_bfloat16* sq,
                                            const __nv_bfloat16* sk, int ss,
                                            int dp, float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < dp; k0 += 16) {
    const __nv_bfloat16* q0 = sq + g * ss + k0 + 2 * t;
    const __nv_bfloat16* q1 = q0 + 8 * ss;
    const unsigned a[4] = {*reinterpret_cast<const unsigned*>(q0),
                           *reinterpret_cast<const unsigned*>(q1),
                           *reinterpret_cast<const unsigned*>(q0 + 8),
                           *reinterpret_cast<const unsigned*>(q1 + 8)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* k = sk + (8 * j + g) * ss + k0 + 2 * t;
      const unsigned b[2] = {*reinterpret_cast<const unsigned*>(k),
                             *reinterpret_cast<const unsigned*>(k + 8)};
      mma_bf16(acc[j], a, b);
    }
  }
}

// One warp's O += P·V for its 16 rows: p holds the weights in the scores'
// C-fragment layout, sv the 32 staged rows of V (row stride vs), o[nt] the
// C fragment of output columns 8nt .. 8nt + 7.  f32: 3×TF32 m16n8k8 with
// the keys of k-step j permuted so that the C fragment of S is the A
// fragment of P as it stands: k = t ↔ key 8j + 2t, k = t + 4 ↔ 8j + 2t + 1.
template <int NT>
__device__ __forceinline__ void warp_pv(const float (&p)[4][4],
                                        const float* sv, int vs,
                                        float (&o)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
    const float* v0 = sv + (8 * j + 2 * t) * vs + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      unsigned bh[2], bl[2];
      split_tf32(v0[8 * nt], bh[0], bl[0]);
      split_tf32(v0[vs + 8 * nt], bh[1], bl[1]);
      mma_3xtf32(o[nt], ah, al, bh, bl);
    }
  }
}

// bf16: P rounded to bf16; the C fragments of key tiles 2j and 2j + 1 are
// the A fragment of k-step j (keys 16j .. 16j + 15) as they stand.
template <int NT>
__device__ __forceinline__ void warp_pv(const float (&p)[4][4],
                                        const __nv_bfloat16* sv, int vs,
                                        float (&o)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const unsigned a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    const __nv_bfloat16* v0 = sv + (16 * j + 2 * t) * vs + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* v = v0 + 8 * nt;
      const unsigned b[2] = {pack_bf16(v[0], v[vs]),
                             pack_bf16(v[8 * vs], v[9 * vs])};
      mma_bf16(o[nt], a, b);
    }
  }
}

// A CTA's work item: row block rb, its blocks first .. first + count − 1, and
// whether the row block is split over several CTAs.
struct BlockWork {
  int rb, first, count, split;
};

// What a thread knows of a stage for its rows lr and lr + 8: the kept-key
// bits of the stage's 32 keys, and the slot of the first kept one.
struct StageMask {
  unsigned keep[2];
  int base[2];
};

// The masks of stage s (block first + s / 2, half s % 2), read from device
// memory a stage ahead of their use.
__device__ __forceinline__ StageMask stage_mask(
    const unsigned long long* __restrict__ masks,
    const int* __restrict__ starts, int first, int s, int lr) {
  StageMask sm;
  const int h = s & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at =
        static_cast<long long>(first + (s >> 1)) * kBlk + lr + 8 * i;
    const unsigned long long mk = masks[at];
    sm.keep[i] = static_cast<unsigned>(mk >> (32 * h));
    sm.base[i] = starts[at] + (h ? __popc(static_cast<unsigned>(mk)) : 0);
  }
  return sm;
}

// The bias of the thread's fragment entries (b[j][e] as the scores' C
// fragment acc[j][e]) at the kept keys, 0 elsewhere: key c's bias is at the
// slot base + popcount(keep & ((1 << c) − 1)).  Gathered before the stage's
// products, so the loads are in flight while the tensor cores work.
__device__ __forceinline__ void stage_bias(const StageMask& sm,
                                           const float* __restrict__ bias,
                                           float (&b)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, key = 8 * j + 2 * t + (e & 1);
      b[j][e] = (sm.keep[i] >> key) & 1u
                    ? bias[sm.base[i] + __popc(sm.keep[i] & ((1u << key) - 1u))]
                    : 0.f;
    }
}

// z = scale·s (+ bias) at the kept keys, −inf at the others, in place of
// the scores' C fragments.  Masking selects, so a non-finite K row at a
// masked key reaches no row.
template <bool HasBias>
__device__ __forceinline__ void stage_logits(const StageMask& sm,
                                             const float (&b)[4][4],
                                             float scale, float (&acc)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      float z = scale * acc[j][e];
      if constexpr (HasBias) z += b[j][e];
      acc[j][e] = (sm.keep[e >> 1] >> key) & 1u ? z : -INFINITY;
    }
}

// Add w·V[key][col] to the thread's accumulators for each key of the stage
// whose V row held an inf or NaN in the CTA's columns (the bits of `bad`;
// clear_nonfinite zeroed those entries in shared memory, so P·V sees
// finite values), at the thread's rows that keep the key and its columns
// where V is not finite, V read from device memory.  A masked key's inf or NaN so
// reaches no row, and a kept key's gives inf (w > 0) or NaN (w = 0, or a
// NaN in V), as the reference's w·V does; the 3×TF32 split would have made
// NaN of every inf (lo = inf − inf).  p holds the weights in the scores' C
// fragment layout: a key's weights come from the lane of the quad that
// holds it.
template <typename T, int NT>
__device__ __forceinline__ void add_nonfinite(unsigned bad,
                                              const StageMask& sm,
                                              const float (&p)[4][4],
                                              const T* __restrict__ v,
                                              int key0, int n, int col0,
                                              float (&o)[NT][4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  while (bad) {
    const int key = __ffs(bad) - 1;
    bad &= bad - 1;
    float mine[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * t + e == key) {
          mine[0] = p[j][e];
          mine[1] = p[j][2 + e];
        }
    const int src = (lane & ~3) | ((key & 7) >> 1);
    const float w[2] = {__shfl_sync(0xffffffffu, mine[0], src),
                        __shfl_sync(0xffffffffu, mine[1], src)};
    const T* vr = v + static_cast<long long>(key0 + key) * n;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * nt + 2 * t + e;
        if (col >= n) continue;
        const float x = to_f32(vr[col]);
        if (!nonfinite(x)) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if ((sm.keep[i] >> key) & 1u) o[nt][2 * i + e] += w[i] * x;
      }
  }
}

template <typename T, bool HasBias>
__global__ void __launch_bounds__(kBlkThreads, 1)
attn_stats_blocks_kernel(const int4* __restrict__ work,
                         const int* __restrict__ block_col,
                         const unsigned long long* __restrict__ masks,
                         const int* __restrict__ starts,
                         const T* __restrict__ q, const T* __restrict__ k,
                         const float* __restrict__ bias,
                         unsigned long long* __restrict__ stats, int m,
                         int kdim, int d, int dp, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ss = dp + kQkPad;
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kBlk * ss;                       // 2 buffers of kStage rows
#ifdef REPRO_POISON_STAGING
  poison_staging(smem_raw, static_cast<size_t>(kBlk + 2 * kStage) * ss * sizeof(T));
#endif
  const int4 w4 = work[blockIdx.x];
  const BlockWork w{w4.x, w4.y, w4.z, w4.w};
  const int row0 = w.rb * kBlk, n_stages = 2 * w.count;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = warp * 16 + (lane >> 2);       // local rows lr, lr + 8

  auto issue = [&](int s) {
    const int key0 = block_col[w.first + (s >> 1)] * kBlk + (s & 1) * kStage;
    stage_tile(sk + (s & 1) * kStage * ss, ss, k, d, key0, kdim, 0, d, kStage,
               dp, true);
  };
  stage_tile(sq, ss, q, d, row0, m, 0, d, kBlk, dp, true);
  issue(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // As in attn_blocks_kernel: stage s + 1 lands and is published by the one
  // barrier at the end of stage s.
  float mx[2] = {kSoftmaxNeg, kSoftmaxNeg}, sm[2] = {0.f, 0.f};
  StageMask cur = stage_mask(masks, starts, w.first, 0, lr);
  for (int s = 0; s < n_stages; ++s) {
    const StageMask next =
        stage_mask(masks, starts, w.first, min(s + 1, n_stages - 1), lr);
    if (s + 1 < n_stages) {
      issue(s + 1);
      cp_async_commit();
    }
    if (__any_sync(0xffffffffu, cur.keep[0] | cur.keep[1])) {
      float b[4][4], z[4][4] = {};
      if constexpr (HasBias) stage_bias(cur, bias, b);
      warp_scores(sq + warp * 16 * ss, sk + (s & 1) * kStage * ss, ss, dp, z);
      stage_logits<HasBias>(cur, b, scale, z);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float top = kSoftmaxNeg;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          top = fmaxf(top, fmaxf(z[j][2 * i], z[j][2 * i + 1]));
        const float mn = fmaxf(mx[i], top);
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          add += expf(z[j][2 * i] - mn) + expf(z[j][2 * i + 1] - mn);
        sm[i] = sm[i] * expf(mx[i] - mn) + add;
        mx[i] = mn;
      }
    }
    cur = next;
    if (s + 1 < n_stages) {
      cp_async_wait<0>();
      __syncthreads();
    }
  }

  // Fold the four lanes of each row, then store (a whole row block) or
  // merge (a chunk of a split one) the row's pair.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, sm[i], off);
      const float mn = fmaxf(mx[i], om);
      sm[i] = sm[i] * expf(mx[i] - mn) + os * expf(om - mn);
      mx[i] = mn;
    }
    const int row = row0 + lr + 8 * i;
    if ((lane & 3) == 0 && row < m) {
      if (!w.split)
        stats[row] = pack_stats(mx[i], sm[i]);
      else if (sm[i] > 0.f || mx[i] > kSoftmaxNeg)
        merge_stats(&stats[row], mx[i], sm[i]);
    }
  }
}

template <typename T, int NT, bool HasBias>
__global__ void __launch_bounds__(kBlkThreads, 1)
attn_blocks_kernel(const int4* __restrict__ work,
                   const int* __restrict__ block_col,
                   const unsigned long long* __restrict__ masks,
                   const int* __restrict__ starts, const T* __restrict__ q,
                   const T* __restrict__ k, const float* __restrict__ bias,
                   const float2* __restrict__ stats, const T* __restrict__ v,
                   float* __restrict__ y, int m, int kdim, int n, int d,
                   int dp, float scale, bool vec_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned s_bad[3];   // per stage mod 3: keys whose V is not finite
  constexpr int NC = 8 * NT;                    // output columns of a CTA
  const int ss = dp + kQkPad, vs = NC + v_pad<T>();
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kBlk * ss;                       // 2 buffers of kStage rows
  T* sv = sk + 2 * kStage * ss;                 // 2 buffers of kStage rows
#ifdef REPRO_POISON_STAGING
  poison_staging(smem_raw, (static_cast<size_t>(kBlk + 2 * kStage) * ss +
                            static_cast<size_t>(2 * kStage) * vs) * sizeof(T));
#endif
  const int4 w4 = work[blockIdx.x];
  const BlockWork w{w4.x, w4.y, w4.z, w4.w};
  const int row0 = w.rb * kBlk, n_stages = 2 * w.count;
  const int col0 = blockIdx.y * NC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = warp * 16 + g;

  auto stage_key0 = [&](int s) {
    return block_col[w.first + (s >> 1)] * kBlk + (s & 1) * kStage;
  };
  auto issue = [&](int s) {
    const int key0 = stage_key0(s);
    stage_tile(sk + (s & 1) * kStage * ss, ss, k, d, key0, kdim, 0, d, kStage,
               dp, true);
    stage_tile(sv + (s & 1) * kStage * vs, vs, v, n, key0, kdim, col0, n,
               kStage, NC, vec_v);
  };
  if (threadIdx.x == 0) s_bad[0] = s_bad[1] = s_bad[2] = 0u;
  stage_tile(sq, ss, q, d, row0, m, 0, d, kBlk, dp, true);
  issue(0);
  cp_async_commit();

  float rm[2];
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + lr + 8 * i;
    const float2 st = row < m ? stats[row] : make_float2(kSoftmaxNeg, 0.f);
    rm[i] = st.x;
    inv[i] = 1.f / fmaxf(st.y, kSoftmaxEps);
  }
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  // A stage's tiles land, are checked and are published at the end of the
  // stage before (stage 0's here): each thread waits for its own copies and
  // clears the inf/NaN entries of V among them, then one barrier makes the
  // tiles, the zeros and the marks visible and frees the other buffer, so a
  // stage needs one barrier.  Marks of stage s go to s_bad[s % 3], which is
  // read right after the barrier that publishes it and reset after the
  // next one, two barriers before its next use.
  __syncthreads();                              // s_bad zeroed
  cp_async_wait<0>();
  unsigned marked = __syncthreads_or(
      clear_nonfinite<T, NC>(sv, vs, vec_v, &s_bad[0])) ? s_bad[0] : 0u;

  StageMask cur = stage_mask(masks, starts, w.first, 0, lr);
  for (int s = 0; s < n_stages; ++s) {
    const StageMask next =
        stage_mask(masks, starts, w.first, min(s + 1, n_stages - 1), lr);
    if (s + 1 < n_stages) {
      issue(s + 1);
      cp_async_commit();
    }
    T* sv_s = sv + (s & 1) * kStage * vs;
    if (__any_sync(0xffffffffu, cur.keep[0] | cur.keep[1])) {
      float b[4][4], p[4][4] = {};
      if constexpr (HasBias) stage_bias(cur, bias, b);
      warp_scores(sq + warp * 16 * ss, sk + (s & 1) * kStage * ss, ss, dp, p);
      stage_logits<HasBias>(cur, b, scale, p);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = expf(p[j][e] - rm[e >> 1]);
      warp_pv<NT>(p, sv_s, vs, o);
      if (marked)
        add_nonfinite<T, NT>(marked, cur, p, v, stage_key0(s), n, col0, o);
    }
    cur = next;
    if (s + 1 < n_stages) {
      cp_async_wait<0>();
      const int t = (s + 1) % 3;
      const bool bad = __syncthreads_or(clear_nonfinite<T, NC>(
          sv + ((s + 1) & 1) * kStage * vs, vs, vec_v, &s_bad[t]));
      if (marked && threadIdx.x == 0) s_bad[s % 3] = 0u;
      marked = bad ? s_bad[t] : 0u;
    }
  }

  // w = exp(z − rm) / max(rs, 1e-30): the division once, at the end.  A
  // whole row block stores its rows; a chunk of a split one adds into the
  // zeroed y.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + lr + 8 * i;
    if (row >= m) continue;
    float* yr = y + static_cast<long long>(row) * n;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * nt + 2 * t + e;
        if (col >= n) continue;
        const float val = o[nt][2 * i + e] * inv[i];
        if (w.split)
          atomicAdd(yr + col, val);
        else
          yr[col] = val;
      }
  }
}

// Dynamic shared memory of the two kernels, in bytes.
template <typename T>
size_t stats_blocks_smem(int dp) {
  return static_cast<size_t>(kBlk + 2 * kStage) * (dp + kQkPad) *
         sizeof(T);
}
template <typename T, int NT>
size_t chain_blocks_smem(int dp) {
  return stats_blocks_smem<T>(dp) +
         static_cast<size_t>(2 * kStage) * (8 * NT + v_pad<T>()) * sizeof(T);
}

inline int padded_depth(int d, int kstep) {
  return (d + kstep - 1) / kstep * kstep;
}

template <typename T, bool HasBias>
int launch_stats_blocks_as(const int* work, int n_chunks, const int* block_col,
                           const void* masks, const int* starts, const void* q,
                           const void* k, const float* bias, float* stats,
                           int m, int kdim, int d, float scale,
                           cudaStream_t stream) {
  const int dp = padded_depth(d, mma_k<T>());
  auto kernel = attn_stats_blocks_kernel<T, HasBias>;
  const size_t smem = stats_blocks_smem<T>(dp);
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<n_chunks, kBlkThreads, smem, stream>>>(
      reinterpret_cast<const int4*>(work), block_col,
      static_cast<const unsigned long long*>(masks), starts,
      static_cast<const T*>(q), static_cast<const T*>(k), bias,
      reinterpret_cast<unsigned long long*>(stats), m, kdim, d, dp, scale);
  return static_cast<int>(cudaGetLastError());
}

// bias == nullptr: the instantiation without a bias (K7's softmax).
template <typename T>
int launch_attn_stats_blocks(const int* work, int n_chunks,
                             const int* block_col, const void* masks,
                             const int* starts, const void* q, const void* k,
                             const float* bias, float* stats, int m, int kdim,
                             int d, float scale, cudaStream_t stream) {
  return bias ? launch_stats_blocks_as<T, true>(work, n_chunks, block_col,
                                                masks, starts, q, k, bias,
                                                stats, m, kdim, d, scale,
                                                stream)
              : launch_stats_blocks_as<T, false>(work, n_chunks, block_col,
                                                 masks, starts, q, k, bias,
                                                 stats, m, kdim, d, scale,
                                                 stream);
}

template <typename T, int NT, bool HasBias>
int launch_attn_blocks_nt(const int* work, int n_chunks, const int* block_col,
                          const void* masks, const int* starts, const void* q,
                          const void* k, const float* bias, const float* stats,
                          const void* v, float* y, int m, int kdim, int n,
                          int d, float scale, cudaStream_t stream) {
  const int dp = padded_depth(d, mma_k<T>());
  auto kernel = attn_blocks_kernel<T, NT, HasBias>;
  const size_t smem = chain_blocks_smem<T, NT>(dp);
  if (const int err = allow_smem(kernel, smem)) return err;
  constexpr int NC = 8 * NT;
  const bool vec_v = n % elems16<T>() == 0 &&
                     reinterpret_cast<unsigned long long>(v) % 16 == 0;
  const dim3 grid(n_chunks, (n + NC - 1) / NC);
  kernel<<<grid, kBlkThreads, smem, stream>>>(
      reinterpret_cast<const int4*>(work), block_col,
      static_cast<const unsigned long long*>(masks), starts,
      static_cast<const T*>(q), static_cast<const T*>(k), bias,
      reinterpret_cast<const float2*>(stats), static_cast<const T*>(v), y, m,
      kdim, n, d, dp, scale, vec_v);
  return static_cast<int>(cudaGetLastError());
}

// Output columns a CTA owns: 8, 64, 128 or 256 (then chunks of 256);
// bias == nullptr takes the instantiation without a bias (K8's softmax).
template <typename T, bool HasBias>
int launch_attn_blocks_as(const int* work, int n_chunks, const int* block_col,
                          const void* masks, const int* starts, const void* q,
                          const void* k, const float* bias, const float* stats,
                          const void* v, float* y, int m, int kdim, int n,
                          int d, float scale, cudaStream_t stream) {
#define REPRO_ATTN_BLOCKS(NT)                                                  \
  launch_attn_blocks_nt<T, NT, HasBias>(work, n_chunks, block_col, masks,     \
                                        starts, q, k, bias, stats, v, y, m,   \
                                        kdim, n, d, scale, stream)
  if (n <= 8) return REPRO_ATTN_BLOCKS(1);
  if (n <= 64) return REPRO_ATTN_BLOCKS(8);
  if (n <= 128) return REPRO_ATTN_BLOCKS(16);
  return REPRO_ATTN_BLOCKS(32);
#undef REPRO_ATTN_BLOCKS
}

template <typename T>
int launch_attn_blocks(const int* work, int n_chunks, const int* block_col,
                       const void* masks, const int* starts, const void* q,
                       const void* k, const float* bias, const float* stats,
                       const void* v, float* y, int m, int kdim, int n, int d,
                       float scale, cudaStream_t stream) {
  return bias ? launch_attn_blocks_as<T, true>(work, n_chunks, block_col,
                                               masks, starts, q, k, bias,
                                               stats, v, y, m, kdim, n, d,
                                               scale, stream)
              : launch_attn_blocks_as<T, false>(work, n_chunks, block_col,
                                                masks, starts, q, k, bias,
                                                stats, v, y, m, kdim, n, d,
                                                scale, stream);
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; q: (m, d), k: (K, d), both f32 or both
// bf16, row-major; bias: (n_tiles, tile) f32; stats: (m, 2) f32 of (rm, rs)
// pairs, filled with (-1e30, 0) by the caller.  Returns the cudaError_t of
// the launch.
extern "C" int repro_attn_stats(const int* rows, const int* cols,
                                const void* q, const void* k, int qk_bf16,
                                const float* bias, float* stats, int n_tiles,
                                int tile, int m, int d, float scale,
                                void* stream) {
  return REPRO_DISPATCH_FEATURES(qk_bf16, repro_torch::launch_attn_stats,
                                 rows, cols, q, k, bias, stats, n_tiles, tile,
                                 m, d, scale,
                                 static_cast<cudaStream_t>(stream));
}

// As above, plus stats: (m, 2) f32 as K9 leaves them; v: (K, n) row-major
// f32 or bf16; y: (m, n) f32, zeroed.
extern "C" int repro_attn(const int* rows, const int* cols, const void* q,
                          const void* k, int qk_bf16, const float* bias,
                          const float* stats, const void* v, int v_bf16,
                          float* y, int n_tiles, int tile, int m, int n,
                          int d, float scale, void* stream) {
  return REPRO_DISPATCH_TYPES(qk_bf16, v_bf16, repro_torch::launch_attn,
                              rows, cols, q, k, bias, stats, v, y, n_tiles,
                              tile, m, n, d, scale,
                              static_cast<cudaStream_t>(stream));
}

// The block design.  work: (n_chunks, 4) int32 (row block, first block,
// count, split); block_col: (nb,) int32; masks: (nb·64) 64-bit kept-key
// masks; starts: (nb·64,) int32 slots of the first kept keys; q (m, d), k
// (kdim, d) of one type (0 = f32, 1 = bf16), d ≤ 256 and a multiple of the
// 16-byte load, rows 16-byte aligned; bias: the f32 slab, or NULL for the
// softmax chain without a bias (K7, K8); stats: (m, 2) f32 filled with
// (-1e30, 0) by the caller.
extern "C" int repro_attn_stats_blocks(const int* work, int n_chunks,
                                       const int* block_col, const void* masks,
                                       const int* starts, const void* q,
                                       const void* k, int bf16,
                                       const float* bias, float* stats, int m,
                                       int kdim, int d, float scale,
                                       void* stream) {
  return REPRO_DISPATCH_FEATURES(bf16, repro_torch::launch_attn_stats_blocks,
                                 work, n_chunks, block_col, masks, starts, q,
                                 k, bias, stats, m, kdim, d, scale,
                                 static_cast<cudaStream_t>(stream));
}

// As above, plus stats: (m, 2) f32 as K9 leaves them; v: (kdim, n)
// row-major of q's type; y: (m, n) f32, zeroed.
extern "C" int repro_attn_blocks(const int* work, int n_chunks,
                                 const int* block_col, const void* masks,
                                 const int* starts, const void* q,
                                 const void* k, int bf16, const float* bias,
                                 const float* stats, const void* v, float* y,
                                 int m, int kdim, int n, int d, float scale,
                                 void* stream) {
  return REPRO_DISPATCH_FEATURES(bf16, repro_torch::launch_attn_blocks, work,
                                 n_chunks, block_col, masks, starts, q, k,
                                 bias, stats, v, y, m, kdim, n, d, scale,
                                 static_cast<cudaStream_t>(stream));
}
