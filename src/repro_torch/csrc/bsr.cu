// K11 — block-sparse (BSR) SpMM, Y = A·X, on the BSR substrate.
//
// Replaces the TPU kernel src/repro/kernels/bsr.py::_bsr_kernel (pallas_call
// in _bsr_call): for each block row, the sum over its blocks of the dense
// (bm, bk) block times the (bk, N) slab of X at the block's column, in f32.
//
// Bound on H100: each stored block is read once (4·bm·bk B in f32) for
// 2·bm·bk·N flops, so the block stream bounds it up to N ≈ 100 in f32 at the
// 3×TF32 tensor-core rate (495 / 3 TFLOP/s), and at every N up to 128 in
// bf16 (989 TFLOP/s).  On a block-pruned Gemma-3-12B FFN weight (14,318
// blocks of 8×128, 58.6 MB in f32) that is 0.0175 ms of bytes, and 0.023 ms
// of operations at N = 128.
//
// Two designs, routed per call by kernels/bsr.py::_design: the tensor-core
// design for bm a multiple of 8 up to 64, bk a multiple of the MMA's depth
// (8 in f32, 16 in bf16), blocks and X of one type and N >= TC_MIN_N; the fma
// design for every other call.
//
// ---------------------------------------------------------------------------
// The fma design, one CTA per (block row, block of up to 128 columns of X),
// on the CUDA cores.  The TPU kernel pads every block row to the widest one
// (block-ELL) and walks a rectangular (Mb, N/TN, WB) grid in order; here the
// CTA loops over its own row's blocks straight from indptr — no padding
// slots, and a live value stream needs no re-pad.  The CTA's 256 threads are
// (k-lane, column) pairs: C columns (the smallest power of two >= N, at most
// 128) so a warp's X loads are one coalesced row segment, and L = 256 / C
// k-lanes that split the row's flattened (block, k) range — at N = 1 all 256
// threads stream the row's blocks with coalesced loads.  Each thread keeps
// its bm row sums in registers (RMAX >= bm, so bm <= 64); at the end the
// k-lanes reduce in shared memory and every output element is stored once,
// without atomics.  Block entries are read from global memory: a warp's
// threads of one k-lane read the same entry (a broadcast from L1).  A block
// of more than 64 rows (Aᵀ's blocks in the backward of a (bm, bk) weight
// with bk > 64: (bk, bm)) is cut into chunks of kBsrChunkRows rows, one a
// CTA (the grid's z), each re-reading its X slab.  Rows
// past M (the ragged last block row) and k-rows past K (the ragged last
// block column) are masked; a block row without blocks stores zeros.  It
// issues about one load per FMA and re-reads each block's X slab from L2
// (938 MB at N = 128 on the Gemma weight), so it is slow from N ≈ 32 on.
//
// ---------------------------------------------------------------------------
// The tensor-core design, one CTA per (group of block rows, tile of NC
// columns of X), on mma.sync.  The host (BsrGroups, built once a plan) cuts
// the block rows into groups of 64 / bm (64 output rows, eight n8 tiles of
// the MMA) and lists, per group, the distinct block columns its rows touch,
// ascending, with each member row's block there (−1 where it has none).
//
// Orientation.  Yᵀ = Xᵀ·Wᵀ per block: N (X's columns) is the MMA's m, the
// block's rows its n (one n8 tile at bm = 8, two at 16, eight at 64), bk its
// k.  A member row without a block at a column issues no MMA for it: no
// zero-filled tile is multiplied, so an inf or NaN in X's slab there never
// reaches that row (the reference's block-ELL padding slots multiply zeros
// by X's block column 0).
//
// Staging.  The CTA walks its group's (column, k-chunk) steps — chunks of
// 128 rows of X (64 in f32 at NC > 32: 256 bytes of a block row) — through
// two shared-memory stages (104 KB at NC = 128 in f32) filled by
// cp.async: the (chunk × NC) slab of X, rows past K and columns past N
// zero-filled, and the chunk's columns of the present members' blocks
// (absent tiles are not copied).  Each X slab is staged once for the whole
// group: on the Gemma weight at N = 128 about 240 groups × 27 columns ×
// 64 KB ≈ 425 MB from L2, against the fma design's 938 MB.  The layout row
// of the next entry is loaded an entry ahead.  One barrier a step: step
// s + 1 is issued after it and lands while step s computes.
//
// Products.  A warp owns one m16 tile of the CTA's columns and all of the
// group's n8 tiles (at NC = 64 half of them, at NC = 32 a quarter, so that
// 8 warps share the group): for every present tile of a step it issues one
// product, so the warps stay balanced however the blocks fall.  f32: the 3×TF32 split
// (m16n8k8; x = hi + lo, lo·hi + hi·lo + hi·hi), since one TF32 pass errs
// by ≈ 2⁻¹¹ relative, over the 1e-4 tolerance; the depth order of a k-step
// is permuted (MMA k = t, t + 4 ↔ depth 2t, 2t + 1) and MMA row g is X's
// column 2g (g + 8 its column 2g + 1), so an A fragment is two 8-byte loads
// and a W fragment one.  An inf or NaN of X keeps only its hi part (its lo
// would be inf − inf = NaN), so a block that holds it gives w·x as the
// reference does.  bf16: m16n8k16, A by ldmatrix.trans from the depth-major
// X slab, f32 accumulation.  Row strides padded by 4 (X in f32), 8 (X in
// bf16) and 8 elements (W) put a fragment load's rows in distinct banks.
//
// Sums stay in registers (8, 4 or 2 tiles × 4 f32 a lane): each step's
// products in the MMA accumulators, added to the running sum by an f32 add
// at the step's end (a sum carried through all of a row's MMAs drifts).
// Each output element is stored once: no shared-memory reduction, no
// atomics.  A group without blocks stores zeros, rows past M and columns
// past N are masked.
#include "mma.cuh"

namespace repro_torch {

constexpr int kBsrThreads = 256;
// rows of a block one CTA sums when the block has more than 64
constexpr int kBsrChunkRows = 16;

template <typename TV, typename TX, int RMAX>
__global__ void __launch_bounds__(kBsrThreads)
bsr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const TV* __restrict__ blocks, const TX* __restrict__ x,
                float* __restrict__ y, int bm, int bk, int m, int k, int n,
                int cols) {
  __shared__ float red[kBsrThreads];
  const int c_local = threadIdx.x % cols;
  const int lane_k = threadIdx.x / cols;
  const int n_lanes = kBsrThreads / cols;
  const int col = blockIdx.y * cols + c_local;
  const bool col_ok = col < n;
  const int brow = blockIdx.x;
  // this CTA's rows of the block: [r0, r0 + rn), all of them unless the
  // block is cut into chunks (bm > 64)
  const int r0 = blockIdx.z * RMAX;
  const int rn = min(RMAX, bm - r0);

  float acc[RMAX];
#pragma unroll
  for (int j = 0; j < RMAX; ++j) acc[j] = 0.f;

  // this k-lane's entries of the flattened (block b, k-row kk) range
  const int end = indptr[brow + 1];
  int b = indptr[brow] + lane_k / bk;
  int kk = lane_k % bk;
  while (b < end) {
    const int krow = indices[b] * bk + kk;
    if (krow < k && col_ok) {
      const float xv = to_f32(x[static_cast<long long>(krow) * n + col]);
      const TV* blk = blocks + (static_cast<long long>(b) * bm + r0) * bk + kk;
#pragma unroll
      for (int j = 0; j < RMAX; ++j)
        if (j < rn) acc[j] += to_f32(blk[j * bk]) * xv;
    }
    kk += n_lanes;
    if (kk >= bk) {
      b += kk / bk;
      kk %= bk;
    }
  }

  // reduce each row's sums over the k-lanes, one row at a time
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    if (j < rn) {  // uniform across the CTA
      red[threadIdx.x] = acc[j];
      __syncthreads();
      for (int s = n_lanes / 2; s > 0; s >>= 1) {
        if (lane_k < s) red[threadIdx.x] += red[threadIdx.x + s * cols];
        __syncthreads();
      }
      const int row = brow * bm + r0 + j;
      if (lane_k == 0 && col_ok && row < m)
        y[static_cast<long long>(row) * n + col] = red[c_local];
      __syncthreads();
    }
  }
}

template <typename TV, typename TX>
int launch_bsr_spmm(const int* indptr, const int* indices, const void* blocks,
                    const void* x, float* y, int mb, int bm, int bk, int m,
                    int k, int n, cudaStream_t stream) {
  int cols = 1;
  while (cols < n && cols < 128) cols <<= 1;
  const dim3 grid(mb, (n + cols - 1) / cols,
                  bm <= 64 ? 1 : (bm + kBsrChunkRows - 1) / kBsrChunkRows);
  const TV* b = static_cast<const TV*>(blocks);
  const TX* xx = static_cast<const TX*>(x);
  if (bm > 64)
    bsr_spmm_kernel<TV, TX, kBsrChunkRows><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  else if (bm <= 8)
    bsr_spmm_kernel<TV, TX, 8><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  else if (bm <= 16)
    bsr_spmm_kernel<TV, TX, 16><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  else if (bm <= 32)
    bsr_spmm_kernel<TV, TX, 32><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  else
    bsr_spmm_kernel<TV, TX, 64><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  return static_cast<int>(cudaGetLastError());
}


// ===========================================================================
// The tensor-core design.
// ===========================================================================

constexpr int kGroupRows = 64;                // output rows of a group
constexpr int kGroupTiles = kGroupRows / 8;   // its n8 tiles
constexpr int kTcRing = 2;                    // stages of the cp.async ring

// Rows of X (depth) a step stages: 128 (256 bytes of an f32 block row, 512
// when the CTA owns 32 columns and a step's products are few) or 64.
template <typename T, int NC>
__host__ __device__ constexpr int tc_chunk() {
  return sizeof(T) == 4 && NC > 32 ? 64 : 128;
}
// Row strides of the staged X and W tiles, in elements.
template <typename T, int NC>
__host__ __device__ constexpr int tc_xs() { return NC + (sizeof(T) == 4 ? 4 : 8); }
template <typename T, int NC>
__host__ __device__ constexpr int tc_ws() { return tc_chunk<T, NC>() + 8; }
// Elements of one stage: the X slab, then the group's W rows.
template <typename T, int NC>
__host__ __device__ constexpr int tc_stage() {
  return tc_chunk<T, NC>() * tc_xs<T, NC>() + kGroupRows * tc_ws<T, NC>();
}
template <typename T, int NC>
size_t tc_smem() {
  return kTcRing * (static_cast<size_t>(tc_stage<T, NC>()) * sizeof(T) +
                    sizeof(int));
}

// The 3×TF32 split x ≈ hi + lo without a conversion instruction: hi is x
// rounded to TF32 (half a TF32 ulp added to the bits, which carries into the
// exponent where it must, then the 13 low mantissa bits cleared), lo = x − hi
// is exact in f32 and the MMA reads its top 10 mantissa bits, which keeps a
// product to ≈ 2⁻²¹.  Two integer operations and a subtraction in place of
// mma.cuh's two cvt.rna.tf32.f32.
__device__ __forceinline__ void split_tf32_int(float x, unsigned& hi,
                                               unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The split of an X element, with a middle part for the hi·lo term: an inf
// or NaN keeps only hi (mid = lo = 0), so its products stay w·x.
__device__ __forceinline__ void split_x(float v, unsigned& hi, unsigned& mid,
                                        unsigned& lo) {
  split_tf32_int(v, hi, lo);
  const bool bad = nonfinite(v);
  mid = bad ? 0u : hi;
  lo = bad ? 0u : lo;
}

// The layout row of one entry: its block column and the first W row of
// each n8 tile of the group there (−1: absent).
struct TcEntry {
  int col;
  int4 rows[kGroupTiles / 4];
};

__device__ __forceinline__ TcEntry load_entry(const int* __restrict__ gcol,
                                              const int* __restrict__ gtile,
                                              int e) {
  const int4* rows = reinterpret_cast<const int4*>(gtile) + e * (kGroupTiles / 4);
  TcEntry en;
  en.col = __ldg(gcol + e);
#pragma unroll
  for (int i = 0; i < kGroupTiles / 4; ++i) en.rows[i] = __ldg(rows + i);
  return en;
}

// Stage one step: k-chunk kc of entry `en`.  X rows past K and columns past
// N are zero-filled; of W, only the tiles present at the column are copied
// (W row wr[j] on into rows 8j .. 8j + 7), and *present gets bit j for each.
template <typename T, int NC, int THREADS>
__device__ __forceinline__ void tc_stage_step(
    T* sx, unsigned* present, const TcEntry& en, const T* __restrict__ blocks,
    const T* __restrict__ x, int kc, int bk, int k, int n, int c0,
    bool vec_x) {
  constexpr int KC = tc_chunk<T, NC>(), XS = tc_xs<T, NC>();
  constexpr int WS = tc_ws<T, NC>();
  constexpr int E = elems16<T>(), kPerRow = KC / E;
  const int klen = min(KC, bk - kc);
  int wr[kGroupTiles];
#pragma unroll
  for (int i = 0; i < kGroupTiles / 4; ++i) {
    wr[4 * i] = en.rows[i].x;
    wr[4 * i + 1] = en.rows[i].y;
    wr[4 * i + 2] = en.rows[i].z;
    wr[4 * i + 3] = en.rows[i].w;
  }
  stage_tile(sx, XS, x, n, en.col * bk + kc, k, c0, n, klen, NC, vec_x);
  T* sw = sx + KC * XS;
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kGroupTiles; ++j) {
    if (wr[j] < 0) continue;                    // uniform across the CTA
    bits |= 1u << j;
    for (int i = threadIdx.x; i < 8 * kPerRow; i += THREADS) {
      const int r = i / kPerRow, c = (i % kPerRow) * E;
      if (c >= klen) continue;
      const T* src = blocks + static_cast<long long>(wr[j] + r) * bk + kc + c;
      cp_async16(sw + (j * 8 + r) * WS + c, src, true);
    }
  }
  if (threadIdx.x == 0) *present = bits;
}

// The products of one staged step for a warp that owns the m16 tile at
// column m0 of the CTA's X and the TPW n8 tiles from j0 on: for each
// k-step, the A fragment of X (the next k-step's loaded ahead), then one
// product for every present tile.  f32: MMA row g is X's column m0 + 2g and
// row g + 8 its column m0 + 2g + 1, so a lane's A fragment is two 8-byte
// loads.
template <int NC, int TPW>
__device__ __forceinline__ void tc_compute_step(float (&acc)[TPW][4],
                                                const float* sx,
                                                unsigned present, int ksteps,
                                                int m0, int j0) {
  constexpr int KC = tc_chunk<float, NC>(), XS = tc_xs<float, NC>();
  constexpr int WS = tc_ws<float, NC>(), KS = KC / 8;
  const float* sw = sx + KC * XS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned mine = present >> j0;
  // this step's products, added to acc once at its end: the tensor cores'
  // accumulation keeps fewer bits than an f32 add, and a sum carried
  // through every MMA of a long row drifts
  float part[TPW][4];
#pragma unroll
  for (int jj = 0; jj < TPW; ++jj)
    if (mine & (1u << jj))
#pragma unroll
      for (int i = 0; i < 4; ++i) part[jj][i] = 0.f;
  const float* px = sx + 2 * t * XS + m0 + 2 * g;
  float2 v0 = *reinterpret_cast<const float2*>(px);
  float2 v1 = *reinterpret_cast<const float2*>(px + XS);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks >= ksteps) break;
    const int k0 = ks * 8;
    unsigned ah[4], am[4], al[4];
    split_x(v0.x, ah[0], am[0], al[0]);
    split_x(v0.y, ah[1], am[1], al[1]);
    split_x(v1.x, ah[2], am[2], al[2]);
    split_x(v1.y, ah[3], am[3], al[3]);
    if (ks + 1 < KS) {
      v0 = *reinterpret_cast<const float2*>(px + (k0 + 8) * XS);
      v1 = *reinterpret_cast<const float2*>(px + (k0 + 9) * XS);
    }
#pragma unroll
    for (int jj = 0; jj < TPW; ++jj) {
      if (!(mine & (1u << jj))) continue;   // uniform across the CTA
      const float2 w = *reinterpret_cast<const float2*>(
          sw + ((j0 + jj) * 8 + g) * WS + k0 + 2 * t);
      unsigned bh[2], bl[2];
      split_tf32_int(w.x, bh[0], bl[0]);
      split_tf32_int(w.y, bh[1], bl[1]);
      mma_tf32(part[jj], al, bh);
      mma_tf32(part[jj], am, bl);
      mma_tf32(part[jj], ah, bh);
    }
  }
#pragma unroll
  for (int jj = 0; jj < TPW; ++jj)
    if (mine & (1u << jj))
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[jj][i] += part[jj][i];
}

template <int NC, int TPW>
__device__ __forceinline__ void tc_compute_step(float (&acc)[TPW][4],
                                                const __nv_bfloat16* sx,
                                                unsigned present, int ksteps,
                                                int m0, int j0) {
  constexpr int KC = tc_chunk<__nv_bfloat16, NC>();
  constexpr int XS = tc_xs<__nv_bfloat16, NC>();
  constexpr int WS = tc_ws<__nv_bfloat16, NC>(), KS = KC / 16;
  const __nv_bfloat16* sw = sx + KC * XS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned mine = present >> j0;
  const __nv_bfloat16* px =
      sx + ((lane >> 4) * 8 + (lane & 7)) * XS + m0 + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks >= ksteps) break;
    const int k0 = ks * 16;
    unsigned a[4];
    ldmatrix_x4_trans(a, px + k0 * XS);
#pragma unroll
    for (int jj = 0; jj < TPW; ++jj) {
      if (!(mine & (1u << jj))) continue;   // uniform across the CTA
      const __nv_bfloat16* p = sw + ((j0 + jj) * 8 + g) * WS + k0 + 2 * t;
      const unsigned b[2] = {*reinterpret_cast<const unsigned*>(p),
                             *reinterpret_cast<const unsigned*>(p + 8)};
      mma_bf16(acc[jj], a, b);
    }
  }
}

// gptr: (n_groups + 1,) entries of each group; gcol: (n_entries,) block
// column of each entry; gtile: (n_entries, 8) the first row, in the
// (nblocks·bm, bk) block array, of each n8 tile of the group's rows at that
// column, −1 where the row has no block; a group spans group_rows output
// rows.  A CTA owns MTILES m16 tiles of X's columns; its warps are (m16
// tile, share of the eight n8 tiles) pairs, TH shares.  blockIdx.x is the
// column tile, blockIdx.y the group, so the CTAs of one group run together
// and share its blocks in L2.
template <typename T, int MTILES, int TH>
__global__ void __launch_bounds__(MTILES * TH * 32)
bsr_tc_kernel(const int* __restrict__ gptr, const int* __restrict__ gcol,
              const int* __restrict__ gtile, const T* __restrict__ blocks,
              const T* __restrict__ x, float* __restrict__ y, int group_rows,
              int bk, int m, int k, int n, bool vec_x) {
  constexpr int NC = MTILES * 16, THREADS = MTILES * TH * 32;
  constexpr int TPW = kGroupTiles / TH;
  constexpr int KC = tc_chunk<T, NC>(), STAGE = tc_stage<T, NC>();
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  T* const sbuf = reinterpret_cast<T*>(tc_smem_raw);
  unsigned* const spresent = reinterpret_cast<unsigned*>(sbuf + kTcRing * STAGE);

  const int group = blockIdx.y, c0 = blockIdx.x * NC;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp % MTILES) * 16, j0 = (warp / MTILES) * TPW;
  const int e0 = gptr[group], e1 = gptr[group + 1];
  const int nq = (bk + KC - 1) / KC;
  const int steps = (e1 - e0) * nq;

  float acc[TPW][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // step s is (entry e0 + s / nq, k-chunk s % nq); the entry being staged
  // and the next one are held in registers, the next loaded an entry ahead
  int se = e0, sq = 0;
  TcEntry cur{}, nxt{};
  if (e0 < e1) cur = load_entry(gcol, gtile, e0);
  if (e0 + 1 < e1) nxt = load_entry(gcol, gtile, e0 + 1);
  auto stage_next = [&](int s) {
    tc_stage_step<T, NC, THREADS>(sbuf + (s % kTcRing) * STAGE,
                                  spresent + s % kTcRing, cur, blocks, x,
                                  sq * KC, bk, k, n, c0, vec_x);
    if (++sq == nq) {
      sq = 0;
      ++se;
      cur = nxt;
      if (se + 1 < e1) nxt = load_entry(gcol, gtile, se + 1);
    }
  };
#pragma unroll
  for (int s = 0; s < kTcRing - 1; ++s) {
    if (s < steps) stage_next(s);
    cp_async_commit();
  }
  int cq = 0;  // the k-chunk of step s
  for (int s = 0; s < steps; ++s) {
    // step s has landed for this thread; the barrier publishes it to all
    // and frees the slot step s − 1 used, which step s + 1 refills
    cp_async_wait<kTcRing - 2>();
    __syncthreads();
    if (s + kTcRing - 1 < steps) stage_next(s + kTcRing - 1);
    cp_async_commit();
    const int slot = s % kTcRing;
    const int ksteps = min(KC, bk - cq * KC) / mma_k<T>();
    tc_compute_step<NC, TPW>(acc, sbuf + slot * STAGE, spresent[slot],
                             ksteps, m0, j0);
    if (++cq == nq) cq = 0;
  }

  // C fragment: (m g, n 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), n
  // a row of the group, m a column of X (and of Y): m0 + g and m0 + g + 8,
  // or in f32 m0 + 2g and m0 + 2g + 1
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = group * group_rows + j0 * 8;
  constexpr bool kPaired = sizeof(T) == 4;
  const int col = c0 + m0 + (kPaired ? 2 * g : g);
#pragma unroll
  for (int jj = 0; jj < TPW; ++jj) {
    if ((j0 + jj) * 8 >= group_rows) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + jj * 8 + 2 * t + (i & 1);
      const int c = col + (i >> 1) * (kPaired ? 1 : 8);
      if (r < m && c < n)
        y[static_cast<long long>(r) * n + c] = acc[jj][i];
    }
  }
}

template <typename T, int MTILES, int TH>
int launch_bsr_tc_as(const int* gptr, const int* gcol, const int* gtile,
                     int n_groups, int group_rows, const void* blocks,
                     const void* x, float* y, int bk, int m, int k, int n,
                     cudaStream_t stream) {
  constexpr int NC = MTILES * 16;
  auto kernel = bsr_tc_kernel<T, MTILES, TH>;
  const size_t smem = tc_smem<T, NC>();
  if (const int err = allow_smem(kernel, smem)) return err;
  const bool vec_x = n % elems16<T>() == 0 &&
                     reinterpret_cast<unsigned long long>(x) % 16 == 0;
  const dim3 grid((n + NC - 1) / NC, n_groups);
  kernel<<<grid, MTILES * TH * 32, smem, stream>>>(
      gptr, gcol, gtile, static_cast<const T*>(blocks),
      static_cast<const T*>(x), y, group_rows, bk, m, k, n, vec_x);
  return static_cast<int>(cudaGetLastError());
}

// ncols: the columns of X a CTA owns, 32, 64 or 128 (one m16 tile a warp);
// at 64 two warps share each m16 tile's eight n8 tiles, at 32 four.
template <typename T>
int launch_bsr_tc(const int* gptr, const int* gcol, const int* gtile,
                  int n_groups, int group_rows, const void* blocks,
                  const void* x, float* y, int bm, int bk, int m, int k,
                  int n, int ncols, cudaStream_t stream) {
  if (bm % 8 != 0 || group_rows % bm != 0 || group_rows > kGroupRows ||
      bk % mma_k<T>() != 0 ||
      reinterpret_cast<unsigned long long>(blocks) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_BSR_TC(MTILES, TH)                                              \
  launch_bsr_tc_as<T, MTILES, TH>(gptr, gcol, gtile, n_groups, group_rows,    \
                                  blocks, x, y, bk, m, k, n, stream)
  switch (ncols) {
    case 32: return REPRO_BSR_TC(2, 4);
    case 64: return REPRO_BSR_TC(4, 2);
    case 128: return REPRO_BSR_TC(8, 1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BSR_TC
}

}  // namespace repro_torch

// indptr: (mb+1,) int32; indices: (nblocks,) int32 block columns; blocks:
// (nblocks, bm, bk) f32 or bf16; x: (k, n) row-major f32 or bf16; y: (m, n)
// f32, fully written.  mb = ceil(m / bm); bm > 64 is cut into chunks of
// kBsrChunkRows rows.  Returns the launch's cudaError_t.
extern "C" int repro_bsr_spmm(const int* indptr, const int* indices,
                              const void* blocks, int blocks_bf16,
                              const void* x, int x_bf16, float* y, int mb,
                              int bm, int bk, int m, int k, int n,
                              void* stream) {
  return REPRO_DISPATCH_TYPES(blocks_bf16, x_bf16, repro_torch::launch_bsr_spmm,
                              indptr, indices, blocks, x, y, mb, bm, bk, m, k,
                              n, static_cast<cudaStream_t>(stream));
}

// The tensor-core design.  gptr / gcol / gtile: the group layout (see
// bsr_tc_kernel), group_rows = 64 / bm · bm output rows a group; blocks and
// x of one type (bf16 = 1 for bfloat16), blocks 16-byte aligned, bm a
// multiple of 8, bk of the MMA's depth (8 in f32, 16 in bf16); y: (m, n)
// f32, fully written; ncols
// 32, 64 or 128.  Returns the launch's cudaError_t.
extern "C" int repro_bsr_spmm_tc(const int* gptr, const int* gcol,
                                 const int* gtile, int n_groups,
                                 int group_rows, const void* blocks,
                                 const void* x, int bf16, float* y, int bm,
                                 int bk, int m, int k, int n, int ncols,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? repro_torch::launch_bsr_tc<__nv_bfloat16>(
                    gptr, gcol, gtile, n_groups, group_rows, blocks, x, y,
                    bm, bk, m, k, n, ncols, s)
              : repro_torch::launch_bsr_tc<float>(
                    gptr, gcol, gtile, n_groups, group_rows, blocks, x, y,
                    bm, bk, m, k, n, ncols, s);
}
