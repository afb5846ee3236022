// K7 and K8 — the fused SDDMM→transform→SpMM chain over the BalancedCOO
// pattern: y = T(mask(A·Bᵀ)) · X, with T identity, α-scale or the masked row
// softmax of α·e.  The edge scores never reach device memory.
//
// K7 replaces the TPU kernel src/repro/kernels/fused_chain.py::
// _chain_stats_kernel (pallas_call in _chain_stats_call): the softmax's row
// max rm and sum of exp(α·e − rm), empty rows left at (−1e30, 0).  The TPU
// folds (max, sum) across consecutive visits of one output block on its
// sequential grid; here the port's output is one packed (rm, rs) pair per row
// and the CTAs of a row's tiles run at once, in no order.
//
// K8 replaces src/repro/kernels/fused_chain.py::_chain_kernel (pallas_call in
// _chain_apply_call): recompute the scores, apply T, accumulate w·X[col] into
// Y[row].  The TPU's one-hot MXU reduction into revisited (wb, tile_n) blocks
// is not carried over.
//
// Bound on H100: bytes.  K7 reads the pattern, A and B once and writes 8 B a
// row; K8 reads the pattern, A, B, the stats and X once and writes Y.  Flops,
// 2·d a slot for the score and 2·N for the product, stay far below the
// balance point.  Both kernels really gather a feature row of B (and of X in
// K8) per slot, as K1 and K6 do.
//
// Design, K7: one CTA per balanced tile.  The CTA computes its tile's scores
// once (score.cuh) into shared memory, then each thread that finds the start
// of a run of equal rows folds that run with the online-softmax update
// (one exp a slot) into a partial (m_t, s_t).  A run that touches neither end
// of the tile is a whole row, which no other CTA sees: it is stored.  A run at
// either end may continue in a neighbouring tile (the Graph500 hub row spans
// ~78 tiles): it is merged into the row's packed 64-bit (rm, rs) with an
// atomicCAS loop on m' = max(m, m_t), s' = s·e^(m−m') + s_t·e^(m_t−m').  So
// only the two boundary runs of a tile contend, and a row's result does not
// depend on the order in which CTAs merge, up to rounding.  Chosen over a
// boundary-partials array plus a fix-up launch: one launch, no scratch.
//
// Design, K8: one CTA per (tile, column block of up to 128 columns of X), like
// K1, so the paper's equal-work-per-CTA rule carries over.  Step 1 computes
// the tile's scores once and applies T (softmax reads the rm/rs K7 wrote
// earlier on the same stream), leaving w in shared memory (T floats) beside
// the tile's rows and columns; padding slots get weight 0 and row m.  Step 2
// is K1's accumulation (common.cuh) with w as the values: lanes own columns
// of X, row runs flush by atomicAdd into a zeroed Y.  Above N = 128 each
// column block's CTA recomputes the tile's scores, as the TPU recomputes per
// tile_n block: d·2 flops and one B row a slot more per extra block.  An empty
// row receives nothing and stays exactly 0.
#include "score.cuh"

namespace repro_torch {

template <typename TA>
__global__ void __launch_bounds__(kChainThreads)
chain_stats_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                   const TA* __restrict__ a, const TA* __restrict__ b,
                   unsigned long long* __restrict__ stats, int tile, int m,
                   int d, int g, bool vec, float alpha) {
  extern __shared__ int smem[];
  int* s_rows = smem;
  float* s_z = reinterpret_cast<float*>(s_rows + tile);
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for_each_score<TA>(rows, cols, a, b, base, tile, m, d, g, vec,
                     [&](int slot, int r, int, bool valid, float e) {
                       s_rows[slot] = valid ? r : m;
                       s_z[slot] = alpha * e;
                     });
  __syncthreads();
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = s_rows[i];
    if (r >= m || (i > 0 && s_rows[i - 1] == r)) continue;  // not a run start
    float mx = s_z[i];
    float sum = 1.f;
    int j = i + 1;
    for (; j < tile && s_rows[j] == r; ++j) {
      const float z = s_z[j];
      if (z > mx) {
        sum = sum * expf(mx - z) + 1.f;
        mx = z;
      } else {
        sum += expf(z - mx);
      }
    }
    if (i == 0 || j == tile)
      merge_stats(&stats[r], mx, sum);
    else
      stats[r] = pack_stats(mx, sum);
  }
}

template <typename TA, typename TX, int CPL>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
             const TA* __restrict__ a, const TA* __restrict__ b,
             const float2* __restrict__ stats, const TX* __restrict__ x,
             float* __restrict__ y, int tile, int m, int n, int d, int g,
             bool vec, int transform, float alpha, int lanes_n) {
  extern __shared__ int smem[];
  int* s_rows = smem;
  int* s_cols = s_rows + tile;
  float* s_w = reinterpret_cast<float*>(s_cols + tile);
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for_each_score<TA>(
      rows, cols, a, b, base, tile, m, d, g, vec,
      [&](int slot, int r, int c, bool valid, float e) {
        float w = 0.f;
        if (valid) {
          if (transform == 0) {
            w = e;
          } else if (transform == 1) {
            w = alpha * e;
          } else {
            const float2 st = stats[r];
            w = expf(alpha * e - st.x) / fmaxf(st.y, kSoftmaxEps);
          }
        }
        s_rows[slot] = valid ? r : m;
        s_cols[slot] = c;
        s_w[slot] = w;
      });
  __syncthreads();
  accumulate_tile<TX, CPL>(s_rows, s_cols, s_w, x, y, tile, m, n, lanes_n);
}

template <typename TA>
int launch_chain_stats(const int* rows, const int* cols, const void* a,
                       const void* b, float* stats, int n_tiles, int tile,
                       int m, int d, float alpha, cudaStream_t stream) {
  const bool vec = score_vec<TA>(a, b, d);
  const int g = score_lanes<TA>(d, vec);
  const size_t smem = static_cast<size_t>(tile) * 2 * sizeof(int);
  chain_stats_kernel<TA><<<n_tiles, kChainThreads, smem, stream>>>(
      rows, cols, static_cast<const TA*>(a), static_cast<const TA*>(b),
      reinterpret_cast<unsigned long long*>(stats), tile, m, d, g, vec, alpha);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TX>
int launch_chain(const int* rows, const int* cols, const void* a,
                 const void* b, const float* stats, const void* x, float* y,
                 int n_tiles, int tile, int m, int n, int d, int transform,
                 float alpha, cudaStream_t stream) {
  const bool vec = score_vec<TA>(a, b, d);
  const int g = score_lanes<TA>(d, vec);
  const int lanes_n = lanes_per_row(n);
  const int cpl = columns_per_lane(n);
  const dim3 grid(n_tiles, (n + lanes_n * cpl - 1) / (lanes_n * cpl));
  const size_t smem = static_cast<size_t>(tile) * 3 * sizeof(int);
  const TA* aa = static_cast<const TA*>(a);
  const TA* bb = static_cast<const TA*>(b);
  const float2* st = reinterpret_cast<const float2*>(stats);
  const TX* xx = static_cast<const TX*>(x);
  if (cpl == 1)
    chain_kernel<TA, TX, 1><<<grid, kChainThreads, smem, stream>>>(
        rows, cols, aa, bb, st, xx, y, tile, m, n, d, g, vec, transform, alpha, lanes_n);
  else if (cpl == 2)
    chain_kernel<TA, TX, 2><<<grid, kChainThreads, smem, stream>>>(
        rows, cols, aa, bb, st, xx, y, tile, m, n, d, g, vec, transform, alpha, lanes_n);
  else
    chain_kernel<TA, TX, 4><<<grid, kChainThreads, smem, stream>>>(
        rows, cols, aa, bb, st, xx, y, tile, m, n, d, g, vec, transform, alpha, lanes_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; a: (m, d), b: (K, d), both f32 or both
// bf16, row-major; stats: (m, 2) f32 of (rm, rs) pairs, filled with
// (-1e30, 0) by the caller.  Returns the cudaError_t of the launch.
extern "C" int repro_chain_stats(const int* rows, const int* cols,
                                 const void* a, const void* b, int ab_bf16,
                                 float* stats, int n_tiles, int tile, int m,
                                 int d, float alpha, void* stream) {
  return REPRO_DISPATCH_FEATURES(ab_bf16, repro_torch::launch_chain_stats,
                                 rows, cols, a, b, stats, n_tiles, tile, m, d,
                                 alpha, static_cast<cudaStream_t>(stream));
}

// As above, plus stats: (m, 2) f32 (read for transform 2 only); x: (K, n)
// row-major f32 or bf16; y: (m, n) f32, zeroed; transform: 0 identity,
// 1 scale, 2 softmax.
extern "C" int repro_chain(const int* rows, const int* cols, const void* a,
                           const void* b, int ab_bf16, const float* stats,
                           const void* x, int x_bf16, float* y, int n_tiles,
                           int tile, int m, int n, int d, int transform,
                           float alpha, void* stream) {
  return REPRO_DISPATCH_TYPES(ab_bf16, x_bf16, repro_torch::launch_chain,
                              rows, cols, a, b, stats, x, y, n_tiles, tile, m,
                              n, d, transform, alpha,
                              static_cast<cudaStream_t>(stream));
}
