// K7 and K8 — the fused SDDMM→transform→SpMM chain over the BalancedCOO
// pattern, in the slot-tile design: y = T(mask(A·Bᵀ)) · X, with T identity,
// α-scale or the masked row softmax of α·e.  The edge scores never reach
// device memory.  (On attention patterns the softmax takes the block design
// of csrc/attention.cu instead.)
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
// balance point.  What the kernels really move is more: every slot gathers a
// feature row of B (and K8 a row of X), as K1 and K6 do, and a scattered
// graph reuses few of them from L2.
//
// The score pass bounds both kernels: each slot gathers a 256-byte B row (d =
// 64 f32), more than L2 holds, so it runs at the rate at which gathers are
// kept in flight.  After it a CTA folds in shared memory and issues no
// loads, so K7 and K8 score two slots a lane group at a time, all loads
// first (score.cuh::for_each_score_unrolled), and cap their registers
// (launch bounds) so that 6 CTAs (K7), 5 (K8, N > 1) or 8 (K8, N = 1) share
// an SM.
//
// Design, K7: one CTA per balanced tile.  The CTA computes its scores into
// shared memory, and folds the tile's row runs with the paper's segmented
// shuffle scan of the online-softmax pair (score.cuh::scan_runs, K9's
// scan).  Every run, and every slot of the scan,
// starts from (max(z, −1e30), exp(z − that)), the reference's floored
// scatter-max: a row of −inf scores gives (−1e30, 0) and weights of 0, not
// NaN.  A run that holds neither the tile's first nor its last slot is a
// whole row, which no other CTA sees; the tile's first and last runs (its
// edge runs) may continue in a neighbouring tile (the Graph500 hub row spans
// ~78 tiles) and are merged into the row's packed 64-bit (rm, rs) with an
// atomicCAS loop (score.cuh::merge_stats), so a row's result does not depend
// on the order in which CTAs merge, up to rounding.  Two modes:
// - full: every row's (rm, rs), interior runs stored (what
//   chain_stats_fused and the unfused chain launch);
// - edge: only the edge runs, merged; interior rows stay (−1e30, 0) and K8
//   folds them itself (what the fused chain launches).  The edge runs are
//   found from the tile's sorted rows alone (a count of the slots equal to
//   the first and to the last row), and only their slots' scores are
//   computed: on a graph whose rows are short beside the tile, a few
//   percent of a full pass; a tile that is one run (a hub row) is all edge.
//
// Design, K8: one CTA per (tile, column block), the paper's equal work per
// CTA.  Step 1 computes the tile's scores once and applies T into shared
// memory.  For softmax with K7's edge statistics, step 2 runs the same scan
// on the scores, each segment's total written back at its last slot, and
// each slot takes its row's (rm, rs) from there (a ballot finds its
// segment's end) — or from K7's statistics for the tile's two edge rows.
// With statistics given (the sharded merge), every row takes them and there
// is no scan; identity and scale need none.  Step 3 accumulates:
// - N = 1: the products w·x[col] run through the same scan with a plain
//   sum: each whole run is one plain store, the edge runs one atomicAdd;
// - N > 1: lane groups own 4 adjacent columns of X a lane (a column block
//   of up to 128), each group a contiguous range of slots; a lane makes one
//   16-byte gather a slot (8 bytes for bf16 X) where N % 4 == 0 and X is
//   aligned, else 4 scalar loads; 4 gathers are issued before the FMAs that
//   use them.  A run that lies wholly in its group's range and is not an
//   edge run is stored once with a plain store; the others add by atomicAdd.
// Above 128 columns each column block's CTA recomputes the scores and the
// scan.  Y must be zeroed by the caller: an empty row receives nothing and
// stays exactly 0, and padding slots (row == M) load nothing.
#include "score.cuh"

namespace repro_torch {

// Slots a lane group scores at once (score.cuh::for_each_score_unrolled)
constexpr int kScoreUnroll = 2;
// X rows a lane gathers back to back in K8's accumulation
constexpr int kChainGathers = 4;
// CTAs an SM must hold, which caps the registers of a thread: K7, K8 at
// N = 1, K8 at N > 1
constexpr int kStatsMinCtas = 6;
constexpr int kScanMinCtas = 8;
constexpr int kAccumMinCtas = 5;

// Byte offset of K8's per-slot run statistics: after the scan's pieces and
// the tile's rows, columns and weights, 8-byte aligned.
__host__ __device__ inline size_t chain_val_offset(int tile) {
  return (scan_pieces_bytes(tile) + static_cast<size_t>(tile) * 3 * sizeof(int) + 7) &
         ~static_cast<size_t>(7);
}

template <typename TA>
__global__ void __launch_bounds__(kChainThreads, kStatsMinCtas)
chain_stats_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                   const TA* __restrict__ a, const TA* __restrict__ b,
                   unsigned long long* __restrict__ stats, int tile, int m,
                   int d, int g, bool vec, float alpha, bool edge) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const int n_chunks = (tile + 31) / 32;
  const ScanPieces<SoftmaxOp> pieces(chain_smem, n_chunks);
  int* s_rows = reinterpret_cast<int*>(chain_smem + scan_pieces_bytes(tile));
  float* s_z = reinterpret_cast<float*>(s_rows + tile);
  const long long base = static_cast<long long>(blockIdx.x) * tile;

  // Scores for the slots [0, lo) and [hi, tile): the whole tile, or in edge
  // mode the first run and the last; the scan skips the chunks between.
  int lo = tile, hi = tile;
  int head_chunks = n_chunks, tail_chunk = n_chunks;
  if (edge) {
    const int first = rows[base], last = rows[base + tile - 1];
    if (first >= m) return;             // a tile of padding
    int n_first = 0, n_last = 0;
    for (int s0 = 0; s0 < tile; s0 += blockDim.x) {
      const int slot = s0 + threadIdx.x;
      const int r = slot < tile ? rows[base + slot] : -1;
      if (slot < tile) s_rows[slot] = r;
      n_first += __syncthreads_count(r == first);
      n_last += __syncthreads_count(r == last);
    }
    if (n_first < tile - n_last) {      // runs lie between the two
      lo = n_first;
      hi = tile - n_last;
      head_chunks = (lo + 31) / 32;
      tail_chunk = hi / 32;
      if (head_chunks >= tail_chunk) head_chunks = tail_chunk = n_chunks;
    }
  }
  // one pass over both ranges: index i < lo is slot i, the rest hi onward
  for_each_score_unrolled<TA, kScoreUnroll>(
      rows, cols, a, b, base, 0, lo + tile - hi, m, d, g, vec,
      [&](int slot, int r, int, bool valid, float e) {
        s_rows[slot] = valid ? r : m;
        s_z[slot] = alpha * e;
      },
      [=](int i) { return i < lo ? i : i - lo + hi; });
  __syncthreads();
  scan_runs<SoftmaxOp, false>(
      s_rows, tile, m, head_chunks, tail_chunk, pieces, nullptr,
      [&](int slot, int) {
        return SoftmaxOp::of(slot < lo || slot >= hi ? s_z[slot] : 0.f);
      },
      [&](int r, float2 v, bool is_edge) {
        if (is_edge)
          merge_stats(&stats[r], v.x, v.y);
        else if (!edge)
          stats[r] = pack_stats(v.x, v.y);
      });
}

// K8's accumulation for N > 1: Y[r, c .. c+3] += w · X[col, c .. c+3] over
// the tile's slots in shared memory.  Groups of `lanes` lanes each walk a
// contiguous range of slots (common.cuh::accumulate_runs, shared with K1's
// sr design and K4); a lane owns 4 adjacent columns of the column block
// blockIdx.y.  A run is stored with a plain store when no other group or CTA
// adds to its row: it is not one of the tile's edge runs and does not cross
// its group's range.
template <typename TX, bool VEC>
__device__ __forceinline__ void accumulate_chain(
    const int* s_rows, const int* s_cols, const float* s_w,
    const TX* __restrict__ x, float* __restrict__ y, int tile, int m, int n,
    int lanes) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / lanes;
  const int group = (threadIdx.x >> 5) * per_warp + lane / lanes;
  const int n_groups = (blockDim.x >> 5) * per_warp;
  const int span = (tile + n_groups - 1) / n_groups;
  const int start = min(group * span, tile);
  const int end = min(start + span, tile);
  const int c = 4 * (blockIdx.y * lanes + lane % lanes);
  if (start == end || c >= n) return;
  const int head = s_rows[0], tail = s_rows[tile - 1];
  const int split_lo = start > 0 && s_rows[start - 1] == s_rows[start] ? s_rows[start] : -1;
  const int split_hi = end < tile && s_rows[end] == s_rows[end - 1] ? s_rows[end - 1] : -1;
  accumulate_runs<TX, VEC, kChainGathers, false>(
      s_rows + start, s_cols + start, s_w + start, end - start,
      end < tile ? s_rows[end] : m, x, m, n, c,
      [&](int r, const float (&acc)[4], int) {
        float* at = y + static_cast<long long>(r) * n + c;
        if (r == head || r == tail || r == split_lo || r == split_hi)
          atomic_add4(at, c, n, acc);
        else
          store4<VEC>(at, c, n, acc);
      });
}

// K8's accumulation paths, one instantiation each: N = 1 through the sum
// scan (few registers: 8 CTAs an SM keep enough gathers in flight), and
// N > 1 by 4-column pieces of X rows, 16-byte or scalar.
enum ChainAccum { kAccumScan, kAccumVec4, kAccumScalar4 };

template <typename TA, typename TX, int ACCUM>
__global__ void __launch_bounds__(kChainThreads,
                                  ACCUM == kAccumScan ? kScanMinCtas : kAccumMinCtas)
chain_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
             const TA* __restrict__ a, const TA* __restrict__ b,
             const float2* __restrict__ stats, const TX* __restrict__ x,
             float* __restrict__ y, int tile, int m, int n, int d, int g,
             bool vec, int transform, bool edge_stats, float alpha,
             int lanes) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const int n_chunks = (tile + 31) / 32;
  int* s_rows = reinterpret_cast<int*>(chain_smem + scan_pieces_bytes(tile));
  int* s_cols = s_rows + tile;
  float* s_w = reinterpret_cast<float*>(s_cols + tile);
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  // Step 1: the weights of identity and scale, and of softmax from given
  // statistics; softmax with edge statistics keeps z = α·e for the scan.
  const bool scan = transform == 2 && edge_stats;
  for_each_score_unrolled<TA, kScoreUnroll>(
      rows, cols, a, b, base, 0, tile, m, d, g, vec,
      [&](int slot, int r, int c, bool valid, float e) {
        float w = 0.f;
        if (valid) {
          if (transform == 0) {
            w = e;
          } else if (transform == 1 || scan) {
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

  // Step 2: each whole run's (rm, rs) from the scan, the edge runs' from K7.
  if (scan) {
    float2* s_val = reinterpret_cast<float2*>(chain_smem + chain_val_offset(tile));
    scan_runs<SoftmaxOp, true>(
        s_rows, tile, m, n_chunks, n_chunks,
        ScanPieces<SoftmaxOp>(chain_smem, n_chunks), s_val,
        [&](int slot, int) { return SoftmaxOp::of(s_w[slot]); },
        [](int, float2, bool) {});
    const int head = s_rows[0], tail = s_rows[tile - 1];
    const int lane = threadIdx.x & 31;
    for (int ch = threadIdx.x >> 5; ch < n_chunks; ch += blockDim.x >> 5) {
      const int slot = ch * 32 + lane;
      const bool in = slot < tile;
      const int r = in ? s_rows[slot] : -1 - lane;
      const int next = __shfl_down_sync(0xffffffffu, r, 1);
      const unsigned ends = __ballot_sync(0xffffffffu, in && (lane == 31 || next != r));
      if (!in) continue;
      float w = 0.f;
      if (r < m) {
        float2 st = s_val[slot + __ffs(ends >> lane) - 1];
        if (r == head || r == tail) st = stats[r];
        w = expf(s_w[slot] - st.x) / fmaxf(st.y, kSoftmaxEps);
      }
      s_w[slot] = w;
    }
    __syncthreads();
  }

  // Step 3: Y += w · X[col].
  if constexpr (ACCUM == kAccumScan) {
    scan_runs<SumOp, false>(
        s_rows, tile, m, n_chunks, n_chunks,
        ScanPieces<SumOp>(chain_smem, n_chunks), nullptr,
        [&](int slot, int r) {
          return r < m ? s_w[slot] * to_f32(x[s_cols[slot]]) : 0.f;
        },
        [&](int r, float v, bool is_edge) {
          if (is_edge)
            atomicAdd(&y[r], v);
          else
            y[r] = v;
        });
  } else {
    accumulate_chain<TX, ACCUM == kAccumVec4>(s_rows, s_cols, s_w, x, y, tile,
                                              m, n, lanes);
  }
}

template <typename TA>
int launch_chain_stats(const int* rows, const int* cols, const void* a,
                       const void* b, float* stats, int n_tiles, int tile,
                       int m, int d, float alpha, bool edge,
                       cudaStream_t stream) {
  const bool vec = score_vec<TA>(a, b, d);
  const int g = score_lanes<TA>(d, vec);
  const size_t smem = scan_pieces_bytes(tile) +
                      static_cast<size_t>(tile) * 2 * sizeof(int);
  chain_stats_kernel<TA><<<n_tiles, kChainThreads, smem, stream>>>(
      rows, cols, static_cast<const TA*>(a), static_cast<const TA*>(b),
      reinterpret_cast<unsigned long long*>(stats), tile, m, d, g, vec, alpha,
      edge);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TX>
int launch_chain(const int* rows, const int* cols, const void* a,
                 const void* b, const float* stats, const void* x, float* y,
                 int n_tiles, int tile, int m, int n, int d, int transform,
                 bool edge_stats, float alpha, cudaStream_t stream) {
  const bool vec = score_vec<TA>(a, b, d);
  const int g = score_lanes<TA>(d, vec);
  // lanes of a group: 4 columns a lane, up to 128 columns a CTA
  const int lanes = lanes_per_row((n + 3) / 4);
  const dim3 grid(n_tiles, (n + 4 * lanes - 1) / (4 * lanes));
  const bool scan = transform == 2 && edge_stats;
  const size_t smem = scan ? chain_val_offset(tile) + static_cast<size_t>(tile) * sizeof(float2)
                           : scan_pieces_bytes(tile) + static_cast<size_t>(tile) * 3 * sizeof(int);
  const auto kernel = n == 1 ? chain_kernel<TA, TX, kAccumScan>
                     : vector_rows<TX>(x, y, n) ? chain_kernel<TA, TX, kAccumVec4>
                                                : chain_kernel<TA, TX, kAccumScalar4>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kChainThreads, smem, stream>>>(
      rows, cols, static_cast<const TA*>(a), static_cast<const TA*>(b),
      reinterpret_cast<const float2*>(stats), static_cast<const TX*>(x), y,
      tile, m, n, d, g, vec, transform, edge_stats, alpha, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; a: (m, d), b: (K, d), both f32 or both
// bf16, row-major; stats: (m, 2) f32 of (rm, rs) pairs, filled with
// (-1e30, 0) by the caller; edge: 0 for every row (full mode), 1 for the
// tiles' edge runs alone (edge mode).  Returns the cudaError_t of the launch.
extern "C" int repro_chain_stats(const int* rows, const int* cols,
                                 const void* a, const void* b, int ab_bf16,
                                 float* stats, int n_tiles, int tile, int m,
                                 int d, float alpha, int edge, void* stream) {
  return REPRO_DISPATCH_FEATURES(ab_bf16, repro_torch::launch_chain_stats,
                                 rows, cols, a, b, stats, n_tiles, tile, m, d,
                                 alpha, edge != 0,
                                 static_cast<cudaStream_t>(stream));
}

// As above, plus stats: (m, 2) f32 (read for transform 2 only: every row's,
// or with edge_stats set the tiles' edge runs' from K7's edge mode); x:
// (K, n) row-major f32 or bf16; y: (m, n) f32, zeroed; transform:
// 0 identity, 1 scale, 2 softmax.
extern "C" int repro_chain(const int* rows, const int* cols, const void* a,
                           const void* b, int ab_bf16, const float* stats,
                           const void* x, int x_bf16, float* y, int n_tiles,
                           int tile, int m, int n, int d, int transform,
                           int edge_stats, float alpha, void* stream) {
  return REPRO_DISPATCH_TYPES(ab_bf16, x_bf16, repro_torch::launch_chain,
                              rows, cols, a, b, stats, x, y, n_tiles, tile, m,
                              n, d, transform, edge_stats != 0, alpha,
                              static_cast<cudaStream_t>(stream));
}
