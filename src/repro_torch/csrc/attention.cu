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
// Bound on H100.  Per slot K9 reads the pattern and the bias (12 B) and does
// 2·d flops for the score; Q and K are read once (4·(M+K)·d B in f32).  At a
// head width of d = 256 that is 512 flops to 12 B, above the f32 balance
// point of 67 TFLOP/s / 3.35 TB/s = 20 flops a byte: K9 is bound by
// operations, and so is K10 at N = 256 (2·(d + N) flops a slot).  At d = N =
// 64 both are bound by bytes.  The kernels run on the CUDA cores; the tensor
// cores, which would lower the operations bound, are later work.  What they
// really move is more: every slot gathers the d-wide rows Q[row] (reused
// along the row's run, from L1) and K[col] (a key row is shared by the ~1k
// queries that attend to it, so mostly from L2), and K10 a V row too.
//
// Design, K9: one CTA per balanced tile.  The CTA computes its tile's z once
// (score.cuh) into shared memory.  Every row of an attention pattern spans
// whole tiles (Gemma's local layer at 8,192 tokens: 1,088 keys a row, 2–3
// rows a tile), so K7's walk of each run by one thread would leave 255 of
// 256 threads idle.  Instead each warp takes 32 consecutive slots and runs
// a segmented inclusive scan of the online-softmax pair (m, s) with
// __shfl_up_sync, a lane combining with the lane `off` below it when both
// hold the same row (rows are sorted within a tile, so equal rows are one
// run).  A segment that touches neither end of its 32 slots is a whole row
// and is stored.  The segments at the ends of each 32-slot chunk go to
// shared memory, and one thread folds those ≤ 2·ceil(T/32) pieces in order:
// a run that holds neither the tile's first nor its last slot is stored,
// the others may continue in a neighbouring tile and are merged into the
// row's packed 64-bit (rm, rs) by atomicCAS (score.cuh::merge_stats), as K7
// does.  Each slot starts from (max(z, −1e30), exp(z − that)), which is the
// reference's scatter-max with a −1e30 floor, so a bias of −inf gives a
// weight of 0 and no NaN.
//
// Design, K10: K8's, with the bias: one CTA per (tile, column block of up
// to 128 columns of V); step 1 computes w for the tile's slots into shared
// memory, step 2 is K1's accumulation (common.cuh::accumulate_tile).  At
// N = 256 each of the two column blocks recomputes the scores.  An empty row
// receives nothing and stays exactly 0.
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
  const int n_chunks = (tile + 31) / 32;
  int* s_rows = smem;                                         // tile
  float* s_z = reinterpret_cast<float*>(s_rows + tile);       // tile
  int* p_row = reinterpret_cast<int*>(s_z + tile);            // 2·n_chunks
  float* p_m = reinterpret_cast<float*>(p_row + 2 * n_chunks);
  float* p_s = p_m + 2 * n_chunks;
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for_each_score<TA>(rows, cols, q, k, base, tile, m, d, g, vec,
                     [&](int slot, int r, int, bool valid, float e) {
                       s_rows[slot] = valid ? r : m;
                       s_z[slot] = valid ? scale * e + bias[base + slot] : 0.f;
                     });
  __syncthreads();

  // Segmented scan of each 32-slot chunk.  Lanes past the tile's end get
  // distinct negative rows, so they join no segment.
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < n_chunks; c += blockDim.x >> 5) {
    const int slot = c * 32 + lane;
    const int last = min(31, tile - 1 - c * 32);
    const bool in = lane <= last;
    const int r = in ? s_rows[slot] : -1 - lane;
    const float z = in ? s_z[slot] : 0.f;
    float mx = fmaxf(z, kSoftmaxNeg);
    float sm = in ? expf(z - mx) : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float om = __shfl_up_sync(0xffffffffu, mx, off);
      const float os = __shfl_up_sync(0xffffffffu, sm, off);
      const int orow = __shfl_up_sync(0xffffffffu, r, off);
      if (lane >= off && orow == r) {
        const float mn = fmaxf(mx, om);
        sm = sm * expf(mx - mn) + os * expf(om - mn);
        mx = mn;
      }
    }
    const int next = __shfl_down_sync(0xffffffffu, r, 1);
    const int first = __shfl_sync(0xffffffffu, r, 0);
    const bool at_end = lane == last;
    if (!in || (!at_end && next == r)) continue;  // not a segment's end
    const bool at_start = r == first;
    if (at_start) {
      p_row[2 * c] = r;
      p_m[2 * c] = mx;
      p_s[2 * c] = sm;
      if (at_end) p_row[2 * c + 1] = -1;  // the chunk is one segment
    } else if (at_end) {
      p_row[2 * c + 1] = r;
      p_m[2 * c + 1] = mx;
      p_s[2 * c + 1] = sm;
    } else if (r < m) {
      stats[r] = pack_stats(mx, sm);
    }
  }
  __syncthreads();

  // Fold the chunks' end pieces in slot order; the tile's first and last
  // runs may continue in another tile and are merged, the others stored.
  if (threadIdx.x == 0) {
    int cur = p_row[0];
    float cm = p_m[0], cs = p_s[0];
    bool head = true;
    for (int i = 1; i < 2 * n_chunks; ++i) {
      const int r = p_row[i];
      if (r < 0) continue;
      if (r == cur) {
        const float mn = fmaxf(cm, p_m[i]);
        cs = cs * expf(cm - mn) + p_s[i] * expf(p_m[i] - mn);
        cm = mn;
        continue;
      }
      if (cur < m) {
        if (head)
          merge_stats(&stats[cur], cm, cs);
        else
          stats[cur] = pack_stats(cm, cs);
      }
      cur = r;
      cm = p_m[i];
      cs = p_s[i];
      head = false;
    }
    if (cur < m) merge_stats(&stats[cur], cm, cs);
  }
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
  const int n_chunks = (tile + 31) / 32;
  const size_t smem = static_cast<size_t>(tile) * 2 * sizeof(int) +
                      static_cast<size_t>(n_chunks) * 2 * 3 * sizeof(int);
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
