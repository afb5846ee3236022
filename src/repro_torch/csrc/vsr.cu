// K1 — nnz-balanced (VSR) SpMM, Y = A·X, on the BalancedCOO substrate.
//
// Replaces the TPU kernel src/repro/kernels/vsr.py::_vsr_fused_kernel
// (pallas_call in _vsr_fused_call).  What it computes is the same: for every
// stored nonzero (row r, col c, value v) of the (n_tiles, tile) slabs,
// Y[r, :] += v · X[c, :], padding entries (r == m) dropped, f32 accumulation.
//
// Bound on H100: bytes.  Each nonzero reads 12 B of substrate and one dense
// row of X (4·N B in f32, gathered); 2·N flops per nonzero is far below the
// card's ~20 flop/B balance point, so the gather of X rows is the cost.
//
// Design (not the TPU's): one CTA per (tile, column block) — the paper's
// equal-nonzeros-per-warp invariant, so Graph500 hub rows spread over many
// CTAs instead of serialising in one.  The tile's rows/cols/vals are staged
// once into shared memory with coalesced loads.  Each warp splits into lane
// groups of `vec` lanes; a group walks a contiguous run of the tile's
// nonzeros while its lanes own dense columns, so one X[c, :] row load is one
// coalesced transaction across the group (the paper's VDL).  A group carries
// its running row sum in registers and flushes it with atomicAdd when the row
// id changes — the paper's own boundary resolution; the TPU's one-hot MXU
// matmul and sequential-grid block revisit have no place on a GPU, whose CTAs
// run concurrently.  Y must be zeroed by the caller; no allocation here.
#include "common.cuh"

namespace repro_torch {

constexpr int kVsrThreads = 256;

template <typename TV, typename TX, int CPL>
__global__ void __launch_bounds__(kVsrThreads)
vsr_spmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                const TV* __restrict__ vals, const TX* __restrict__ x,
                float* __restrict__ y, int tile, int m, int n, int vec) {
  extern __shared__ int smem[];
  int* s_rows = smem;
  int* s_cols = s_rows + tile;
  float* s_vals = reinterpret_cast<float*>(s_cols + tile);

  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    s_rows[i] = rows[base + i];
    s_cols[i] = cols[base + i];
    s_vals[i] = to_f32(vals[base + i]);
  }
  __syncthreads();

  accumulate_tile<TX, CPL>(s_rows, s_cols, s_vals, x, y, tile, m, n, vec);
}

template <typename TV, typename TX>
int launch_vsr_spmm(const int* rows, const int* cols, const void* vals,
                    const void* x, float* y, int n_tiles, int tile, int m,
                    int n, cudaStream_t stream) {
  const int vec = lanes_per_row(n);
  const int cpl = columns_per_lane(n);
  const dim3 grid(n_tiles, (n + vec * cpl - 1) / (vec * cpl));
  const size_t smem = static_cast<size_t>(tile) * 3 * sizeof(int);
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  if (cpl == 1)
    vsr_spmm_kernel<TV, TX, 1><<<grid, kVsrThreads, smem, stream>>>(rows, cols, v, xx, y, tile, m, n, vec);
  else if (cpl == 2)
    vsr_spmm_kernel<TV, TX, 2><<<grid, kVsrThreads, smem, stream>>>(rows, cols, v, xx, y, tile, m, n, vec);
  else
    vsr_spmm_kernel<TV, TX, 4><<<grid, kVsrThreads, smem, stream>>>(rows, cols, v, xx, y, tile, m, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// K4 — the spill variant of K1, Y's per-tile partials: tile t's row sums go
// to its (win, n) window of the (n_tiles, win, n) partials at row -
// row_base[t] (clamped to the window, as the reference clamps); a segment
// sum outside the kernel combines the windows.  Replaces the TPU kernel
// src/repro/kernels/vsr.py::_vsr_kernel (pallas_call in _vsr_call).
//
// Bound on H100: bytes — K1's, plus the 4·n_tiles·win·n B of partials
// written (at win = 40 and n = 128 that is 20 KB a tile of 512 nonzeros,
// against 6 KB of substrate).
//
// Design: a lane group of `vec` lanes owns one whole tile and walks it in
// order, its lanes owning dense columns (column block blockIdx.y, CPL a
// lane), so one X row load is one coalesced transaction across the group
// (the paper's VDL).  Rows are sorted within a tile, so the group closes each
// (tile, row) run once with a plain store, and stores zeros for the window
// rows it skips: every partial is written exactly once, without atomics,
// and the buffer needs no zeroing.
template <typename TV, typename TX, int CPL>
__global__ void __launch_bounds__(kVsrThreads)
vsr_spmm_spill_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                      const TV* __restrict__ vals, const TX* __restrict__ x,
                      const int* __restrict__ row_base, float* __restrict__ part,
                      int n_tiles, int tile, int m, int n, int win, int vec) {
  const int t = blockIdx.x * (blockDim.x / vec) + threadIdx.x / vec;
  if (t >= n_tiles) return;  // whole groups exit together; no shuffles below
  const int col0 = blockIdx.y * (vec * CPL) + threadIdx.x % vec;
  const long long base = static_cast<long long>(t) * tile;
  const int first = row_base[t];
  float* out = part + static_cast<long long>(t) * win * n;

  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  auto store = [&](int w, bool zero) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = col0 + j * vec;
      if (c < n) out[static_cast<long long>(w) * n + c] = zero ? 0.f : acc[j];
    }
  };
  int cur = -1;   // window row of the open run
  int next = 0;   // first window row not yet stored
  for (int i = 0; i < tile; ++i) {
    const int r = rows[base + i];
    if (r >= m) continue;  // padding sentinel
    const int w = min(max(r - first, 0), win - 1);
    if (w != cur) {
      if (cur >= 0) {
        store(cur, false);
        next = cur + 1;
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
      }
      for (; next < w; ++next) store(next, true);
      cur = w;
    }
    const float v = to_f32(vals[base + i]);
    const TX* xr = x + static_cast<long long>(cols[base + i]) * n;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = col0 + j * vec;
      if (c < n) acc[j] += v * to_f32(xr[c]);
    }
  }
  if (cur >= 0) {
    store(cur, false);
    next = cur + 1;
  }
  for (; next < win; ++next) store(next, true);
}

template <typename TV, typename TX>
int launch_vsr_spmm_spill(const int* rows, const int* cols, const void* vals,
                          const void* x, const int* row_base, float* part,
                          int n_tiles, int tile, int m, int n, int win,
                          cudaStream_t stream) {
  const int vec = lanes_per_row(n);
  const int cpl = columns_per_lane(n);
  const int groups = kVsrThreads / vec;
  const dim3 grid((n_tiles + groups - 1) / groups,
                  (n + vec * cpl - 1) / (vec * cpl));
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  if (cpl == 1)
    vsr_spmm_spill_kernel<TV, TX, 1><<<grid, kVsrThreads, 0, stream>>>(rows, cols, v, xx, row_base, part, n_tiles, tile, m, n, win, vec);
  else if (cpl == 2)
    vsr_spmm_spill_kernel<TV, TX, 2><<<grid, kVsrThreads, 0, stream>>>(rows, cols, v, xx, row_base, part, n_tiles, tile, m, n, win, vec);
  else
    vsr_spmm_spill_kernel<TV, TX, 4><<<grid, kVsrThreads, 0, stream>>>(rows, cols, v, xx, row_base, part, n_tiles, tile, m, n, win, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; vals: (n_tiles, tile) f32 or bf16;
// x: (K, n) row-major f32 or bf16; y: (m, n) f32, zeroed.  Returns the
// cudaError_t of the launch.
extern "C" int repro_vsr_spmm(const int* rows, const int* cols,
                              const void* vals, int vals_bf16, const void* x,
                              int x_bf16, float* y, int n_tiles, int tile,
                              int m, int n, void* stream) {
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16, repro_torch::launch_vsr_spmm,
                              rows, cols, vals, x, y, n_tiles, tile, m, n,
                              static_cast<cudaStream_t>(stream));
}

// K4.  rows/cols/vals and x as for repro_vsr_spmm; row_base: (n_tiles,)
// int32; part: (n_tiles, win, n) f32, fully written.  Returns the launch's
// cudaError_t.
extern "C" int repro_vsr_spmm_spill(const int* rows, const int* cols,
                                    const void* vals, int vals_bf16,
                                    const void* x, int x_bf16,
                                    const int* row_base, float* part,
                                    int n_tiles, int tile, int m, int n,
                                    int win, void* stream) {
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16,
                              repro_torch::launch_vsr_spmm_spill, rows, cols,
                              vals, x, row_base, part, n_tiles, tile, m, n,
                              win, static_cast<cudaStream_t>(stream));
}
