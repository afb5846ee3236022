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
