// K3 — CSC (coalesced sparse-row caching) row-split SpMM, Y = A·X, on the
// ELL substrate; one kernel serves both rs_sr and rs_pr.
//
// Replaces the TPU kernel src/repro/kernels/csc.py::_csc_kernel (pallas_call
// in _csc_call): stage a (TM, TW) slab of ELL cols/vals, walk it in order
// doing gather + FMA into a (TM, N-block) accumulator, sum over the width.
//
// Bound on H100: bytes.  8 B of ELL per stored slot (padding included) plus
// one gathered dense row of X per slot, against 2·N flops.
//
// Design: the paper's §2.1.3 as written for a GPU.  A CTA owns TM whole rows
// and one block of dense columns; it stages its rows' (TM, TW) cols/vals slab
// into shared memory with coalesced loads (the paper's one-transaction row
// load), then every thread owns one (row, column) pair and walks the cached
// slab sequentially.  The width loop stays inside the CTA — the TPU kernel's
// sequential W grid axis has no GPU counterpart — so each output element is
// written once, without atomics, and the result is deterministic.
#include "common.cuh"

namespace repro_torch {

constexpr int kCscThreads = 256;

template <typename TV, typename TX, int CPL>
__global__ void __launch_bounds__(kCscThreads)
csc_spmm_kernel(const int* __restrict__ cols, const TV* __restrict__ vals,
                const TX* __restrict__ x, float* __restrict__ y, int m, int w,
                int n, int vec, int tw) {
  extern __shared__ int smem[];
  const int tm = blockDim.x / vec;
  int* s_cols = smem;
  float* s_vals = reinterpret_cast<float*>(s_cols + tm * tw);

  const int ty = threadIdx.x / vec;
  const int row0 = blockIdx.x * tm;
  const int row = row0 + ty;
  const int col0 = blockIdx.y * (vec * CPL) + threadIdx.x % vec;

  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;

  for (int w0 = 0; w0 < w; w0 += tw) {
    const int width = min(tw, w - w0);
    for (int e = threadIdx.x; e < tm * tw; e += blockDim.x) {
      const int rr = row0 + e / tw;
      const int jj = e % tw;
      int c = 0;
      float v = 0.f;
      if (rr < m && jj < width) {
        const long long g = static_cast<long long>(rr) * w + w0 + jj;
        c = cols[g];
        v = to_f32(vals[g]);
      }
      s_cols[e] = c;
      s_vals[e] = v;
    }
    __syncthreads();
    if (row < m) {
      for (int jj = 0; jj < width; ++jj) {
        const float v = s_vals[ty * tw + jj];
        const TX* xr = x + static_cast<long long>(s_cols[ty * tw + jj]) * n;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = col0 + j * vec;
          if (c < n) acc[j] += v * to_f32(xr[c]);
        }
      }
    }
    __syncthreads();
  }
  if (row < m) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = col0 + j * vec;
      if (c < n) y[static_cast<long long>(row) * n + c] = acc[j];
    }
  }
}

template <typename TV, typename TX>
int launch_csc_spmm(const int* cols, const void* vals, const void* x,
                    float* y, int m, int w, int n, cudaStream_t stream) {
  const int vec = lanes_per_row(n);
  const int cpl = columns_per_lane(n);
  const int tm = kCscThreads / vec;
  const int tw = tm <= 128 ? 32 : 16;  // slab stays within 32 KiB
  const dim3 grid((m + tm - 1) / tm, (n + vec * cpl - 1) / (vec * cpl));
  const size_t smem = static_cast<size_t>(tm) * tw * (sizeof(int) + sizeof(float));
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  if (cpl == 1)
    csc_spmm_kernel<TV, TX, 1><<<grid, kCscThreads, smem, stream>>>(cols, v, xx, y, m, w, n, vec, tw);
  else if (cpl == 2)
    csc_spmm_kernel<TV, TX, 2><<<grid, kCscThreads, smem, stream>>>(cols, v, xx, y, m, w, n, vec, tw);
  else
    csc_spmm_kernel<TV, TX, 4><<<grid, kCscThreads, smem, stream>>>(cols, v, xx, y, m, w, n, vec, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// cols: (m, w) int32; vals: (m, w) f32 or bf16; x: (K, n) row-major f32 or
// bf16; y: (m, n) f32, fully written.  Returns the launch's cudaError_t.
extern "C" int repro_csc_spmm(const int* cols, const void* vals, int vals_bf16,
                              const void* x, int x_bf16, float* y, int m,
                              int w, int n, void* stream) {
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16, repro_torch::launch_csc_spmm,
                              cols, vals, x, y, m, w, n,
                              static_cast<cudaStream_t>(stream));
}
