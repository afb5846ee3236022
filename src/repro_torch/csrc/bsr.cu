// K11 — block-sparse (BSR) SpMM, Y = A·X, on the BSR substrate.
//
// Replaces the TPU kernel src/repro/kernels/bsr.py::_bsr_kernel (pallas_call
// in _bsr_call): for each block row, the sum over its blocks of the dense
// (bm, bk) block times the (bk, N) slab of X at the block's column, in f32.
//
// Bound on H100: bytes at small N — each stored block is read once (4·bm·bk B
// in f32) for 2·bm·bk·N flops, so below N ≈ 10 the block stream is the cost;
// at N = 128 the f32 multiply-adds are (67 TFLOP/s outside the tensor cores).
//
// Design (not the TPU's): the TPU kernel pads every block row to the widest
// one (block-ELL) and walks a rectangular (Mb, N/TN, WB) grid in order; here
// one CTA owns one block row and one block of C <= 128 columns of X, and
// loops over its own row's blocks straight from indptr — no padding slots,
// and a live value stream needs no re-pad.  The CTA's 256 threads are
// (k-lane, column) pairs: C columns (the smallest power of two >= N, at most
// 128) so a warp's X loads are one coalesced row segment, and L = 256 / C
// k-lanes that split the row's flattened (block, k) range — at N = 1 all 256
// threads stream the row's blocks with coalesced loads.  Each thread keeps
// its bm row sums in registers (RMAX >= bm, so bm <= 64); at the end the
// k-lanes reduce in shared memory and every output element is stored once,
// without atomics.  Block entries are read from global memory: a warp's
// threads of one k-lane read the same entry (a broadcast from L1).  Rows
// past M (the ragged last block row) and k-rows past K (the ragged last
// block column) are masked; a block row without blocks stores zeros.
#include "common.cuh"

namespace repro_torch {

constexpr int kBsrThreads = 256;

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
      const TV* blk = blocks + static_cast<long long>(b) * bm * bk + kk;
#pragma unroll
      for (int j = 0; j < RMAX; ++j)
        if (j < bm) acc[j] += to_f32(blk[j * bk]) * xv;
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
    if (j < bm) {  // uniform across the CTA
      red[threadIdx.x] = acc[j];
      __syncthreads();
      for (int s = n_lanes / 2; s > 0; s >>= 1) {
        if (lane_k < s) red[threadIdx.x] += red[threadIdx.x + s * cols];
        __syncthreads();
      }
      const int row = brow * bm + j;
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
  const dim3 grid(mb, (n + cols - 1) / cols);
  const TV* b = static_cast<const TV*>(blocks);
  const TX* xx = static_cast<const TX*>(x);
  if (bm <= 8)
    bsr_spmm_kernel<TV, TX, 8><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  else if (bm <= 16)
    bsr_spmm_kernel<TV, TX, 16><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  else if (bm <= 32)
    bsr_spmm_kernel<TV, TX, 32><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  else if (bm <= 64)
    bsr_spmm_kernel<TV, TX, 64><<<grid, kBsrThreads, 0, stream>>>(indptr, indices, b, xx, y, bm, bk, m, k, n, cols);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// indptr: (mb+1,) int32; indices: (nblocks,) int32 block columns; blocks:
// (nblocks, bm, bk) f32 or bf16; x: (k, n) row-major f32 or bf16; y: (m, n)
// f32, fully written.  mb = ceil(m / bm), bm <= 64.  Returns the launch's
// cudaError_t.
extern "C" int repro_bsr_spmm(const int* indptr, const int* indices,
                              const void* blocks, int blocks_bf16,
                              const void* x, int x_bf16, float* y, int mb,
                              int bm, int bk, int m, int k, int n,
                              void* stream) {
  return REPRO_DISPATCH_TYPES(blocks_bf16, x_bf16, repro_torch::launch_bsr_spmm,
                              indptr, indices, blocks, x, y, mb, bm, bk, m, k,
                              n, static_cast<cudaStream_t>(stream));
}
