// K3 — row-split SpMM, Y = A·X, on the ELL substrate: the paper's two
// row-split warp kernels, one for each logical kernel.
//
// Replaces the TPU kernel src/repro/kernels/csc.py::_csc_kernel (pallas_call
// in _csc_call), which serves rs_sr and rs_pr alike: stage a (TM, TW) slab of
// ELL cols/vals, walk every slot of it (padding included) doing gather + FMA
// into a (TM, N-block) accumulator, sum over the width.
//
// Bound on H100: bytes.  Each stored entry costs 8 B of ELL and each row 4 B
// of lens against 2·N flops; and each stored entry gathers one row of X.
// That gather is what a one-pass kernel pays: nnz·N·sizeof(X) bytes, which
// only L2 hits keep below device-memory traffic (X is 512 MB at K = 2^20,
// N = 128 against 50 MB of L2).
//
// Both kernels walk only a row's stored slots [0, lens[row]) and add, where
// the row is shorter than the width, 0·X[0, :] once: that is what the
// padding slots (col 0, val 0) add, so an inf or NaN in X's row 0 reaches
// the same rows as in the plain version, and skipping the padding changes
// speed only.  Each output is written once, by one lane, without atomics:
// the result is deterministic.
//
// csc_sr_kernel (rs_sr; the paper's CSC, §2.1.3): a group of G lanes owns a
// row and 4·G adjacent columns, a lane 4 of them, gathered as one 16-byte
// load per stored entry (8 bytes for bf16 X).  A warp stages its rows'
// stored (col, val) pairs in shared memory with coalesced, streaming
// (evict-first) loads, the paper's coalesced sparse-row caching, so the ELL
// stream leaves L2 to X; then each group walks its row's cached pairs 8 at a
// time, all 8 gathers issued before their FMAs.  The column block is the
// grid's slow dimension: with G below what N needs, all rows run against
// one slab of X's columns before the next slab starts (the wrapper's slab
// order, for an X far larger than L2).
//
// csc_pr_kernel (rs_pr; the paper's parallel reduction for SpMM, N small):
// a group of P lanes (8, 16 or 32) owns a row and splits its stored entries;
// each lane gathers whole 4-column pieces of X rows and the group reduces
// with __shfl_xor_sync.
//
// X rows are read 16 (8) bytes at a time only where N % 4 == 0 and X and Y
// are aligned for it; otherwise each lane reads its 4 columns one by one,
// never past the row.
#include "common.cuh"

namespace repro_torch {

constexpr int kCscThreads = 256;
constexpr int kCscWarps = kCscThreads / 32;
// (col, val) pairs a warp stages per round: 8·G slots of each of its 32/G
// rows, each row's slots one word apart from the last row's in the banks
constexpr int kStageSlots = 256;
constexpr int kStagePitch = kStageSlots + 32;
// stored entries a lane gathers back to back
constexpr int kUnroll = 8;

// Y[row, c .. c+3] = acc, after the 0·X[0, c .. c+3] term of a row shorter
// than the width.
template <typename TX, bool VEC>
__device__ __forceinline__ void finish_row(const TX* __restrict__ x,
                                           float* __restrict__ y, float acc[4],
                                           int row, int c, int len, int w,
                                           int n) {
  if (len < w) {
    float x0[4];
    load4<TX, VEC>(x, c, n, x0);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += __fmul_rn(0.f, x0[j]);
  }
  float* yr = y + static_cast<long long>(row) * n;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(yr + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < n) yr[c + j] = acc[j];
  }
}

template <typename TV, typename TX, bool VEC>
__global__ void __launch_bounds__(kCscThreads)
csc_sr_kernel(const int* __restrict__ cols, const TV* __restrict__ vals,
              const int* __restrict__ lens, const TX* __restrict__ x,
              float* __restrict__ y, int m, int w, int n, int g) {
  __shared__ int s_cols[kCscWarps][kStagePitch];
  __shared__ float s_vals[kCscWarps][kStagePitch];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / g;
  const int chunk = kStageSlots / rows_per_warp;   // slots of a row a round
  const int grp = lane / g;
  const int row0 = (blockIdx.x * kCscWarps + warp) * rows_per_warp;
  const int row = row0 + grp;
  const int c = blockIdx.y * (4 * g) + 4 * (lane % g);
  const int len = row < m ? lens[row] : 0;
  const int longest = __reduce_max_sync(0xffffffffu, len);
  const int* sc = s_cols[warp] + grp * (chunk + 1);
  const float* sv = s_vals[warp] + grp * (chunk + 1);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < longest; base += chunk) {
    // stage the warp's rows' stored pairs [base, base + chunk)
    for (int e = lane; e < kStageSlots; e += 32) {
      const int rr = e / chunk;
      const int jj = e - rr * chunk;
      const int rlen = __shfl_sync(0xffffffffu, len, rr * g);
      if (base + jj < rlen) {
        const long long s = static_cast<long long>(row0 + rr) * w + base + jj;
        s_cols[warp][e + rr] = __ldcs(cols + s);
        s_vals[warp][e + rr] = to_f32(__ldcs(vals + s));
      }
    }
    __syncwarp();
    const int cnt = min(chunk, len - base);
    if (c < n) {
      for (int t = 0; t < cnt; t += kUnroll) {
        // a slot past the row repeats the row's last one, so every gather
        // is issued unconditionally, back to back; its product is dropped
        float xv[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          load4<TX, VEC>(x + static_cast<long long>(sc[min(t + u, cnt - 1)]) * n,
                         c, n, xv[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < cnt) {
            const float v = sv[t + u];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = fmaf(v, xv[u][j], acc[j]);
          }
        }
      }
    }
    __syncwarp();
  }
  if (row < m && c < n) finish_row<TX, VEC>(x, y, acc, row, c, len, w, n);
}

template <typename TV, typename TX, bool VEC>
__global__ void __launch_bounds__(kCscThreads)
csc_pr_kernel(const int* __restrict__ cols, const TV* __restrict__ vals,
              const int* __restrict__ lens, const TX* __restrict__ x,
              float* __restrict__ y, int m, int w, int n, int p) {
  const int row = blockIdx.x * (kCscThreads / p) + threadIdx.x / p;
  const int gl = threadIdx.x % p;
  const int c = blockIdx.y * 4;
  const int len = row < m ? lens[row] : 0;
  const long long base = static_cast<long long>(row) * w;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int j = gl; j < len; j += p) {
    const float v = to_f32(__ldcs(vals + base + j));
    float xv[4];
    load4<TX, VEC>(x + static_cast<long long>(__ldcs(cols + base + j)) * n, c, n, xv);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = fmaf(v, xv[q], acc[q]);
  }
  // every lane of the warp takes part; groups never mix (p divides 32)
  for (int off = p >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
  if (row < m && gl == 0) finish_row<TX, VEC>(x, y, acc, row, c, len, w, n);
}

template <typename TV, typename TX>
int launch_csc_sr(const int* cols, const void* vals, const int* lens,
                  const void* x, float* y, int m, int w, int n, int g,
                  cudaStream_t stream) {
  const int rows = kCscWarps * (32 / g);
  const dim3 grid((m + rows - 1) / rows, (n + 4 * g - 1) / (4 * g));
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  if (vector_rows<TX>(x, y, n))
    csc_sr_kernel<TV, TX, true><<<grid, REPRO_LAUNCH_THREADS(kCscThreads), 0, stream>>>(cols, v, lens, xx, y, m, w, n, g);
  else
    csc_sr_kernel<TV, TX, false><<<grid, REPRO_LAUNCH_THREADS(kCscThreads), 0, stream>>>(cols, v, lens, xx, y, m, w, n, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename TV, typename TX>
int launch_csc_pr(const int* cols, const void* vals, const int* lens,
                  const void* x, float* y, int m, int w, int n, int p,
                  cudaStream_t stream) {
  const int rows = kCscThreads / p;
  const dim3 grid((m + rows - 1) / rows, (n + 3) / 4);
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  if (vector_rows<TX>(x, y, n))
    csc_pr_kernel<TV, TX, true><<<grid, REPRO_LAUNCH_THREADS(kCscThreads), 0, stream>>>(cols, v, lens, xx, y, m, w, n, p);
  else
    csc_pr_kernel<TV, TX, false><<<grid, REPRO_LAUNCH_THREADS(kCscThreads), 0, stream>>>(cols, v, lens, xx, y, m, w, n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// cols: (m, w) int32; vals: (m, w) f32 or bf16; lens: (m,) int32 stored
// entries a row; x: (K, n) row-major f32 or bf16; y: (m, n) f32, fully
// written.  g: lanes a row (1, 2, ..., 32), which own 4·g columns of a
// column block.  Returns the launch's cudaError_t.
extern "C" int repro_csc_sr(const int* cols, const void* vals, int vals_bf16,
                            const int* lens, const void* x, int x_bf16,
                            float* y, int m, int w, int n, int g,
                            void* stream) {
  if (g < 1 || g > 32 || (g & (g - 1))) return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16, repro_torch::launch_csc_sr,
                              cols, vals, lens, x, y, m, w, n, g,
                              static_cast<cudaStream_t>(stream));
}

// As repro_csc_sr; p: lanes that split a row's entries (8, 16 or 32); each
// column block holds 4 columns.
extern "C" int repro_csc_pr(const int* cols, const void* vals, int vals_bf16,
                            const int* lens, const void* x, int x_bf16,
                            float* y, int m, int w, int n, int p,
                            void* stream) {
  if (p < 8 || p > 32 || (p & (p - 1))) return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16, repro_torch::launch_csc_pr,
                              cols, vals, lens, x, y, m, w, n, p,
                              static_cast<cudaStream_t>(stream));
}
