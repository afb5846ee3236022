// Shared helpers of the port's sparse kernels: element loads that widen
// f32 / bf16 to f32 (one at a time, or four adjacent columns of an X row),
// the dtype dispatch of the plain-C entry points, the lane layout the SpMM
// kernels share and their tile accumulation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Elements of one 16-byte load.
template <typename T>
__host__ __device__ constexpr int elems16() {
  return 16 / static_cast<int>(sizeof(T));
}

// Lanes of a warp that share one nonzero and split its dense row: the
// smallest power of two >= min(n, 32).
inline int lanes_per_row(int n) {
  int vec = 1;
  while (vec < n && vec < 32) vec <<= 1;
  return vec;
}

// Dense columns each lane owns (registers of its accumulator): 1, 2 or 4,
// so one CTA covers up to 128 columns of X per pass.
inline int columns_per_lane(int n) { return n <= 32 ? 1 : (n <= 64 ? 2 : 4); }

// out[0..3] = X[row, c .. c+3] as f32, zero past column n.  VEC: one
// 16-byte (f32) or 8-byte (bf16) load; the caller guarantees c + 3 < n and
// the alignment.
template <typename TX, bool VEC>
__device__ __forceinline__ void load4(const TX* __restrict__ xr, int c, int n,
                                      float out[4]) {
  if constexpr (VEC) {
    if constexpr (std::is_same<TX, float>::value) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + c));
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(xr + c));
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = c + j < n ? to_f32(xr[c + j]) : 0.f;
  }
}

// Whether X rows can be read 4 columns at a time: N % 4 == 0 and X and Y
// aligned to one 4-column piece.
template <typename TX>
bool vector_rows(const void* x, const float* y, int n) {
  return n % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % (4 * sizeof(TX)) == 0 &&
         reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
}

// The nnz-balanced accumulation of one tile staged in shared memory (K1, and
// the slot-tile K10 on its edge weights): Y[r, :] += v · X[c, :] over the tile's slots,
// padding (r >= m) dropped.  Each warp splits into lane groups of `vec`
// lanes; a group walks a contiguous run of slots while its lanes own dense
// columns (column block blockIdx.y, CPL columns a lane), so one X row load is
// one coalesced transaction across the group.  A group carries its running
// row sum in registers and flushes it with atomicAdd when the row id changes.
// Y must be zeroed by the caller.
template <typename TX, int CPL>
__device__ __forceinline__ void accumulate_tile(
    const int* s_rows, const int* s_cols, const float* s_vals,
    const TX* __restrict__ x, float* __restrict__ y, int tile, int m, int n,
    int vec) {
  const int lane = threadIdx.x & 31;
  const int groups_per_warp = 32 / vec;
  const int group = (threadIdx.x >> 5) * groups_per_warp + lane / vec;
  const int n_groups = (blockDim.x >> 5) * groups_per_warp;
  const int chunk = (tile + n_groups - 1) / n_groups;
  const int start = group * chunk;
  const int end = min(start + chunk, tile);
  const int col0 = blockIdx.y * (vec * CPL) + lane % vec;

  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  int cur = -1;
  for (int i = start; i < end; ++i) {
    const int r = s_rows[i];
    if (r >= m) continue;  // padding sentinel
    if (r != cur) {
      if (cur >= 0) {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = col0 + j * vec;
          if (c < n) atomicAdd(&y[static_cast<long long>(cur) * n + c], acc[j]);
          acc[j] = 0.f;
        }
      }
      cur = r;
    }
    const float v = s_vals[i];
    const TX* xr = x + static_cast<long long>(s_cols[i]) * n;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = col0 + j * vec;
      if (c < n) acc[j] += v * to_f32(xr[c]);
    }
  }
  if (cur >= 0) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = col0 + j * vec;
      if (c < n) atomicAdd(&y[static_cast<long long>(cur) * n + c], acc[j]);
    }
  }
}

}  // namespace repro_torch

// FN<TV, TX>(args...) for the (vals, x) element types the flags name:
// 0 = float32, 1 = bfloat16.
#define REPRO_DISPATCH_TYPES(VALS_BF16, X_BF16, FN, ...)                      \
  ((VALS_BF16) ? ((X_BF16) ? FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__)    \
                           : FN<__nv_bfloat16, float>(__VA_ARGS__))           \
               : ((X_BF16) ? FN<float, __nv_bfloat16>(__VA_ARGS__)            \
                           : FN<float, float>(__VA_ARGS__)))
