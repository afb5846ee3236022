// Shared helpers of the port's sparse kernels: element loads that widen
// f32 / bf16 to f32, the dtype dispatch of the plain-C entry points, and the
// lane layout the SpMM kernels share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

}  // namespace repro_torch

// FN<TV, TX>(args...) for the (vals, x) element types the flags name:
// 0 = float32, 1 = bfloat16.
#define REPRO_DISPATCH_TYPES(VALS_BF16, X_BF16, FN, ...)                      \
  ((VALS_BF16) ? ((X_BF16) ? FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__)    \
                           : FN<__nv_bfloat16, float>(__VA_ARGS__))           \
               : ((X_BF16) ? FN<float, __nv_bfloat16>(__VA_ARGS__)            \
                           : FN<float, float>(__VA_ARGS__)))
