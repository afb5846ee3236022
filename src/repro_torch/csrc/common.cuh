// Shared helpers of the port's sparse kernels: element loads that widen
// f32 / bf16 (and, for the value slabs of K1, K2, K4 and K5, int8 / fp8
// e4m3 codes) to f32 (one at a time, or four adjacent columns of an X row),
// the dtype dispatch of the plain-C entry points, the staging of a slab's
// slots into shared memory, the lane layout the SpMM kernels share and their
// accumulations of a tile's row runs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// The block size a launcher of the main path (K1, K2, K3) passes at its
// launch.  The "fault_launch" build variant (-DREPRO_FAULT_LAUNCH,
// kernels/_build.py) asks for 2048 threads a block, past the card's 1024:
// the launch fails with cudaErrorInvalidConfiguration, a launch error that
// cudaGetLastError reports and clears (not sticky), so the guardrails'
// ladder can count the failure and a later launch from the default build
// succeeds.
#ifdef REPRO_FAULT_LAUNCH
#define REPRO_LAUNCH_THREADS(threads) 2048
#else
#define REPRO_LAUNCH_THREADS(threads) (threads)
#endif

namespace repro_torch {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// The codes of a quantized value slab (core/quant.py): exact in f32 (an
// e4m3 code goes through half, which holds it exactly).
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

// Whether a value slab of TV holds codes that a per-tile f32 scale decodes
// (int8, fp8 e4m3), not values.
template <typename TV>
__host__ __device__ constexpr bool is_coded() {
  return std::is_same<TV, int8_t>::value || std::is_same<TV, __nv_fp8_e4m3>::value;
}

// Four adjacent elements of a value slab as f32 (codes not yet scaled), by
// one evict-first load: 16 bytes (f32), 8 (bf16) or 4 (int8, fp8); the
// caller guarantees the alignment.
template <typename TV>
__device__ __forceinline__ float4 load_vals4(const TV* __restrict__ p) {
  if constexpr (std::is_same<TV, float>::value) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  } else if constexpr (std::is_same<TV, __nv_bfloat16>::value) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    const unsigned u = __ldcs(reinterpret_cast<const unsigned*>(p));
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned char b = static_cast<unsigned char>(u >> (8 * i));
      if constexpr (std::is_same<TV, int8_t>::value) {
        f[i] = static_cast<float>(static_cast<signed char>(b));
      } else {
        __nv_fp8_e4m3 c;
        c.__x = b;
        f[i] = static_cast<float>(c);
      }
    }
    return make_float4(f[0], f[1], f[2], f[3]);
  }
}

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

// Y[r, c .. c+3] = a at `at` = &Y[r, c]: one 16-byte store where VEC (the
// caller guarantees c + 3 < n and the alignment), else columns past n left
// alone.
template <bool VEC>
__device__ __forceinline__ void store4(float* at, int c, int n, const float (&a)[4]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(at) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < n) at[j] = a[j];
  }
}

// Y[r, c .. c+3] += a at `at` = &Y[r, c] by atomicAdd, columns past n left
// alone.
__device__ __forceinline__ void atomic_add4(float* at, int c, int n, const float (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < n) atomicAdd(at + j, a[j]);
}

// Hands the `cnt` slots of a (n_tiles, tile) slab from slot `base` on to
// put(j, row, col, val), j = 0 .. cnt-1, each once, spread over the CTA's
// THREADS threads.  VEC (cnt % 4 == 0 and rows, cols, vals aligned for it;
// the caller checks): rows and cols by 16-byte loads, vals by 16- (f32), 8-
// (bf16) or 4-byte (int8, fp8 codes) loads; every load evict-first, so that
// the slab leaves L2 to the dense operand the kernel gathers.  Codes reach
// put unscaled: the caller multiplies by the slot's tile scale.
template <typename TV, int THREADS, typename Put>
__device__ __forceinline__ void stage_slots(const int* __restrict__ rows,
                                            const int* __restrict__ cols,
                                            const TV* __restrict__ vals, long long base,
                                            int cnt, bool vec, Put put) {
  if (vec) {
    for (int j = 4 * threadIdx.x; j < cnt; j += 4 * THREADS) {
      const int4 rr = __ldcs(reinterpret_cast<const int4*>(rows + base + j));
      const int4 cc = __ldcs(reinterpret_cast<const int4*>(cols + base + j));
      const float4 vv = load_vals4(vals + base + j);
      put(j, rr.x, cc.x, vv.x);
      put(j + 1, rr.y, cc.y, vv.y);
      put(j + 2, rr.z, cc.z, vv.z);
      put(j + 3, rr.w, cc.w, vv.w);
    }
  } else {
    for (int j = threadIdx.x; j < cnt; j += THREADS)
      put(j, __ldcs(rows + base + j), __ldcs(cols + base + j), to_f32(vals[base + j]));
  }
}

// Whether a slab can be staged 4 slots at a time (stage_slots' VEC).
template <typename TV>
bool vector_slots(const int* rows, const int* cols, const void* vals, int tile) {
  return tile % 4 == 0 &&
         (reinterpret_cast<std::uintptr_t>(rows) | reinterpret_cast<std::uintptr_t>(cols)) % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(vals) % (4 * sizeof(TV)) == 0;
}

// The padded shared-memory layout of a tile split into equal ranges (K1's sr
// design, K4): a range of `span` slots starts `stride` words after the last
// one's, stride = (span + 1) | 1 odd, so that the lanes of a warp that read
// their own ranges hit distinct banks.
__host__ __device__ __forceinline__ int range_stride(int span) { return (span + 1) | 1; }

// The row runs of one contiguous range of a tile's slots staged in shared
// memory (K1's sr design, K4 on window keys, K8 at N > 1): Y[r, c .. c+3] += w · X[col, c ..
// c+3] over slots [0, len) of rows / cols / w, rows non-decreasing, padding
// (row >= m) dropped.  The lane owns the 4 adjacent columns from c, gathered
// by one 16-byte load a slot (8 bytes for bf16 X) where VEC; GATHERS gathers
// are issued back to back before the FMAs that use them, each one
// unconditionally (a slot past the range repeats the range's last one, and
// its product is dropped), as K3's sr design does.  Each run's sum goes once
// to flush(row, sum, next_row), next_row being the row of the slot after
// the run: `after` (the row of the slot past the range, or m at the tile's
// end) for the range's last run.  The caller decides how a sum reaches Y.
// EARLY_ROWS reads each slot's row beside its column, before the gathers,
// else after them (measured on H100: K4 at N = 4 3% faster the first way,
// K8 5-9% slower).
template <typename TX, bool VEC, int GATHERS, bool EARLY_ROWS, typename Flush>
__device__ __forceinline__ void accumulate_runs(const int* rows, const int* cols,
                                                const float* w, int len, int after,
                                                const TX* __restrict__ x, int m, int n,
                                                int c, Flush flush) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int cur = rows[0];
  for (int i = 0; i < len; i += GATHERS) {
    float xv[GATHERS][4];
    int rr[GATHERS];
#pragma unroll
    for (int u = 0; u < GATHERS; ++u) {
      const int s = min(i + u, len - 1);
      if constexpr (EARLY_ROWS) rr[u] = rows[s];
      load4<TX, VEC>(x + static_cast<long long>(cols[s]) * n, c, n, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < GATHERS; ++u) {
      if (i + u >= len) break;
      const int r = EARLY_ROWS ? rr[u] : rows[i + u];
      if (r != cur) {
        if (cur < m) flush(cur, acc, r);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = 0.f;
        cur = r;
      }
      if (r < m) {
        const float v = w[i + u];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(v, xv[u][j], acc[j]);
      }
    }
  }
  if (cur < m) flush(cur, acc, after);
}

// The slot-tile K10's accumulation of one tile staged in shared memory (its
// edge weights): Y[r, :] += v · X[c, :] over the tile's slots, padding (r >=
// m) dropped.  Each warp splits into lane groups of `vec`
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

// FN<TV, TX>(args...) for the value types of K1, K2, K4 and K5, whose value
// slabs may hold codes: VALS_TYPE 0 = float32, 1 = bfloat16, 2 = int8, 3 =
// fp8 e4m3 (codes decoded by a per-tile f32 scale); X_BF16 as above.  Any
// other VALS_TYPE gives cudaErrorInvalidValue.
#define REPRO_DISPATCH_VALUE_TYPES(VALS_TYPE, X_BF16, FN, ...)                \
  ((VALS_TYPE) == 0   ? REPRO_DISPATCH_X(float, X_BF16, FN, __VA_ARGS__)      \
   : (VALS_TYPE) == 1 ? REPRO_DISPATCH_X(__nv_bfloat16, X_BF16, FN,            \
                                         __VA_ARGS__)                          \
   : (VALS_TYPE) == 2 ? REPRO_DISPATCH_X(int8_t, X_BF16, FN, __VA_ARGS__)     \
   : (VALS_TYPE) == 3 ? REPRO_DISPATCH_X(__nv_fp8_e4m3, X_BF16, FN,            \
                                         __VA_ARGS__)                          \
                      : static_cast<int>(cudaErrorInvalidValue))
#define REPRO_DISPATCH_X(TV, X_BF16, FN, ...)                                 \
  ((X_BF16) ? FN<TV, __nv_bfloat16>(__VA_ARGS__) : FN<TV, float>(__VA_ARGS__))
