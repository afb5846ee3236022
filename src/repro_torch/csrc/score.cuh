// Edge scores of the SDDMM family (K6-K10): e = <A[row], B[col]> for every
// slot of a balanced tile, in f32, computed by lane groups; and the packed
// softmax row statistics that K7 and K9 write and K8 and K10 read.
//
// A lane group of `g` lanes owns one slot and splits the feature dimension d:
// with `vec` set, each lane makes 16-byte loads (4 f32 or 8 bf16 a load) of
// both rows; otherwise one element a load.  The group reduces its partial
// dots with __shfl_xor_sync.  A padding slot (row >= m) loads nothing: the
// reference guards the gather of A[row] with where(mask, rows, 0), and on the
// card an unguarded A[m] would read out of bounds.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kChainThreads = 256;

// Masked-softmax sentinel (a finite stand-in for -inf) and row-sum floor,
// core/spmm.py's SOFTMAX_NEG and SOFTMAX_EPS.
constexpr float kSoftmaxNeg = -1e30f;
constexpr float kSoftmaxEps = 1e-30f;

// One row's softmax statistics packed in 64 bits: the max in the low word,
// the sum of exp(z - max) in the high word.
__device__ __forceinline__ unsigned long long pack_stats(float m, float s) {
  return (static_cast<unsigned long long>(__float_as_uint(s)) << 32) |
         __float_as_uint(m);
}

// Online-softmax merge of a partial (mt, st) into the packed (rm, rs) pair,
// for a row whose slots lie in several CTAs.
__device__ __forceinline__ void merge_stats(unsigned long long* p, float mt,
                                            float st) {
  unsigned long long old = *p, assumed;
  do {
    assumed = old;
    const float m0 = __uint_as_float(static_cast<unsigned>(assumed));
    const float s0 = __uint_as_float(static_cast<unsigned>(assumed >> 32));
    const float mn = fmaxf(m0, mt);
    const float sn = s0 * expf(m0 - mn) + st * expf(mt - mn);
    old = atomicCAS(p, assumed, pack_stats(mn, sn));
  } while (old != assumed);
}

__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(xp[i]);
    const float2 q = __bfloat1622float2(yp[i]);
    s += p.x * q.x + p.y * q.y;
  }
  return s;
}

// Lanes per slot for feature width d: the smallest power of two >= the
// number of loads a row takes, at most 32.
template <typename T>
inline int score_lanes(int d, bool vec) {
  return lanes_per_row(vec ? d / elems16<T>() : d);
}

// Whether both feature matrices take 16-byte loads: d a multiple of the load
// width and both base pointers 16-byte aligned (rows then are too).
template <typename T>
inline bool score_vec(const void* a, const void* b, int d) {
  return d % elems16<T>() == 0 &&
         reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(b) % 16 == 0;
}

// Calls emit(slot, row, col, valid, score) once for every slot of the tile
// at `base`, from the first lane of the slot's group.  Every thread of the
// CTA must call it: all of them run the same number of iterations, so the
// shuffles always see the whole warp.
template <typename TA, typename Emit>
__device__ __forceinline__ void for_each_score(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const TA* __restrict__ a, const TA* __restrict__ b, long long base,
    int tile, int m, int d, int g, bool vec, Emit emit) {
  const int gl = threadIdx.x & (g - 1);
  const int group = threadIdx.x / g;
  const int n_groups = blockDim.x / g;
  for (int s0 = 0; s0 < tile; s0 += n_groups) {
    const int slot = s0 + group;
    const bool in_tile = slot < tile;
    const int r = in_tile ? rows[base + slot] : m;
    const int c = in_tile ? cols[base + slot] : 0;
    const bool valid = r < m;
    float s = 0.f;
    if (valid) {
      const TA* ar = a + static_cast<long long>(r) * d;
      const TA* br = b + static_cast<long long>(c) * d;
      if (vec) {
        constexpr int V = elems16<TA>();
        for (int j = gl * V; j < d; j += g * V) s += dot16(ar + j, br + j);
      } else {
        for (int j = gl; j < d; j += g) s += to_f32(ar[j]) * to_f32(br[j]);
      }
    }
    for (int off = g >> 1; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (in_tile && gl == 0) emit(slot, r, c, valid, s);
  }
}

}  // namespace repro_torch

// FN<TA>(args...) for the feature type the flag names: 0 = f32, 1 = bf16.
#define REPRO_DISPATCH_FEATURES(AB_BF16, FN, ...)                             \
  ((AB_BF16) ? FN<__nv_bfloat16>(__VA_ARGS__) : FN<float>(__VA_ARGS__))
