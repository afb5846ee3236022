// Tensor-core and staging helpers shared by the block design of K7-K10
// (attention.cu) and the tensor-core design of K11 (bsr.cu): the TF32 and
// bf16 mma.sync products with the 3×TF32 split, bf16 packing, cp.async
// copies and the staging of a row-major tile into shared memory.
#pragma once

#include "common.cuh"

namespace repro_torch {

// Depth of one MMA: m16n8k8 on TF32, m16n8k16 on bf16.
template <typename T>
__host__ __device__ constexpr int mma_k() { return sizeof(T) == 4 ? 8 : 16; }

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The 3×TF32 split: x ≈ hi + lo, both TF32; hi·hi + hi·lo + lo·hi keeps an
// f32 product to ~2⁻²².
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3×TF32 product into c: the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Four 8×8 tiles of 16-bit elements from shared memory, transposed: lane l
// gives the address of row l % 8 of tile l / 8, and register q receives tile
// q's (row 2(lane % 4), 2(lane % 4) + 1; column lane / 4) pair — an A
// fragment of m16n8k16 from a tile stored depth-major ([k][m]).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// Stage rows r0 .. r0 + nrows − 1, columns c0 .. c0 + ncols − 1 of the
// row-major matrix g (row stride gs) into s (row stride ss), zero where the
// row is ≥ rlim or the column ≥ clim.  With `vec`, 16-byte cp.async copies
// (clim − c0 and ncols multiples of the 16-byte width, g and gs aligned);
// otherwise element by element, synchronously.  All threads call it.
template <typename T>
__device__ __forceinline__ void stage_tile(T* s, int ss, const T* g, int gs,
                                           int r0, int rlim, int c0, int clim,
                                           int nrows, int ncols, bool vec) {
  if (vec) {
    // chunk (r, j) of 16 bytes, stepped by the block without a division
    constexpr int E = elems16<T>();
    const int per_row = ncols / E;
    const int step_r = blockDim.x / per_row, step_j = blockDim.x % per_row;
    int r = threadIdx.x / per_row, j = threadIdx.x % per_row;
    while (r < nrows) {
      const int c = j * E;
      const bool ok = r0 + r < rlim && c0 + c < clim;
      const T* src = ok ? g + static_cast<long long>(r0 + r) * gs + c0 + c : g;
      cp_async16(s + r * ss + c, src, ok);
      r += step_r;
      j += step_j;
      if (j >= per_row) {
        j -= per_row;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ncols; i += blockDim.x) {
      const int r = i / ncols, c = i - r * ncols;
      const bool ok = r0 + r < rlim && c0 + c < clim;
      s[r * ss + c] =
          ok ? g[static_cast<long long>(r0 + r) * gs + c0 + c] : T(0.f);
    }
  }
}

// Fill `bytes` of shared memory from s with NaN (all-ones words, a NaN in
// f32 and in bf16), then wait for the CTA.  Only a test build
// (-DREPRO_POISON_STAGING, kernels/_build.py's "poison_staging" variant)
// calls it, at CTA entry of the block design's kernels: an entry that
// stage_tile leaves unwritten (the zero fill of rows past the operand and
// of the padded depth) then shows as NaN in the output.
__device__ __forceinline__ void poison_staging(void* s, size_t bytes) {
  unsigned* w = static_cast<unsigned*>(s);
  for (size_t i = threadIdx.x; i < bytes / 4; i += blockDim.x) w[i] = 0xffffffffu;
  __syncthreads();
}

// Allow a kernel the dynamic shared memory it asks for past 48 KB.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// inf or NaN: an exponent field of all ones.
__device__ __forceinline__ bool nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ bool nonfinite(__nv_bfloat16 x) {
  return (__bfloat16_as_ushort(x) & 0x7f80u) == 0x7f80u;
}

}  // namespace repro_torch
