// K6 — SDDMM over the BalancedCOO pattern: out[t, i] = <A[rows[t, i]],
// B[cols[t, i]]> in f32, 0 at padding slots (rows == m).
//
// Replaces the TPU kernel src/repro/kernels/fused_chain.py::_sddmm_kernel
// (pallas_call in _sddmm_call, entry sddmm_pallas).  What it computes is the
// same; the TPU's whole-array VMEM blocks of A and B and its per-tile jnp.take
// gathers are not carried over.
//
// Bound on H100: bytes.  The function reads the pattern (8 B a slot), A and
// B once (4·(M+K)·d B in f32) and writes 4 B a slot; its 2·d flops a slot are
// far below the card's balance point.  What the kernel really moves is more:
// each slot gathers the d-wide rows A[row] (reused along a row's run, so
// mostly from L1/L2) and B[col] (random columns; 256 B at d = 64 f32).
//
// Design: one CTA per balanced tile, the paper's equal-work-per-CTA rule.
// Lane groups own slots (score.cuh): 16-byte loads of both feature rows, a
// __shfl_xor_sync reduction, one f32 written per slot.  No shared memory, no
// atomics: every slot has one writer, so the result is deterministic.
#include "score.cuh"

namespace repro_torch {

template <typename TA>
__global__ void __launch_bounds__(kChainThreads)
sddmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
             const TA* __restrict__ a, const TA* __restrict__ b,
             float* __restrict__ out, int tile, int m, int d, int g, bool vec) {
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for_each_score<TA>(rows, cols, a, b, base, tile, m, d, g, vec,
                     [&](int slot, int, int, bool valid, float e) {
                       out[base + slot] = valid ? e : 0.f;
                     });
}

template <typename TA>
int launch_sddmm(const int* rows, const int* cols, const void* a,
                 const void* b, float* out, int n_tiles, int tile, int m,
                 int d, cudaStream_t stream) {
  const bool vec = score_vec<TA>(a, b, d);
  const int g = score_lanes<TA>(d, vec);
  sddmm_kernel<TA><<<n_tiles, kChainThreads, 0, stream>>>(
      rows, cols, static_cast<const TA*>(a), static_cast<const TA*>(b), out,
      tile, m, d, g, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; a: (m, d), b: (K, d), both f32 or both
// bf16, row-major; out: (n_tiles, tile) f32.  Returns the cudaError_t of the
// launch.
extern "C" int repro_sddmm(const int* rows, const int* cols, const void* a,
                           const void* b, int ab_bf16, float* out,
                           int n_tiles, int tile, int m, int d, void* stream) {
  return REPRO_DISPATCH_FEATURES(ab_bf16, repro_torch::launch_sddmm, rows,
                                 cols, a, b, out, n_tiles, tile, m, d,
                                 static_cast<cudaStream_t>(stream));
}
