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
// far below the card's balance point.  What a one-pass kernel really moves
// is more: one gathered row of B a slot (256 B at d = 64 f32, random
// columns) and one row of A a run of equal rows.
//
// Design: the paper's two reduction strategies on the SDDMM's reduction
// axis d, one kernel each, routed by d (kernels/fused_chain.py::
// _sddmm_design).  Every slot has one writer and there are no atomics: the
// result is deterministic.
//
// "par" (d wider than one 16-byte piece; score.cuh::score_range_par): a CTA
// takes one balanced tile, or several adjacent ones when the tile is short
// (equal work a CTA, the paper's balance rule), and stages their rows and
// columns in shared memory by 16-byte evict-first loads, so that the
// pattern leaves L2 to A and B.  Lane groups of g lanes split d.  Each
// group walks one equal contiguous range of the CTA's slots, so it meets
// each row as one run: a slot of the row before it takes A[row]'s pieces
// from registers, and the group issues the gathers of several slots before
// their products.  The ranges lie in shared memory with an odd stride
// (common.cuh::range_stride), so the groups of a warp read distinct banks;
// the scores replace the columns there and go back by 16-byte stores.
//
// "seq" (d of one 16-byte piece or less, the backward's dvals at N = 1 and
// 4; score.cuh::score_slots_seq): a thread owns a slot and loops over d
// with no shuffle; the threads of a CTA take consecutive slots, so a warp's
// index loads and score stores coalesce, read and written straight from
// and to device memory (measured on H100: staging them first was 20%
// slower at d = 1).
#include <algorithm>

#include "score.cuh"

namespace repro_torch {

constexpr int kSddmmThreads = 256;
// The design points, measured on H100 (tools/time_sddmm.py, b2b, each
// against its neighbours in one call).  "par", g500 at d = 64: 4 pieces of B
// a lane gathers before their products (2 and 8: 0.981 and 0.992 ms against
// 0.893); 6 CTAs an SM, which caps registers at 40 (4 CTAs: 0.893 against
// 0.761; 5 and 7 each won one graph and lost the other by 1-5%); ranges of
// at least 64 slots (16: 0.782 against 0.760).  "seq", g500: 2 slots a
// thread at once (1: 0.148 / 0.154 ms at d = 1 / 4 against 0.120 / 0.132);
// 4 CTAs an SM for a row of one 16-byte load and 8 for rows of single
// elements (8 CTAs: d = 1 0.103 against 0.120, d = 4 0.193 against 0.132).
constexpr int kSddmmGathers = 4;
constexpr int kSddmmMinCtas = 6;
constexpr int kSddmmMinSpan = 64;
constexpr int kSddmmSeqSlots = 2;
constexpr int kSddmmSeqMinCtas = 4;
constexpr int kSddmmSeqNarrowMinCtas = 8;
// the most slots a CTA stages: HOPPER_MAX_TILE
constexpr int kSddmmMaxSlots = 4096;

enum SddmmDesign { kSeq = 0, kPar = 1 };

// The CTA's `cnt` slots from `base` into shared memory, slot j of them at
// pos(j): 16-byte evict-first loads where `vec` (base and cnt multiples of
// 4, rows and cols 16-byte aligned), else one slot at a time.
template <typename Pos>
__device__ __forceinline__ void stage_pattern(const int* __restrict__ rows,
                                              const int* __restrict__ cols, long long base,
                                              int cnt, bool vec, int* s_row, int* s_col,
                                              Pos pos) {
  if (vec) {
    for (int j = 4 * threadIdx.x; j < cnt; j += 4 * kSddmmThreads) {
      const int4 rr = __ldcs(reinterpret_cast<const int4*>(rows + base + j));
      const int4 cc = __ldcs(reinterpret_cast<const int4*>(cols + base + j));
      const int r4[4] = {rr.x, rr.y, rr.z, rr.w}, c4[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s_row[pos(j + u)] = r4[u];
        s_col[pos(j + u)] = c4[u];
      }
    }
  } else {
    for (int j = threadIdx.x; j < cnt; j += kSddmmThreads) {
      s_row[pos(j)] = __ldcs(rows + base + j);
      s_col[pos(j)] = __ldcs(cols + base + j);
    }
  }
}

// The CTA's scores, at pos(j) of s_out, to out[base + j]: 16-byte stores
// where `vec`.
template <typename Pos>
__device__ __forceinline__ void store_scores(const int* s_out, float* __restrict__ out,
                                             long long base, int cnt, bool vec, Pos pos) {
  if (vec) {
    for (int j = 4 * threadIdx.x; j < cnt; j += 4 * kSddmmThreads)
      __stcs(reinterpret_cast<float4*>(out + base + j),
             make_float4(__int_as_float(s_out[pos(j)]), __int_as_float(s_out[pos(j + 1)]),
                         __int_as_float(s_out[pos(j + 2)]), __int_as_float(s_out[pos(j + 3)])));
  } else {
    for (int j = threadIdx.x; j < cnt; j += kSddmmThreads)
      out[base + j] = __int_as_float(s_out[pos(j)]);
  }
}

// "par": groups of g lanes over equal ranges of the CTA's `cta_slots`
// slots, P pieces a lane (0: a loop).
template <typename TA, bool VEC, int P>
__global__ void __launch_bounds__(kSddmmThreads, kSddmmMinCtas)
sddmm_par_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const TA* __restrict__ a, const TA* __restrict__ b, float* __restrict__ out,
                 long long total, int cta_slots, int m, int d, int g, bool vec_slots) {
  const long long base = static_cast<long long>(blockIdx.x) * cta_slots;
  const int cnt = static_cast<int>(min(static_cast<long long>(cta_slots), total - base));
  const int groups = kSddmmThreads / g;
  const int span = (cnt + groups - 1) / groups;
  const int gi = threadIdx.x / g;
  const int len = max(0, min(span, cnt - gi * span));
  constexpr int U = P > 1 ? (kSddmmGathers / P > 0 ? kSddmmGathers / P : 1) : kSddmmGathers;
  extern __shared__ __align__(16) int sddmm_smem[];
  const int stride = range_stride(span);
  int* s_row = sddmm_smem;
  int* s_col = s_row + groups * stride;
  const auto pos = [&](int j) { return (j / span) * stride + j % span; };
  stage_pattern(rows, cols, base, cnt, vec_slots, s_row, s_col, pos);
  __syncthreads();
  // a slot's score replaces its column: the group's lanes read the column
  // before its first lane writes the score
  int* my_col = s_col + gi * stride;
  score_range_par<TA, VEC, P, U>(
      s_row + gi * stride, my_col, len, span, a, b, m, d, g,
      [&](int i, float e) { my_col[i] = __float_as_int(e); });
  __syncthreads();
  store_scores(s_col, out, base, cnt, vec_slots, pos);
}

// "seq": a thread a slot, the CTA's threads over `cta_slots` consecutive
// slots, read and written straight from and to device memory.
template <typename TA, bool VEC>
__global__ void __launch_bounds__(kSddmmThreads, VEC ? kSddmmSeqMinCtas : kSddmmSeqNarrowMinCtas)
sddmm_seq_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const TA* __restrict__ a, const TA* __restrict__ b, float* __restrict__ out,
                 long long total, int cta_slots, int m, int d) {
  const long long base = static_cast<long long>(blockIdx.x) * cta_slots;
  const int cnt = static_cast<int>(min(static_cast<long long>(cta_slots), total - base));
  score_slots_seq<TA, VEC, kSddmmSeqSlots>(
      rows + base, cols + base, cnt, a, b, m, d, [&](int i, float e) { out[base + i] = e; });
}

// Slots a "par" CTA takes: whole tiles, enough that each group walks at
// least kSddmmMinSpan slots, at most kSddmmMaxSlots (one tile when the tile
// alone is that long).
inline int sddmm_cta_slots(int tile, int groups) {
  const int want = groups * kSddmmMinSpan;
  const int tiles = std::max(1, std::min((want + tile - 1) / tile, kSddmmMaxSlots / tile));
  return tiles * tile;
}

template <typename TA>
int launch_sddmm(const int* rows, const int* cols, const void* a, const void* b, float* out,
                 int n_tiles, int tile, int m, int d, int design, cudaStream_t stream) {
  const TA* aa = static_cast<const TA*>(a);
  const TA* bb = static_cast<const TA*>(b);
  const bool vec = d > 0 && score_vec<TA>(a, b, d);
  const long long total = static_cast<long long>(n_tiles) * tile;
  const bool vec_slots =
      tile % 4 == 0 && (reinterpret_cast<std::uintptr_t>(rows) |
                        reinterpret_cast<std::uintptr_t>(cols) |
                        reinterpret_cast<std::uintptr_t>(out)) % 16 == 0;
  if (design == kSeq) {
    const int slots = kSddmmThreads * kSddmmSeqSlots;
    const int grid = static_cast<int>((total + slots - 1) / slots);
    const auto run = [&](auto kernel) {
      kernel<<<grid, kSddmmThreads, 0, stream>>>(rows, cols, aa, bb, out, total, slots, m, d);
    };
    vec ? run(sddmm_seq_kernel<TA, true>) : run(sddmm_seq_kernel<TA, false>);
    return static_cast<int>(cudaGetLastError());
  }
  if (design != kPar) return static_cast<int>(cudaErrorInvalidValue);
  const int pieces = vec ? d / elems16<TA>() : d;
  const int g = lanes_per_row(pieces);
  const int per_lane = (pieces + g - 1) / g;
  const int groups = kSddmmThreads / g;
  const int slots = sddmm_cta_slots(tile, groups);
  const int grid = static_cast<int>((total + slots - 1) / slots);
  const size_t smem =
      2 * sizeof(int) * static_cast<size_t>(groups) * range_stride((slots + groups - 1) / groups);
  const auto run = [&](auto kernel) {
    kernel<<<grid, kSddmmThreads, smem, stream>>>(rows, cols, aa, bb, out, total, slots, m, d,
                                                   g, vec_slots);
  };
  const auto by_pieces = [&](auto k1, auto k2, auto k4, auto kloop) {
    if (per_lane == 1) run(k1);
    else if (per_lane == 2) run(k2);
    else if (per_lane <= 4) run(k4);
    else run(kloop);
  };
  if (vec)
    by_pieces(sddmm_par_kernel<TA, true, 1>, sddmm_par_kernel<TA, true, 2>,
              sddmm_par_kernel<TA, true, 4>, sddmm_par_kernel<TA, true, 0>);
  else
    by_pieces(sddmm_par_kernel<TA, false, 1>, sddmm_par_kernel<TA, false, 2>,
              sddmm_par_kernel<TA, false, 4>, sddmm_par_kernel<TA, false, 0>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; a: (m, d), b: (K, d), both f32 or both
// bf16, row-major; out: (n_tiles, tile) f32; design: 0 = "seq", 1 = "par".
// Returns the cudaError_t of the launch.
extern "C" int repro_sddmm(const int* rows, const int* cols, const void* a, const void* b,
                           int ab_bf16, float* out, int n_tiles, int tile, int m, int d,
                           int design, void* stream) {
  return REPRO_DISPATCH_FEATURES(ab_bf16, repro_torch::launch_sddmm, rows, cols, a, b, out,
                                 n_tiles, tile, m, d, design,
                                 static_cast<cudaStream_t>(stream));
}
