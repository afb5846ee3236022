// K1 — nnz-balanced (VSR) SpMM, Y = A·X, on the BalancedCOO substrate.
//
// Replaces the TPU kernel src/repro/kernels/vsr.py::_vsr_fused_kernel
// (pallas_call in _vsr_fused_call).  What it computes is the same: for every
// stored nonzero (row r, col c, value v) of the (n_tiles, tile) slabs,
// Y[r, :] += v · X[c, :], padding entries (r == m) dropped, f32 accumulation.
//
// Bound on H100: bytes.  Each nonzero reads 12 B of substrate and one dense
// row of X (4·N B in f32, gathered); 2·N flops per nonzero is far below the
// card's ~20 flop/B balance point, so the gather of X rows is the cost.
//
// Design (not the TPU's): one CTA per (tile, column block) — the paper's
// equal-nonzeros-per-warp invariant, so Graph500 hub rows spread over many
// CTAs instead of serialising in one.  The tile's rows/cols/vals are staged
// once into shared memory with coalesced loads.  Each warp splits into lane
// groups of `vec` lanes; a group walks a contiguous run of the tile's
// nonzeros while its lanes own dense columns, so one X[c, :] row load is one
// coalesced transaction across the group (the paper's VDL).  A group carries
// its running row sum in registers and flushes it with atomicAdd when the row
// id changes — the paper's own boundary resolution; the TPU's one-hot MXU
// matmul and sequential-grid block revisit have no place on a GPU, whose CTAs
// run concurrently.  Y must be zeroed by the caller; no allocation here.
#include "common.cuh"

namespace repro_torch {

constexpr int kVsrThreads = 256;

template <typename TV, typename TX, int CPL>
__global__ void __launch_bounds__(kVsrThreads)
vsr_spmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                const TV* __restrict__ vals, const TX* __restrict__ x,
                float* __restrict__ y, int tile, int m, int n, int vec) {
  extern __shared__ int smem[];
  int* s_rows = smem;
  int* s_cols = s_rows + tile;
  float* s_vals = reinterpret_cast<float*>(s_cols + tile);

  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    s_rows[i] = rows[base + i];
    s_cols[i] = cols[base + i];
    s_vals[i] = to_f32(vals[base + i]);
  }
  __syncthreads();

  accumulate_tile<TX, CPL>(s_rows, s_cols, s_vals, x, y, tile, m, n, vec);
}

template <typename TV, typename TX>
int launch_vsr_spmm(const int* rows, const int* cols, const void* vals,
                    const void* x, float* y, int n_tiles, int tile, int m,
                    int n, cudaStream_t stream) {
  const int vec = lanes_per_row(n);
  const int cpl = columns_per_lane(n);
  const dim3 grid(n_tiles, (n + vec * cpl - 1) / (vec * cpl));
  const size_t smem = static_cast<size_t>(tile) * 3 * sizeof(int);
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  if (cpl == 1)
    vsr_spmm_kernel<TV, TX, 1><<<grid, kVsrThreads, smem, stream>>>(rows, cols, v, xx, y, tile, m, n, vec);
  else if (cpl == 2)
    vsr_spmm_kernel<TV, TX, 2><<<grid, kVsrThreads, smem, stream>>>(rows, cols, v, xx, y, tile, m, n, vec);
  else
    vsr_spmm_kernel<TV, TX, 4><<<grid, kVsrThreads, smem, stream>>>(rows, cols, v, xx, y, tile, m, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// K4 — the spill variant of K1, Y's per-tile partials: tile t's row sums go
// to its (win, n) window of the (n_tiles, win, n) partials at window row
// min(max(row - row_base[t], 0), win - 1), the reference's clamp; the combine
// below adds the windows.  Replaces the TPU kernel src/repro/kernels/vsr.py::
// _vsr_kernel (pallas_call in _vsr_call), whose one-hot MXU product reduces
// a tile into its window.
//
// Bound on H100: bytes — K1's, plus the 4·n_tiles·win·n B of partials
// written (at win = 40 and n = 128 that is 20 KB a tile of 512 nonzeros,
// against 6 KB of substrate).  As for K1 and K3, what a one-pass kernel
// really moves is one gathered X row a nonzero: at N = 128, 8.6 GB on the
// uniform scale-20 graph, more than L2 keeps.
//
// Design: a CTA per (tiles_per_cta tiles, column block of 4·lanes columns).
// The CTA stages its tiles' window keys, columns and values in shared memory
// with coalesced 16-byte loads, evict-first so that the substrate leaves L2
// to X.  Lane groups of `lanes` lanes walk equal contiguous ranges of a
// tile's slots, at least 16 (so at small N a CTA takes several tiles); a
// lane owns 4 adjacent columns, gathered by one 16-byte load a slot (8 bytes
// for bf16 X) where N % 4 == 0 and X is aligned, and 8 gathers are issued
// before their FMAs (K3's sr design); registers are capped at 2 or 3 CTAs
// an SM (at 4 the gathers' registers spill).  Runs are keyed on the clamped
// window row, so rows clamped onto one window row add.  A run that lies
// inside one group's range is stored there with a plain store.  A run that crosses
// ranges leaves its part in shared memory (one 4-column sum a lane, 4 KB a
// CTA, whatever win and tile are), and the group where it ends adds the
// parts of the groups before it and stores it once.  Window rows the tile
// does not touch are written as 0 by the group that stores the run before
// them (rows are sorted within a tile, so the keys are non-decreasing and
// the untouched rows are the gaps between consecutive keys), and by the
// tile's first group before its first key: each entry is written exactly
// once, with neither atomics nor a zeroing pass, and shared memory does not
// grow with win.  A group's range starts an odd number of words after the
// last one's, so the lanes of a warp that read their own ranges do not
// share banks.  The column block is the grid's slow dimension: with fewer
// lanes than N needs (a caller's choice), all tiles run against one column
// slab of X before the next.  At N = 128 one warp a column block (no slabs)
// measured faster than K3's 128-byte slabs: each slab re-stages the tile,
// and 8-lane groups walk ranges of 16 slots.
constexpr int kSpillThreads = 256;
// X rows a lane gathers back to back
constexpr int kSpillGathers = 8;

// K4's shared-memory layout: a group's range of `span` slots starts
// `stride` words after the last one's, stride = (span + 1) | 1 odd, so that
// the lanes of a warp reading their groups' slots hit distinct banks.
__host__ __device__ __forceinline__ int spill_stride(int span) { return (span + 1) | 1; }

// K4's shared memory: a 4-column part of a crossing run for every thread,
// then the keys, columns and values of `ranges` ranges.
inline size_t spill_smem_bytes(int ranges, int span) {
  return kSpillThreads * sizeof(float4) +
         static_cast<size_t>(ranges) * spill_stride(span) * 3 * sizeof(int);
}

// MIN_CTAS: CTAs an SM must hold, which caps a thread's registers (the
// launcher's choice by lanes; 4 would spill the 8 gathers' registers).
template <typename TV, typename TX, bool VEC, int MIN_CTAS>
__global__ void __launch_bounds__(kSpillThreads, MIN_CTAS)
vsr_spmm_spill_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                      const TV* __restrict__ vals, const TX* __restrict__ x,
                      const int* __restrict__ row_base, float* __restrict__ part,
                      int n_tiles, int tile, int m, int n, int win, int lanes,
                      int tiles_per_cta, bool vec_slots) {
  extern __shared__ __align__(16) unsigned char spill_smem[];
  const int gpt = kSpillThreads / lanes / tiles_per_cta;  // groups a tile
  const int span = (tile + gpt - 1) / gpt;                 // slots a group
  const int stride = spill_stride(span);
  const int words = tiles_per_cta * gpt * stride;
  float4* s_part = reinterpret_cast<float4*>(spill_smem);
  int* s_key = reinterpret_cast<int*>(s_part + kSpillThreads);
  int* s_col = s_key + words;
  float* s_val = reinterpret_cast<float*>(s_col + words);
  // where slot i of the CTA's tile tt lies in shared memory
  const auto spos = [&](int tt, int i) { return (tt * gpt + i / span) * stride + i % span; };

  // stage the CTA's tiles, rows turned into window keys (win for padding)
  const int t0 = blockIdx.x * tiles_per_cta;
  const int n_here = min(tiles_per_cta, n_tiles - t0);
  const int cnt = n_here * tile;
  const long long base = static_cast<long long>(t0) * tile;
  const auto stage = [&](int j, int r, int c, float v) {
    const int tt = j / tile;
    const int at = spos(tt, j - tt * tile);
    s_key[at] = r < m ? min(max(r - __ldg(row_base + t0 + tt), 0), win - 1) : win;
    s_col[at] = c;
    s_val[at] = v;
  };
  if (vec_slots) {  // tile % 4 == 0 and the operands aligned
    for (int j = 4 * threadIdx.x; j < cnt; j += 4 * kSpillThreads) {
      const int4 rr = __ldcs(reinterpret_cast<const int4*>(rows + base + j));
      const int4 cc = __ldcs(reinterpret_cast<const int4*>(cols + base + j));
      float4 vv;
      if constexpr (std::is_same<TV, float>::value) {
        vv = __ldcs(reinterpret_cast<const float4*>(vals + base + j));
      } else {
        const uint2 u = __ldcs(reinterpret_cast<const uint2*>(vals + base + j));
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        vv = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      stage(j, rr.x, cc.x, vv.x);
      stage(j + 1, rr.y, cc.y, vv.y);
      stage(j + 2, rr.z, cc.z, vv.z);
      stage(j + 3, rr.w, cc.w, vv.w);
    }
  } else {
    for (int j = threadIdx.x; j < cnt; j += kSpillThreads)
      stage(j, __ldcs(rows + base + j), __ldcs(cols + base + j), to_f32(vals[base + j]));
  }
  __syncthreads();

  // this lane's group, its tile and its range of the tile's slots
  const int group = threadIdx.x / lanes;
  const int tt = group / gpt;
  const int gi = group - tt * gpt;
  const auto range_start = [&](int g) { return min(g * span, tile); };
  const int start = range_start(gi);
  const int end = min(start + span, tile);
  const int c = 4 * (blockIdx.y * lanes + threadIdx.x % lanes);
  const bool live = tt < n_here && start < end && c < n;
  // key_at: any slot of the tile; key, col, val: the range's slots from 0
  const auto key_at = [&](int i) { return s_key[spos(tt, i)]; };
  const int at0 = (tt * gpt + gi) * stride;
  const int* key = s_key + at0;
  const int* col = s_col + at0;
  const float* val = s_val + at0;
  float* out = part + static_cast<long long>(t0 + tt) * win * n + c;

  const auto put = [&](int w, const float a[4]) {
    float* o = out + static_cast<long long>(w) * n;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < n) o[j] = a[j];
    }
  };
  // window rows [from, min(to, win)) are untouched by the tile
  const auto zeros = [&](int from, int to) {
    const float z[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = from; w < min(to, win); ++w) put(w, z);
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float head[4] = {0.f, 0.f, 0.f, 0.f};  // the range's first run, if it crossed in
  int head_key = win, head_next = win;   // its key, and the key after it
  if (live) {
    const int len = end - start;
    if (gi == 0) zeros(0, key[0]);
    const int kf = key[0], kl = key[len - 1];
    const bool cross_in = start > 0 && key_at(start - 1) == kf && kf < win;
    const bool cross_out = end < tile && key_at(end) == kl && kl < win;
    bool first_run = true;
    // the run of key k ends before a slot of key nk
    const auto close = [&](int k, int nk) {
      if (first_run && cross_in) {
#pragma unroll
        for (int j = 0; j < 4; ++j) head[j] = acc[j];
        head_key = k;
        head_next = nk;
      } else if (k < win) {
        put(k, acc);
        zeros(k + 1, nk);
      }
      first_run = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = 0.f;
    };
    int cur = kf;
    for (int i = 0; i < len; i += kSpillGathers) {
      // all gathers of the step first, then their FMAs
      float xv[kSpillGathers][4];
      int kk[kSpillGathers];
#pragma unroll
      for (int u = 0; u < kSpillGathers; ++u) {
        kk[u] = i + u < len ? key[i + u] : win;
        if (kk[u] < win) {
          load4<TX, VEC>(x + static_cast<long long>(col[i + u]) * n, c, n, xv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSpillGathers; ++u) {
        if (i + u >= len) continue;
        if (kk[u] != cur) {
          close(cur, kk[u]);
          cur = kk[u];
        }
        if (kk[u] < win) {
          const float v = val[i + u];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = fmaf(v, xv[u][j], acc[j]);
        }
      }
    }
    if (cross_out)  // the range's last run goes on in the next range
      s_part[threadIdx.x] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    else
      close(cur, end < tile ? key_at(end) : win);
  }
  __syncthreads();
  // a run that crossed into this range and ends in it: add the parts of
  // the ranges before it, back to the one where it started
  if (live && head_key < win) {
    for (int g = gi - 1;; --g) {
      const float4 p = s_part[(tt * gpt + g) * lanes + threadIdx.x % lanes];
      head[0] += p.x; head[1] += p.y; head[2] += p.z; head[3] += p.w;
      const int s2 = range_start(g);
      const int e2 = min(s2 + span, tile);
      // range g is a pass-through: all of it is this run, crossing in too
      if (!(s2 > 0 && key_at(s2 - 1) == head_key && key_at(e2 - 1) == head_key)) break;
    }
    put(head_key, head);
    zeros(head_key + 1, head_next);
  }
}

template <typename TV, typename TX>
int launch_vsr_spmm_spill(const int* rows, const int* cols, const void* vals,
                          const void* x, const int* row_base, float* part,
                          int n_tiles, int tile, int m, int n, int win,
                          int lanes, cudaStream_t stream) {
  // groups a tile: a power of two, ranges of at least 16 slots where the
  // tile has them; the CTA takes the tiles its other groups can walk
  const int groups = kSpillThreads / lanes;
  int gpt = 1;
  while (gpt * 2 <= groups && gpt * 2 * 16 <= tile) gpt *= 2;
  int tiles_per_cta = groups / gpt;
  const auto smem_of = [&](int tpc) {
    const int g = groups / tpc;
    return spill_smem_bytes(tpc * g, (tile + g - 1) / g);
  };
  while (tiles_per_cta > 1 && smem_of(tiles_per_cta) > 56 * 1024) tiles_per_cta /= 2;
  const size_t smem = smem_of(tiles_per_cta);
  const dim3 grid((n_tiles + tiles_per_cta - 1) / tiles_per_cta,
                  (n + 4 * lanes - 1) / (4 * lanes));
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  const bool vec_slots = tile % 4 == 0 &&
      (reinterpret_cast<std::uintptr_t>(rows) | reinterpret_cast<std::uintptr_t>(cols)) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(vals) % (4 * sizeof(TV)) == 0;
  const auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, kSpillThreads, smem, stream>>>(rows, cols, v, xx, row_base, part, n_tiles,
                                                  tile, m, n, win, lanes, tiles_per_cta,
                                                  vec_slots);
    return static_cast<int>(cudaGetLastError());
  };
  // 3 CTAs an SM for groups of 4-16 lanes (short ranges: more warps keep
  // more gathers in flight), 2 otherwise (no spills); measured on H100
  const bool three = lanes >= 4 && lanes <= 16;
  if (vector_rows<TX>(x, part, n))
    return three ? run(vsr_spmm_spill_kernel<TV, TX, true, 3>)
                 : run(vsr_spmm_spill_kernel<TV, TX, true, 2>);
  return three ? run(vsr_spmm_spill_kernel<TV, TX, false, 3>)
               : run(vsr_spmm_spill_kernel<TV, TX, false, 2>);
}

// The spill path's combine: Y[r, :] = the sum of the window rows that hold
// row r, part[t, r - row_base[t], :] over the tiles with row_base[t] <= r <
// row_base[t] + win.  Replaces the reference's segment_sum outside its
// spill kernels (src/repro/kernels/vsr.py::_vsr_call, spmv.py::_spmv_call).
//
// Bound on H100: bytes — the partials read once and Y written once
// (4·n_tiles·win·N + 4·M·N B), against one add a partial.
//
// Design: a row-parallel gather, not a scatter.  row_base is non-decreasing
// (the caller checks), so the tiles that cover row r are one contiguous
// range: those with r - win < row_base[t] <= r.  A CTA takes 512 consecutive
// rows: two warps find the range of tiles that covers them by a 32-way
// search of row_base (three rounds of one load a lane), the CTA stages that
// part of row_base in shared memory, and each row finds its own tiles there
// by binary search.  A group of `lanes` lanes owns a row, a lane 4 adjacent
// columns (16-byte loads and stores where N % 4 == 0); the CTA walks its rows
// 256 / lanes at a time.  A lane sums its row's covering tiles in order in
// f32: deterministic, no atomics, no zeroing, every Y entry written once (0
// for a row no tile holds).  Rows at or past M are never computed, so
// windows that reach past M drop out, as the reference's num_segments = M +
// win + 1 and [:M] drop them; an all-padding tile's row_base is M and covers
// nothing.
constexpr int kCombineThreads = 256;
// rows a CTA sums, and the row_base entries it stages at most
constexpr int kCombineRows = 512;
constexpr int kCombineStage = 1024;

// The first t in [lo, hi) with row_base[t] > v (hi if none); all lanes of the
// warp call it and get the answer.  32-way: one load a lane a round.
__device__ __forceinline__ int warp_first_above(const int* __restrict__ row_base,
                                                int lo, int hi, int v) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const unsigned above = __ballot_sync(0xffffffffu, p >= hi || __ldg(row_base + p) > v);
    const int k = above ? __ffs(above) - 1 : 32;
    // samples before lane k are <= v, lane k's is above
    const int new_lo = k > 0 ? lo + (k - 1) * step + 1 : lo;
    hi = k < 32 ? min(lo + k * step, hi) : hi;
    lo = new_lo;
  }
  const unsigned above =
      __ballot_sync(0xffffffffu, lo + lane >= hi || __ldg(row_base + lo + lane) > v);
  return above ? min(lo + __ffs(above) - 1, hi) : hi;
}

// The first t in [lo, hi) with rb[t] > v (hi if none), by binary search.
__device__ __forceinline__ int first_above(const int* rb, int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rb[mid] > v) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

template <bool VEC>
__global__ void __launch_bounds__(kCombineThreads)
spill_combine_kernel(const float* __restrict__ part, const int* __restrict__ row_base,
                     float* __restrict__ y, int n_tiles, int win, int m, int n,
                     int lanes) {
  __shared__ int s_range[2];
  __shared__ int s_rb[kCombineStage];
  const int r0 = blockIdx.x * kCombineRows;
  const int r_end = min(r0 + kCombineRows, m);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int t = warp_first_above(row_base, 0, n_tiles, warp == 0 ? r0 - win : r_end - 1);
    if ((threadIdx.x & 31) == 0) s_range[warp] = t;
  }
  __syncthreads();
  const int t_lo = s_range[0], cnt = s_range[1] - s_range[0];
  const bool staged = cnt <= kCombineStage;
  if (staged)
    for (int i = threadIdx.x; i < cnt; i += kCombineThreads) s_rb[i] = row_base[t_lo + i];
  __syncthreads();
  // rb[i] = row_base[t_lo + i] for the CTA's tiles, from shared memory
  // where they fit
  const int* rb = staged ? s_rb : row_base + t_lo;
  const int c = 4 * (blockIdx.y * lanes + threadIdx.x % lanes);
  if (c >= n) return;
  for (int r = r0 + threadIdx.x / lanes; r < r_end; r += kCombineThreads / lanes) {
    const int lo = first_above(rb, 0, cnt, r - win);
    const int hi = first_above(rb, lo, cnt, r);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = lo; i < hi; ++i) {
      const float* src =
          part + (static_cast<long long>(t_lo + i) * win + (r - rb[i])) * n + c;
      if constexpr (VEC) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(src));
        acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) acc[j] += __ldcs(src + j);
      }
    }
    float* dst = y + static_cast<long long>(r) * n + c;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < n) dst[j] = acc[j];
    }
  }
}

inline int launch_spill_combine(const float* part, const int* row_base, float* y,
                                int n_tiles, int win, int m, int n,
                                cudaStream_t stream) {
  int lanes = 1;
  while (lanes < 32 && 4 * lanes < n) lanes *= 2;
  const dim3 grid((m + kCombineRows - 1) / kCombineRows, (n + 4 * lanes - 1) / (4 * lanes));
  if (n % 4 == 0)
    spill_combine_kernel<true><<<grid, kCombineThreads, 0, stream>>>(
        part, row_base, y, n_tiles, win, m, n, lanes);
  else
    spill_combine_kernel<false><<<grid, kCombineThreads, 0, stream>>>(
        part, row_base, y, n_tiles, win, m, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; vals: (n_tiles, tile) f32 or bf16;
// x: (K, n) row-major f32 or bf16; y: (m, n) f32, zeroed.  Returns the
// cudaError_t of the launch.
extern "C" int repro_vsr_spmm(const int* rows, const int* cols,
                              const void* vals, int vals_bf16, const void* x,
                              int x_bf16, float* y, int n_tiles, int tile,
                              int m, int n, void* stream) {
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16, repro_torch::launch_vsr_spmm,
                              rows, cols, vals, x, y, n_tiles, tile, m, n,
                              static_cast<cudaStream_t>(stream));
}

// K4.  rows/cols/vals and x as for repro_vsr_spmm; row_base: (n_tiles,)
// int32; part: (n_tiles, win, n) f32, fully written.  lanes: lanes of a
// group (1, 2, ..., 32), which own 4·lanes columns of a column block.
// Returns the launch's cudaError_t.
extern "C" int repro_vsr_spmm_spill(const int* rows, const int* cols,
                                    const void* vals, int vals_bf16,
                                    const void* x, int x_bf16,
                                    const int* row_base, float* part,
                                    int n_tiles, int tile, int m, int n,
                                    int win, int lanes, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16,
                              repro_torch::launch_vsr_spmm_spill, rows, cols,
                              vals, x, row_base, part, n_tiles, tile, m, n,
                              win, lanes, static_cast<cudaStream_t>(stream));
}

// The combine.  part: (n_tiles, win, n) f32; row_base: (n_tiles,) int32,
// non-decreasing; y: (m, n) f32, fully written.  Returns the launch's
// cudaError_t.
extern "C" int repro_spill_combine(const float* part, const int* row_base,
                                   float* y, int n_tiles, int win, int m,
                                   int n, void* stream) {
  return repro_torch::launch_spill_combine(part, row_base, y, n_tiles, win, m,
                                           n, static_cast<cudaStream_t>(stream));
}
