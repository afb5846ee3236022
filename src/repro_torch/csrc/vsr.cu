// K1 — nnz-balanced (VSR) SpMM, Y = A·X, on the BalancedCOO substrate: the
// paper's two nnz-balanced kernels, one for each logical kernel.
//
// Replaces the TPU kernel src/repro/kernels/vsr.py::_vsr_fused_kernel
// (pallas_call in _vsr_fused_call), which serves nb_sr and nb_pr alike.  What
// it computes is the same: for every stored nonzero (row r, col c, value v)
// of the (n_tiles, tile) slabs, Y[r, :] += v · X[c, :], padding entries (r
// == m) dropped, f32 accumulation.  The TPU's one-hot MXU reduction and
// sequential-grid block revisit have no place here: CTAs run concurrently.
//
// Bound on H100: bytes.  Each nonzero reads 12 B of substrate, against 2·N
// flops; what a one-pass kernel really moves is one gathered row of X a
// nonzero (4·N B in f32), which only L2 hits keep off device memory.
//
// Both designs rely on the slab's order: rows non-decreasing, so a row's
// slots are contiguous and can continue only from one tile into the next.
// A run that holds neither its tile's first slot nor the slot before a
// padding slot or the tile's end is a whole row, which no other CTA adds to:
// it is written with a plain store.  The tile's first and last runs (its
// edge runs) add by atomicAdd into the zeroed Y, so an empty row stays 0.
//
// "sr" (nb_sr; the paper's vectorised loads of the sparse elements, cached
// in shared memory, under a sequential reduction), vsr_sr_kernel below: a
// CTA stages one tile (several at small N) in shared memory with 16-byte
// evict-first loads, so that the substrate leaves L2 to X.  Lane groups of
// `lanes` lanes walk equal contiguous ranges of a tile's slots, at least 16;
// a lane owns 4 adjacent columns and gathers them by one 16-byte load a slot
// (8 bytes for bf16 X) (common.cuh::accumulate_runs, shared with K8 and
// K4), 4 gathers before their FMAs at 4 CTAs an SM: on the Graph500 graph, whose gathers mostly hit L2, more warps in
// flight beat more gathers a warp.  A run that crosses ranges leaves its
// part in shared memory, and the group where it ends adds the parts before
// it and writes it once, as K4 does: measured on H100, 14% faster than an
// atomicAdd a part on the uniform graph at N = 32.  The column block is the
// grid's slow dimension.
//
// "pr" (nb_pr; the paper's workload balancing and parallel reduction joined
// by a segmented reduction on shuffles) is csrc/spmv.cu's vsr_scan_kernel:
// one warp a tile, K2's and K5's segmented scan on 4-column pieces of X
// rows.
//
// Quantized value slabs (the TPU kernel's quant branch, vsr.py:146-155, and
// _vsr_kernel's, :229-237): with TV = int8_t or __nv_fp8_e4m3 the slab holds
// codes and `scales` one f32 scale a tile (core/quant.py).  Both designs and
// K4 read 4 codes by one 4-byte load where they read 4 f32 values by one
// 16-byte load, and multiply each code by its tile's scale in f32 as it is
// staged (tile t0 + tt of a CTA that stages several), so the product is
// (code·scale)·x, as in the reference; nothing else changes.  Bound:
// 9 B a nonzero and 4 B a tile of substrate, against 12 B a nonzero for
// f32.  For f32 and bf16 slabs `scales` is not read.
#include "common.cuh"

namespace repro_torch {

constexpr int kRangeThreads = 256;
// X rows a lane gathers back to back, and the CTAs an SM must hold (which
// caps a thread's registers): K1's sr design, K4.  Measured on H100
// (tools/time_nb.py): for K1, 4 gathers at 4 CTAs an SM (64 registers)
// beat 8 at 2-3 by 14-20% on the Graph500 graph and matched them on the
// uniform one; at 5 CTAs (48 registers) or with 8 gathers at 4 it lost.
constexpr int kSrGathers = 4;
constexpr int kSrMinCtas = 4;
constexpr int kSpillGathers = 8;

// The CTA shape of K1's sr design and K4: groups a tile (a power of two,
// ranges of at least 16 slots where the tile has them) and tiles a CTA (the
// rest of its groups), fewer tiles where their shared memory — a 4-column
// part of a crossing run for every thread, then the rows (keys), columns and
// values of every range — would pass 56 KB.
struct RangeLayout {
  int tiles_per_cta;
  size_t smem;
};

inline RangeLayout range_layout(int tile, int lanes) {
  const int groups = kRangeThreads / lanes;
  int gpt = 1;
  while (gpt * 2 <= groups && gpt * 2 * 16 <= tile) gpt *= 2;
  const auto smem_of = [&](int tpc) {
    const int g = groups / tpc;
    return kRangeThreads * sizeof(float4) +
           static_cast<size_t>(tpc * g) * range_stride((tile + g - 1) / g) * 3 * sizeof(int);
  };
  int tpc = groups / gpt;
  while (tpc > 1 && smem_of(tpc) > 56 * 1024) tpc /= 2;
  return {tpc, smem_of(tpc)};
}

// Launches `kernel` with the layout's dynamic shared memory, raising the
// kernel's limit past 48 KB where it needs it.
template <typename Kernel, typename... Args>
int launch_ranges(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, REPRO_LAUNCH_THREADS(kRangeThreads), smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename TV, typename TX, bool VEC>
__global__ void __launch_bounds__(kRangeThreads, kSrMinCtas)
vsr_sr_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
              const TV* __restrict__ vals, const float* __restrict__ scales,
              const TX* __restrict__ x,
              float* __restrict__ y, int n_tiles, int tile, int m, int n,
              int lanes, int tiles_per_cta, bool vec_slots) {
  extern __shared__ __align__(16) unsigned char sr_smem[];
  const int gpt = kRangeThreads / lanes / tiles_per_cta;  // groups a tile
  const int span = (tile + gpt - 1) / gpt;                 // slots a group
  const int stride = range_stride(span);
  const int words = tiles_per_cta * gpt * stride;
  float4* s_part = reinterpret_cast<float4*>(sr_smem);
  int* s_row = reinterpret_cast<int*>(s_part + kRangeThreads);
  int* s_col = s_row + words;
  float* s_val = reinterpret_cast<float*>(s_col + words);
  // where slot i of the CTA's tile tt lies in shared memory
  const auto spos = [&](int tt, int i) { return (tt * gpt + i / span) * stride + i % span; };

  const int t0 = blockIdx.x * tiles_per_cta;
  const int n_here = min(tiles_per_cta, n_tiles - t0);
  stage_slots<TV, kRangeThreads>(
      rows, cols, vals, static_cast<long long>(t0) * tile, n_here * tile, vec_slots,
      [&](int j, int r, int c, float v) {
        const int tt = j / tile;
        const int at = spos(tt, j - tt * tile);
        if constexpr (is_coded<TV>()) v *= __ldg(scales + t0 + tt);
        s_row[at] = r;
        s_col[at] = c;
        s_val[at] = v;
      });
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
  const auto row_at = [&](int i) { return s_row[spos(tt, i)]; };
  // a run's sum into Y: by atomicAdd for an edge run of the tile, else
  // stored
  const auto put = [&](int r, const float (&a)[4], bool edge) {
    float* at = y + static_cast<long long>(r) * n + c;
    if (edge)
      atomic_add4(at, c, n, a);
    else
      store4<VEC>(at, c, n, a);
  };

  float head[4] = {0.f, 0.f, 0.f, 0.f};  // the range's first run, if it crossed in
  int head_row = m, head_next = m;       // its row, and the row after it
  if (live) {
    const int at0 = (tt * gpt + gi) * stride;
    const int len = end - start;
    const int first = s_row[at0], last = s_row[at0 + len - 1];
    const bool cross_in = start > 0 && row_at(start - 1) == first && first < m;
    const bool cross_out = end < tile && row_at(end) == last && last < m;
    const int tile_first = row_at(0);
    accumulate_runs<TX, VEC, kSrGathers, false>(
        s_row + at0, s_col + at0, s_val + at0, len, end < tile ? row_at(end) : m, x, m, n, c,
        [&](int r, const float (&a)[4], int next) {
          if (r == last && cross_out) {  // goes on in the next range
            s_part[threadIdx.x] = make_float4(a[0], a[1], a[2], a[3]);
          } else if (r == first && cross_in) {
#pragma unroll
            for (int j = 0; j < 4; ++j) head[j] = a[j];
            head_row = r;
            head_next = next;
          } else {
            put(r, a, r == tile_first || next >= m);
          }
        });
  }
  __syncthreads();
  // a run that crossed into this range and ends in it: add the parts of the
  // ranges before it, back to the one where it started
  if (live && head_row < m) {
    for (int g = gi - 1;; --g) {
      const float4 p = s_part[(tt * gpt + g) * lanes + threadIdx.x % lanes];
      head[0] += p.x; head[1] += p.y; head[2] += p.z; head[3] += p.w;
      const int s2 = range_start(g);
      const int e2 = min(s2 + span, tile);
      // range g is a pass-through: all of it is this run, crossing in too
      if (!(s2 > 0 && row_at(s2 - 1) == head_row && row_at(e2 - 1) == head_row)) break;
    }
    put(head_row, head, head_row == row_at(0) || head_next >= m);
  }
}

template <typename TV, typename TX>
int launch_vsr_sr(const int* rows, const int* cols, const void* vals,
                  const float* scales, const void* x, float* y, int n_tiles,
                  int tile, int m, int n, int lanes, cudaStream_t stream) {
  const RangeLayout lay = range_layout(tile, lanes);
  const dim3 grid((n_tiles + lay.tiles_per_cta - 1) / lay.tiles_per_cta,
                  (n + 4 * lanes - 1) / (4 * lanes));
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  const bool vec_slots = vector_slots<TV>(rows, cols, vals, tile);
  const auto run = [&](auto kernel) {
    return launch_ranges(kernel, grid, lay.smem, stream, rows, cols, v, scales, xx, y,
                         n_tiles, tile, m, n, lanes, lay.tiles_per_cta, vec_slots);
  };
  return vector_rows<TX>(x, y, n) ? run(vsr_sr_kernel<TV, TX, true>)
                                   : run(vsr_sr_kernel<TV, TX, false>);
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
// Design: K1's sr design (a CTA per (tiles_per_cta tiles, column block of
// 4·lanes columns), its staging, lane groups and accumulation, with runs
// keyed on the clamped window row, so rows clamped onto one window row add,
// and its window written in place of Y.  A run that lies inside one group's
// range is stored there with a plain store; a run that crosses ranges is
// merged in shared memory (one 4-column sum a lane, 4 KB a CTA, whatever
// win and tile are) and stored once.  Window rows the tile does not touch
// are written as 0 by the group that stores the run before them (rows are
// sorted within a tile, so the keys are non-decreasing and the untouched
// rows are the gaps between consecutive keys), and by the tile's first group
// before its first key: each entry is written exactly once, with neither
// atomics nor a zeroing pass.  A lane issues 8 gathers before their FMAs,
// and registers are capped at 2 or 3 CTAs an SM (at 4 the gathers'
// registers spill).  At N = 128 one warp a column block (no
// slabs) measured faster than K3's 128-byte slabs: each slab re-stages the
// tile, and 8-lane groups walk ranges of 16 slots.
template <typename TV, typename TX, bool VEC, int MIN_CTAS>
__global__ void __launch_bounds__(kRangeThreads, MIN_CTAS)
vsr_spmm_spill_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                      const TV* __restrict__ vals, const float* __restrict__ scales,
                      const TX* __restrict__ x,
                      const int* __restrict__ row_base, float* __restrict__ part,
                      int n_tiles, int tile, int m, int n, int win, int lanes,
                      int tiles_per_cta, bool vec_slots) {
  extern __shared__ __align__(16) unsigned char spill_smem[];
  const int gpt = kRangeThreads / lanes / tiles_per_cta;  // groups a tile
  const int span = (tile + gpt - 1) / gpt;                 // slots a group
  const int stride = range_stride(span);
  const int words = tiles_per_cta * gpt * stride;
  float4* s_part = reinterpret_cast<float4*>(spill_smem);
  int* s_key = reinterpret_cast<int*>(s_part + kRangeThreads);
  int* s_col = s_key + words;
  float* s_val = reinterpret_cast<float*>(s_col + words);
  // where slot i of the CTA's tile tt lies in shared memory
  const auto spos = [&](int tt, int i) { return (tt * gpt + i / span) * stride + i % span; };

  // stage the CTA's tiles, rows turned into window keys (win for padding)
  const int t0 = blockIdx.x * tiles_per_cta;
  const int n_here = min(tiles_per_cta, n_tiles - t0);
  stage_slots<TV, kRangeThreads>(
      rows, cols, vals, static_cast<long long>(t0) * tile, n_here * tile, vec_slots,
      [&](int j, int r, int c, float v) {
        const int tt = j / tile;
        const int at = spos(tt, j - tt * tile);
        if constexpr (is_coded<TV>()) v *= __ldg(scales + t0 + tt);
        s_key[at] = r < m ? min(max(r - __ldg(row_base + t0 + tt), 0), win - 1) : win;
        s_col[at] = c;
        s_val[at] = v;
      });
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
  const auto key_at = [&](int i) { return s_key[spos(tt, i)]; };
  float* out = part + static_cast<long long>(t0 + tt) * win * n + c;
  // the run of window row w ends with sum a; the window rows up to the next
  // key nk are untouched by the tile
  const auto close = [&](int w, const float (&a)[4], int nk) {
    store4<VEC>(out + static_cast<long long>(w) * n, c, n, a);
    const float z[4] = {0.f, 0.f, 0.f, 0.f};
    for (int u = w + 1; u < min(nk, win); ++u)
      store4<VEC>(out + static_cast<long long>(u) * n, c, n, z);
  };

  float head[4] = {0.f, 0.f, 0.f, 0.f};  // the range's first run, if it crossed in
  int head_key = win, head_next = win;   // its key, and the key after it
  if (live) {
    const int at0 = (tt * gpt + gi) * stride;
    const int len = end - start;
    const int kf = s_key[at0], kl = s_key[at0 + len - 1];
    if (gi == 0) {
      const float z[4] = {0.f, 0.f, 0.f, 0.f};
      for (int u = 0; u < min(kf, win); ++u)
        store4<VEC>(out + static_cast<long long>(u) * n, c, n, z);
    }
    const bool cross_in = start > 0 && key_at(start - 1) == kf && kf < win;
    const bool cross_out = end < tile && key_at(end) == kl && kl < win;
    accumulate_runs<TX, VEC, kSpillGathers, true>(
        s_key + at0, s_col + at0, s_val + at0, len, end < tile ? key_at(end) : win, x, win,
        n, c, [&](int k, const float (&a)[4], int nk) {
          if (k == kl && cross_out) {  // goes on in the next range
            s_part[threadIdx.x] = make_float4(a[0], a[1], a[2], a[3]);
          } else if (k == kf && cross_in) {
#pragma unroll
            for (int j = 0; j < 4; ++j) head[j] = a[j];
            head_key = k;
            head_next = nk;
          } else {
            close(k, a, nk);
          }
        });
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
    close(head_key, head, head_next);
  }
}

template <typename TV, typename TX>
int launch_vsr_spmm_spill(const int* rows, const int* cols, const void* vals,
                          const float* scales, const void* x,
                          const int* row_base, float* part,
                          int n_tiles, int tile, int m, int n, int win,
                          int lanes, cudaStream_t stream) {
  const RangeLayout lay = range_layout(tile, lanes);
  const dim3 grid((n_tiles + lay.tiles_per_cta - 1) / lay.tiles_per_cta,
                  (n + 4 * lanes - 1) / (4 * lanes));
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  const bool vec_slots = vector_slots<TV>(rows, cols, vals, tile);
  const auto run = [&](auto kernel) {
    return launch_ranges(kernel, grid, lay.smem, stream, rows, cols, v, scales, xx, row_base,
                         part, n_tiles, tile, m, n, win, lanes, lay.tiles_per_cta,
                         vec_slots);
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

// K1's sr design.  rows/cols: (n_tiles, tile) int32; vals: (n_tiles, tile)
// of vals_type (0 f32, 1 bf16, 2 int8 codes, 3 fp8 e4m3 codes); scales:
// (n_tiles,) f32, the codes' scales (read for codes only, required there);
// x: (K, n) row-major f32 or bf16; y: (m, n) f32, zeroed.  lanes: lanes of
// a group (1, 2, ..., 32), which own 4·lanes columns of a column block.
// Returns the cudaError_t of the launch.
extern "C" int repro_vsr_sr(const int* rows, const int* cols, const void* vals,
                            int vals_type, const float* scales, const void* x,
                            int x_bf16, float* y, int n_tiles, int tile, int m,
                            int n, int lanes, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || (vals_type >= 2 && !scales))
    return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH_VALUE_TYPES(vals_type, x_bf16, repro_torch::launch_vsr_sr,
                                    rows, cols, vals, scales, x, y, n_tiles, tile,
                                    m, n, lanes, static_cast<cudaStream_t>(stream));
}

// K4.  rows/cols/vals/scales and x as for repro_vsr_sr; row_base:
// (n_tiles,) int32; part: (n_tiles, win, n) f32, fully written.  lanes:
// lanes of a group (1, 2, ..., 32), which own 4·lanes columns of a column
// block.  Returns the launch's cudaError_t.
extern "C" int repro_vsr_spmm_spill(const int* rows, const int* cols,
                                    const void* vals, int vals_type,
                                    const float* scales, const void* x,
                                    int x_bf16, const int* row_base,
                                    float* part, int n_tiles, int tile, int m,
                                    int n, int win, int lanes, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || (vals_type >= 2 && !scales))
    return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH_VALUE_TYPES(vals_type, x_bf16,
                                    repro_torch::launch_vsr_spmm_spill, rows, cols,
                                    vals, scales, x, row_base, part, n_tiles, tile,
                                    m, n, win, lanes, static_cast<cudaStream_t>(stream));
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
