// K2 — VSR SpMV, y = A·x for N = 1, on the BalancedCOO substrate, and K5,
// its spill variant.
//
// K2 replaces the TPU kernel src/repro/kernels/spmv.py::_spmv_fused_kernel
// (pallas_call in _spmv_fused_call), K5 src/repro/kernels/spmv.py::
// _spmv_kernel (pallas_call in _spmv_call): p = vals·x[cols], a log2-depth
// "add if same row" prefix scan, and a dump of each segment's end — into y
// (K2), or into the tile's (WIN,) window of an (n_tiles, WIN) partials
// buffer that a segment sum outside the kernel combines (K5; the combine is
// csrc/vsr.cu's spill_combine_kernel).
//
// Bound on H100: bytes.  12 B of substrate plus one gathered 4 B element of
// x per nonzero against 2 flops; the scattered x[cols] reads (32 B sectors
// for 4 useful bytes when columns do not repeat) are the cost.  K5 also
// writes its 4·n_tiles·WIN B of partials.
//
// K2's design: the paper's Fig. 2(e) as written for a GPU.  One warp owns
// one BalancedCOO tile (equal nonzeros per warp) and walks it 32 nonzeros at
// a time with coalesced loads.  Each 32-chunk runs a segmented inclusive scan
// keyed on row id with __shfl_up_sync — the TPU kernel's jnp.roll network,
// now on real lanes.  The run that reaches lane 31 carries into the next
// chunk in registers, so each row run in a tile costs one atomicAdd into the
// caller-zeroed y at the lane where it ends.  The TPU's sequential-grid
// block revisit is not needed: atomics resolve rows shared by two tiles.
//
// K5's design: one warp a tile, with more loads in flight and fewer
// shuffles a slot.  A lane takes 4 adjacent slots of a 128-slot step, each
// of rows, cols and vals by one 16-byte load (8-byte for bf16 vals;
// evict-first, so the substrate leaves L2 to x), the next step's loads issued
// before this step's work, and gathers x at its 4 columns before any
// arithmetic.  Runs are keyed on the clamped window row min(max(r − row_base,
// 0), WIN − 1), as the reference keys its one-hot dump, so rows that clamp
// onto one window row add there (fault 3.4: keyed on the row, they were
// stored over each other).  The reduction is the paper's segment reduction in
// two stages: a sequential segmented sum over the lane's 4 slots, then one
// __shfl_up_sync segmented scan across the warp on (the lane's last key, its
// trailing sum): 10 shuffles a 128-slot step instead of a 32-slot chunk.  A
// run that ends inside a lane is stored by that lane; the run reaching lane
// 31 carries into the next step in registers.  Each window entry is written
// once, with a plain store and no zeroing pass: the lane that stores a run
// also writes 0 to the window rows between its key and the next slot's (rows
// sorted within a tile make the keys non-decreasing), and lane 0 the rows
// before the tile's first key.  Tiles that are no multiple of 4 slots, or
// operands not aligned for 16-byte loads, take scalar loads, never past the
// tile.  What K5 waits on is its x gathers: on H100 it takes as long as
// PyTorch's index_select of x at the same columns, a third of that without
// them, and 8 slots a lane or more warps an SM did not help.
#include "common.cuh"

namespace repro_torch {

constexpr int kSpmvThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// The segmented scan of one warp's tile: p = vals·x[cols] a 32-chunk at a
// time, a __shfl_up_sync inclusive scan keyed on row id, the run reaching
// lane 31 carried into the next chunk; each run of a row, padding (row >= m)
// excluded, is handed to dump(row, sum) once, at the lane where it ends.
template <typename TV, typename TX, typename Dump>
__device__ __forceinline__ void scan_tile(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const TV* __restrict__ vals, const TX* __restrict__ x, long long base,
    int tile, int m, int lane, Dump dump) {
  int carry_row = -1;
  float carry = 0.f;
  for (int off = 0; off < tile; off += 32) {
    const int i = off + lane;
    int r = m;  // lanes past the tile's end act as padding
    float p = 0.f;
    if (i < tile) {
      r = rows[base + i];
      if (r < m) p = to_f32(vals[base + i]) * to_f32(x[cols[base + i]]);
    }
    // segmented inclusive scan: rows are non-decreasing, so a same-row
    // neighbour d lanes back means every lane in between shares the row
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float pv = __shfl_up_sync(kFullMask, p, d);
      const int rv = __shfl_up_sync(kFullMask, r, d);
      if (lane >= d && rv == r) p += pv;
    }
    // the run carried out of the last chunk either continues here (rows are
    // sorted, so only a prefix of lanes can share it) or ended there
    if (r == carry_row) p += carry;
    else if (lane == 0 && carry_row >= 0 && carry_row < m) dump(carry_row, carry);
    const int r_next = __shfl_down_sync(kFullMask, r, 1);
    if (lane < 31 && r_next != r && r < m) dump(r, p);
    carry_row = __shfl_sync(kFullMask, r, 31);
    carry = __shfl_sync(kFullMask, p, 31);
  }
  if (lane == 0 && carry_row >= 0 && carry_row < m) dump(carry_row, carry);
}

template <typename TV, typename TX>
__global__ void __launch_bounds__(kSpmvThreads)
vsr_spmv_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                const TV* __restrict__ vals, const TX* __restrict__ x,
                float* __restrict__ y, int n_tiles, int tile, int m) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_tiles) return;  // whole warps exit together
  scan_tile(rows, cols, vals, x, static_cast<long long>(warp) * tile, tile, m,
            lane, [y](int r, float v) { atomicAdd(&y[r], v); });
}

// Slots a K5 lane takes a step (a multiple of 4), and slots a warp step.
constexpr int kSpillSlots = 4;
constexpr int kSpillStep = 32 * kSpillSlots;

// A lane's adjacent slots of a tile, as K5 reads them: keys (the clamped
// window row; WIN for padding and for slots past the tile), columns and
// values.
struct LaneSlots {
  int key[kSpillSlots];
  int col[kSpillSlots];
  float val[kSpillSlots];
};

// Slots i .. i+kSpillSlots-1 of the tile at `base`.  VEC: 16-byte loads of
// rows and cols and 16- (f32) or 8-byte (bf16) loads of vals; the caller
// guarantees tile % 4 == 0 and the alignment, so i + 4q < tile covers four.
template <typename TV, bool VEC>
__device__ __forceinline__ LaneSlots load_slots(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const TV* __restrict__ vals, long long base, int i, int tile, int m,
    int first, int win) {
  LaneSlots s;
  int r[kSpillSlots];
#pragma unroll
  for (int j = 0; j < kSpillSlots; ++j) {
    r[j] = m;
    s.col[j] = 0;
    s.val[j] = 0.f;
  }
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < kSpillSlots; q += 4) {
      if (i + q < tile) {
        const long long at = base + i + q;
        const int4 rr = __ldcs(reinterpret_cast<const int4*>(rows + at));
        const int4 cc = __ldcs(reinterpret_cast<const int4*>(cols + at));
        r[q] = rr.x; r[q + 1] = rr.y; r[q + 2] = rr.z; r[q + 3] = rr.w;
        s.col[q] = cc.x; s.col[q + 1] = cc.y; s.col[q + 2] = cc.z; s.col[q + 3] = cc.w;
        if constexpr (std::is_same<TV, float>::value) {
          const float4 vv = __ldcs(reinterpret_cast<const float4*>(vals + at));
          s.val[q] = vv.x; s.val[q + 1] = vv.y; s.val[q + 2] = vv.z; s.val[q + 3] = vv.w;
        } else {
          const uint2 u = __ldcs(reinterpret_cast<const uint2*>(vals + at));
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
          s.val[q] = lo.x; s.val[q + 1] = lo.y; s.val[q + 2] = hi.x; s.val[q + 3] = hi.y;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSpillSlots; ++j) {
      if (i + j < tile) {
        r[j] = __ldcs(rows + base + i + j);
        s.col[j] = __ldcs(cols + base + i + j);
        s.val[j] = to_f32(vals[base + i + j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSpillSlots; ++j)
    s.key[j] = r[j] < m ? min(max(r[j] - first, 0), win - 1) : win;
  return s;
}

// K5 — the spill variant: the tile's run sums, keyed on the clamped window
// row, into its (win,) window of the partials; every entry written once.
template <typename TV, typename TX, bool VEC>
__global__ void __launch_bounds__(kSpmvThreads)
vsr_spmv_spill_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                      const TV* __restrict__ vals, const TX* __restrict__ x,
                      const int* __restrict__ row_base, float* __restrict__ part,
                      int n_tiles, int tile, int m, int win) {
  constexpr int L = kSpillSlots;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_tiles) return;  // whole warps exit together
  const long long base = static_cast<long long>(warp) * tile;
  float* out = part + static_cast<long long>(warp) * win;
  const int first = row_base[warp];
  // the run of window row k ends with sum v; the window rows up to the next
  // slot's key nk are untouched by the tile
  const auto close = [&](int k, float v, int nk) {
    if (k >= win) return;  // padding
    out[k] = v;
    for (int w = k + 1; w < min(nk, win); ++w) out[w] = 0.f;
  };

  LaneSlots cur = load_slots<TV, VEC>(rows, cols, vals, base, L * lane, tile, m, first, win);
  if (lane == 0)
    for (int w = 0; w < min(cur.key[0], win); ++w) out[w] = 0.f;
  int carry_key = win;  // the run carried out of the last step
  float carry = 0.f;
  for (int off = 0; off < tile; off += kSpillStep) {
    const LaneSlots nxt = load_slots<TV, VEC>(rows, cols, vals, base,
                                              off + kSpillStep + L * lane, tile, m, first, win);
    float p[L];
    int k[L];
#pragma unroll
    for (int j = 0; j < L; ++j) p[j] = cur.key[j] < win ? to_f32(x[cur.col[j]]) : 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      p[j] *= cur.val[j];
      k[j] = cur.key[j];
    }
    // the carried run continues into lane 0 here (keys are sorted, so only
    // there) or ended at the last step's end
    if (lane == 0) {
      if (carry_key == k[0]) p[0] += carry;
      else close(carry_key, carry, k[0]);
    }
    // stage 1: the lane's runs in order; a run that both starts and ends
    // inside the lane is whole and stored now
    float s = p[0], head = 0.f;
    int head_next = win;  // the key after the lane's first run, if it ends here
    bool one_run = true;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      if (k[j] != k[j - 1]) {
        if (one_run) {
          head = s;
          head_next = k[j];
          one_run = false;
        } else {
          close(k[j - 1], s, k[j]);
        }
        s = 0.f;
      }
      s += p[j];
    }
    // stage 2: segmented inclusive scan of the lanes' trailing sums, keyed
    // on the lane's last key (sorted keys: an equal key d lanes back means
    // every lane between is that one run)
    float t = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float tv = __shfl_up_sync(kFullMask, t, d);
      const int kv = __shfl_up_sync(kFullMask, k[L - 1], d);
      if (lane >= d && kv == k[L - 1]) t += tv;
    }
    const float t_prev = __shfl_up_sync(kFullMask, t, 1);
    const int k_prev = __shfl_up_sync(kFullMask, k[L - 1], 1);
    const int k_next = __shfl_down_sync(kFullMask, k[0], 1);
    // the lane's first run, when it ends inside the lane, with what the
    // lanes before it hold of it
    if (!one_run) close(k[0], head + (lane > 0 && k_prev == k[0] ? t_prev : 0.f), head_next);
    // the lane's last run, when it ends at the lane's end
    if (lane < 31 && k_next != k[L - 1]) close(k[L - 1], t, k_next);
    carry_key = __shfl_sync(kFullMask, k[L - 1], 31);
    carry = __shfl_sync(kFullMask, t, 31);
    cur = nxt;
  }
  if (lane == 0) close(carry_key, carry, win);
}

template <typename TV, typename TX>
int launch_vsr_spmv(const int* rows, const int* cols, const void* vals,
                    const void* x, float* y, int n_tiles, int tile, int m,
                    cudaStream_t stream) {
  const int warps_per_cta = kSpmvThreads / 32;
  const int grid = (n_tiles + warps_per_cta - 1) / warps_per_cta;
  vsr_spmv_kernel<TV, TX><<<grid, kSpmvThreads, 0, stream>>>(
      rows, cols, static_cast<const TV*>(vals), static_cast<const TX*>(x), y,
      n_tiles, tile, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename TV, typename TX>
int launch_vsr_spmv_spill(const int* rows, const int* cols, const void* vals,
                          const void* x, const int* row_base, float* part,
                          int n_tiles, int tile, int m, int win,
                          cudaStream_t stream) {
  const int warps_per_cta = kSpmvThreads / 32;
  const int grid = (n_tiles + warps_per_cta - 1) / warps_per_cta;
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  const bool vec = tile % 4 == 0 &&
                   (reinterpret_cast<std::uintptr_t>(rows) | reinterpret_cast<std::uintptr_t>(cols)) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(vals) % (4 * sizeof(TV)) == 0;
  if (vec)
    vsr_spmv_spill_kernel<TV, TX, true><<<grid, kSpmvThreads, 0, stream>>>(
        rows, cols, v, xx, row_base, part, n_tiles, tile, m, win);
  else
    vsr_spmv_spill_kernel<TV, TX, false><<<grid, kSpmvThreads, 0, stream>>>(
        rows, cols, v, xx, row_base, part, n_tiles, tile, m, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; vals: (n_tiles, tile) f32 or bf16;
// x: (K,) f32 or bf16; y: (m,) f32, zeroed.  Returns the launch's
// cudaError_t.
extern "C" int repro_vsr_spmv(const int* rows, const int* cols,
                              const void* vals, int vals_bf16, const void* x,
                              int x_bf16, float* y, int n_tiles, int tile,
                              int m, void* stream) {
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16, repro_torch::launch_vsr_spmv,
                              rows, cols, vals, x, y, n_tiles, tile, m,
                              static_cast<cudaStream_t>(stream));
}

// K5.  rows/cols/vals and x as for repro_vsr_spmv; row_base: (n_tiles,)
// int32; part: (n_tiles, win) f32, fully written.  Returns the launch's
// cudaError_t.
extern "C" int repro_vsr_spmv_spill(const int* rows, const int* cols,
                                    const void* vals, int vals_bf16,
                                    const void* x, int x_bf16,
                                    const int* row_base, float* part,
                                    int n_tiles, int tile, int m, int win,
                                    void* stream) {
  return REPRO_DISPATCH_TYPES(vals_bf16, x_bf16,
                              repro_torch::launch_vsr_spmv_spill, rows, cols,
                              vals, x, row_base, part, n_tiles, tile, m, win,
                              static_cast<cudaStream_t>(stream));
}
