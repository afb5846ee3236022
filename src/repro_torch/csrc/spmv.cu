// K2 — VSR SpMV, y = A·x for N = 1, on the BalancedCOO substrate; K1's pr
// design, the same kernel on 4-column pieces of X rows; and K5, K2's spill
// variant.
//
// K2 replaces the TPU kernel src/repro/kernels/spmv.py::_spmv_fused_kernel
// (pallas_call in _spmv_fused_call), K5 src/repro/kernels/spmv.py::
// _spmv_kernel (pallas_call in _spmv_call): p = vals·x[cols], a log2-depth
// "add if same row" prefix scan, and a dump of each segment's end — into y
// (K2), or into the tile's (WIN,) window of an (n_tiles, WIN) partials
// buffer that a segment sum outside the kernel combines (K5; the combine is
// csrc/vsr.cu's spill_combine_kernel).  K1's pr design replaces
// src/repro/kernels/vsr.py::_vsr_fused_kernel for nb_pr (see csrc/vsr.cu).
//
// Bound on H100: bytes.  12 B of substrate plus one gathered 4 B element of
// x per nonzero against 2 flops; the scattered x[cols] reads (32 B sectors
// for 4 useful bytes when columns do not repeat) are the cost.  K5 also
// writes its 4·n_tiles·WIN B of partials.  K1's pr design gathers one
// 4-column piece of an X row a nonzero.
//
// Design, all three: one warp a tile (equal nonzeros per warp), the paper's
// Fig. 2(e) with more loads in flight and fewer shuffles a slot.  A lane
// takes 4 adjacent slots of a 128-slot step, each of rows, cols and vals by
// one 16-byte load (8-byte for bf16 vals; evict-first, so the substrate
// leaves L2 to x), the next step's loads issued before this step's work, and
// gathers x at its 4 columns before any arithmetic (K2: unconditionally,
// padding's products dropped).  The reduction is the paper's segment
// reduction in two stages (scan_step): a sequential segmented sum over the
// lane's 4 slots, then one __shfl_up_sync segmented scan across the warp on
// (the lane's last key, its trailing sum): 10 shuffles a 128-slot step.  A
// run that ends inside a lane is closed by that lane; the run reaching lane
// 31 carries into the next step in registers.  Tiles that are no multiple
// of 4 slots, or operands not aligned for 16-byte loads, take scalar loads,
// never past the tile.
//
// K2 and K1's pr design key runs on the row and rely on the slab's order
// (rows non-decreasing, so a row continues only from one tile into the
// next): a run that holds neither the tile's first slot nor the slot before
// a padding slot or the tile's end is a whole row and is written with a
// plain store; the tile's first and last runs add by atomicAdd into the
// zeroed y, so an empty row stays 0.  K1's pr design gathers, for each slot,
// the 4 columns of its column block (blockIdx.y, the grid's slow dimension)
// by one 16-byte load (8 bytes for bf16 X) where N % 4 == 0 and X is aligned;
// at N <= 4 that piece is the whole row.  An X of one column takes K2's
// kernel.
//
// K5 keys runs on the clamped window row min(max(r − row_base, 0), WIN − 1),
// as the reference keys its one-hot dump, so rows that clamp onto one window
// row add there (fault 3.4: keyed on the row, they were stored over each
// other).  Each window entry is written once, with a plain store and no
// zeroing pass: the lane that stores a run also writes 0 to the window rows
// between its key and the next slot's (rows sorted within a tile make the
// keys non-decreasing), and lane 0 the rows before the tile's first key.
// What K5 waits on is its x gathers: on H100 it takes as long as PyTorch's
// index_select of x at the same columns, a third of that without them, and
// 8 slots a lane or more warps an SM did not help.
//
// Quantized value slabs (the TPU kernels' quant branches, spmv.py:134-143
// and :38-46): with TV = int8_t or __nv_fp8_e4m3 the slab holds codes and
// `scales` one f32 scale a tile.  A lane reads its 4 codes by one 4-byte
// load (load_slots) and multiplies each by the warp's tile scale in f32, so
// the product is (code·scale)·x, as in the reference.  Bound: 9 B a nonzero
// and 4 B a tile of substrate (12 B a nonzero for f32).  For f32 and bf16
// slabs `scales` is not read.
#include "common.cuh"

namespace repro_torch {

constexpr int kSpmvThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// Slots a lane takes a step (a multiple of 4), and slots a warp step.
constexpr int kLaneSlots = 4;
constexpr int kWarpStep = 32 * kLaneSlots;

// A lane's adjacent slots of a tile: keys, columns and values.
struct LaneSlots {
  int key[kLaneSlots];
  int col[kLaneSlots];
  float val[kLaneSlots];
};

// Slots i .. i+kLaneSlots-1 of the tile at `base`, each row r turned into
// key(r); a slot past the tile has row m, column 0 and value 0.  VEC:
// 16-byte loads of rows and cols and 16- (f32), 8- (bf16) or 4-byte (int8,
// fp8 codes) loads of vals; the caller guarantees tile % 4 == 0 and the
// alignment, so i + 4q < tile covers four.  Codes are multiplied by the
// tile's `scale` (not read for f32 and bf16 slabs).
template <typename TV, bool VEC, typename Key>
__device__ __forceinline__ LaneSlots load_slots(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const TV* __restrict__ vals, long long base, int i, int tile, int m,
    float scale, Key key) {
  LaneSlots s;
  int r[kLaneSlots];
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) {
    r[j] = m;
    s.col[j] = 0;
    s.val[j] = 0.f;
  }
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < kLaneSlots; q += 4) {
      if (i + q < tile) {
        const long long at = base + i + q;
        const int4 rr = __ldcs(reinterpret_cast<const int4*>(rows + at));
        const int4 cc = __ldcs(reinterpret_cast<const int4*>(cols + at));
        r[q] = rr.x; r[q + 1] = rr.y; r[q + 2] = rr.z; r[q + 3] = rr.w;
        s.col[q] = cc.x; s.col[q + 1] = cc.y; s.col[q + 2] = cc.z; s.col[q + 3] = cc.w;
        const float4 vv = load_vals4(vals + at);
        s.val[q] = vv.x; s.val[q + 1] = vv.y; s.val[q + 2] = vv.z; s.val[q + 3] = vv.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {
      if (i + j < tile) {
        r[j] = __ldcs(rows + base + i + j);
        s.col[j] = __ldcs(cols + base + i + j);
        s.val[j] = to_f32(vals[base + i + j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLaneSlots; ++j) s.key[j] = key(r[j]);
  if constexpr (is_coded<TV>()) {
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) s.val[j] *= scale;
  }
  return s;
}

// One warp step of the segmented reduction: the lane's slots, keys k
// (non-decreasing along the warp; a key >= `none` is padding) and C-column
// products p.  The run carried in (carry_key, carry) from the last step
// continues into lane 0's first slot or ended before it; the run reaching
// lane 31 is carried out.  Every other run that ends in the step goes once
// to close(key, sum, next_key), called by the lane where it ends, next_key
// being the key of the slot after it.
template <int C, typename Close>
__device__ __forceinline__ void scan_step(const int (&k)[kLaneSlots],
                                          float (&p)[kLaneSlots][C], int none,
                                          int lane, int& carry_key, float (&carry)[C],
                                          Close close) {
  constexpr int L = kLaneSlots;
  // the carried run continues into lane 0 here (keys are sorted, so only
  // there) or ended at the last step's end
  if (lane == 0) {
    if (carry_key == k[0]) {
#pragma unroll
      for (int c = 0; c < C; ++c) p[0][c] += carry[c];
    } else {
      close(carry_key, carry, k[0]);
    }
  }
  // stage 1: the lane's runs in order; a run that both starts and ends
  // inside the lane is whole and closed now
  float s[C], head[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    s[c] = p[0][c];
    head[c] = 0.f;
  }
  int head_next = none;  // the key after the lane's first run, if it ends here
  bool one_run = true;
#pragma unroll
  for (int j = 1; j < L; ++j) {
    if (k[j] != k[j - 1]) {
      if (one_run) {
#pragma unroll
        for (int c = 0; c < C; ++c) head[c] = s[c];
        head_next = k[j];
        one_run = false;
      } else {
        close(k[j - 1], s, k[j]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] += p[j][c];
  }
  // stage 2: segmented inclusive scan of the lanes' trailing sums, keyed on
  // the lane's last key (sorted keys: an equal key d lanes back means every
  // lane between is that one run)
  float t[C];
#pragma unroll
  for (int c = 0; c < C; ++c) t[c] = s[c];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int kv = __shfl_up_sync(kFullMask, k[L - 1], d);
    float tv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) tv[c] = __shfl_up_sync(kFullMask, t[c], d);
    if (lane >= d && kv == k[L - 1]) {
#pragma unroll
      for (int c = 0; c < C; ++c) t[c] += tv[c];
    }
  }
  const int k_prev = __shfl_up_sync(kFullMask, k[L - 1], 1);
  const int k_next = __shfl_down_sync(kFullMask, k[0], 1);
  float t_prev[C];
#pragma unroll
  for (int c = 0; c < C; ++c) t_prev[c] = __shfl_up_sync(kFullMask, t[c], 1);
  // the lane's first run, when it ends inside the lane, with what the lanes
  // before it hold of it
  if (!one_run) {
    if (lane > 0 && k_prev == k[0]) {
#pragma unroll
      for (int c = 0; c < C; ++c) head[c] += t_prev[c];
    }
    close(k[0], head, head_next);
  }
  // the lane's last run, when it ends at the lane's end
  if (lane < 31 && k_next != k[L - 1]) close(k[L - 1], t, k_next);
  carry_key = __shfl_sync(kFullMask, k[L - 1], 31);
#pragma unroll
  for (int c = 0; c < C; ++c) carry[c] = __shfl_sync(kFullMask, t[c], 31);
}

// K2 (C = 1) and K1's pr design (C = 4): one warp a tile, runs keyed on the
// row; VEC_X: one 16-byte (8-byte bf16) gather of a 4-column piece of X.
template <typename TV, typename TX, int C, bool VEC, bool VEC_X>
__global__ void __launch_bounds__(kSpmvThreads)
vsr_scan_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                const TV* __restrict__ vals, const float* __restrict__ scales,
                const TX* __restrict__ x, float* __restrict__ y, int n_tiles,
                int tile, int m, int n) {
  constexpr int L = kLaneSlots;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_tiles) return;  // whole warps exit together
  const long long base = static_cast<long long>(warp) * tile;
  const int c0 = 4 * blockIdx.y;  // the column block (C = 4)
  const auto row = [](int r) { return r; };
  const float scale = is_coded<TV>() ? __ldg(scales + warp) : 1.f;

  LaneSlots cur = load_slots<TV, VEC>(rows, cols, vals, base, L * lane, tile, m, scale, row);
  const int first = __shfl_sync(kFullMask, cur.key[0], 0);  // the tile's first row
  // a run of row r ends with sum v before a slot of row nr (m: padding or
  // the tile's end): an edge run of the tile adds, any other is stored
  const auto close = [&](int r, const float (&v)[C], int nr) {
    if (r >= m) return;  // padding
    float* at = y + static_cast<long long>(r) * n + c0;
    const bool edge = r == first || nr >= m;
    if constexpr (C == 1) {
      if (edge) atomicAdd(at, v[0]);
      else *at = v[0];
    } else {
      if (edge) atomic_add4(at, c0, n, v);
      else store4<VEC_X>(at, c0, n, v);
    }
  };
  int carry_key = m;  // the run carried out of the last step
  float carry[C];
#pragma unroll
  for (int c = 0; c < C; ++c) carry[c] = 0.f;
  for (int off = 0; off < tile; off += kWarpStep) {
    const LaneSlots nxt = load_slots<TV, VEC>(rows, cols, vals, base,
                                              off + kWarpStep + L * lane, tile, m, scale,
                                              row);
    float p[L][C];
    // the gathers first, all of them (a padding slot reads x's row 0)
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if constexpr (C == 1) {
        p[j][0] = to_f32(x[cur.col[j]]);
      } else {
        load4<TX, VEC_X>(x + static_cast<long long>(cur.col[j]) * n, c0, n, p[j]);
      }
    }
    int k[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      k[j] = cur.key[j];
#pragma unroll
      for (int c = 0; c < C; ++c) p[j][c] = k[j] < m ? p[j][c] * cur.val[j] : 0.f;
    }
    scan_step<C>(k, p, m, lane, carry_key, carry, close);
    cur = nxt;
  }
  if (lane == 0) close(carry_key, carry, m);
}

// K5 — the spill variant: the tile's run sums, keyed on the clamped window
// row, into its (win,) window of the partials; every entry written once.
template <typename TV, typename TX, bool VEC>
__global__ void __launch_bounds__(kSpmvThreads)
vsr_spmv_spill_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                      const TV* __restrict__ vals, const float* __restrict__ scales,
                      const TX* __restrict__ x,
                      const int* __restrict__ row_base, float* __restrict__ part,
                      int n_tiles, int tile, int m, int win) {
  constexpr int L = kLaneSlots;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_tiles) return;  // whole warps exit together
  const long long base = static_cast<long long>(warp) * tile;
  float* out = part + static_cast<long long>(warp) * win;
  const int first = row_base[warp];
  const auto key = [=](int r) { return r < m ? min(max(r - first, 0), win - 1) : win; };
  // the run of window row k ends with sum v; the window rows up to the next
  // slot's key nk are untouched by the tile
  const auto close = [&](int k, const float (&v)[1], int nk) {
    if (k >= win) return;  // padding
    out[k] = v[0];
    for (int w = k + 1; w < min(nk, win); ++w) out[w] = 0.f;
  };

  const float scale = is_coded<TV>() ? __ldg(scales + warp) : 1.f;
  LaneSlots cur = load_slots<TV, VEC>(rows, cols, vals, base, L * lane, tile, m, scale, key);
  if (lane == 0)
    for (int w = 0; w < min(cur.key[0], win); ++w) out[w] = 0.f;
  int carry_key = win;  // the run carried out of the last step
  float carry[1] = {0.f};
  for (int off = 0; off < tile; off += kWarpStep) {
    const LaneSlots nxt = load_slots<TV, VEC>(rows, cols, vals, base,
                                              off + kWarpStep + L * lane, tile, m, scale,
                                              key);
    float p[L][1];
    int k[L];
#pragma unroll
    for (int j = 0; j < L; ++j) p[j][0] = cur.key[j] < win ? to_f32(x[cur.col[j]]) : 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      p[j][0] *= cur.val[j];
      k[j] = cur.key[j];
    }
    scan_step<1>(k, p, win, lane, carry_key, carry, close);
    cur = nxt;
  }
  if (lane == 0) close(carry_key, carry, win);
}

// K2 (C = 1, n = 1) or K1's pr design (C = 4): a warp a tile, 4·blockIdx.y
// the column block.
template <typename TV, typename TX, int C>
int launch_vsr_scan(const int* rows, const int* cols, const void* vals,
                    const float* scales, const void* x, float* y, int n_tiles,
                    int tile, int m, int n, cudaStream_t stream) {
  const int warps_per_cta = kSpmvThreads / 32;
  const dim3 grid((n_tiles + warps_per_cta - 1) / warps_per_cta, C == 1 ? 1 : (n + 3) / 4);
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  const auto run = [&](auto kernel) {
    kernel<<<grid, REPRO_LAUNCH_THREADS(kSpmvThreads), 0, stream>>>(
        rows, cols, v, scales, xx, y, n_tiles, tile, m, n);
    return static_cast<int>(cudaGetLastError());
  };
  const bool vec = vector_slots<TV>(rows, cols, vals, tile);
  if constexpr (C == 4) {
    if (vector_rows<TX>(x, y, n))
      return vec ? run(vsr_scan_kernel<TV, TX, C, true, true>)
                 : run(vsr_scan_kernel<TV, TX, C, false, true>);
  }
  return vec ? run(vsr_scan_kernel<TV, TX, C, true, false>)
             : run(vsr_scan_kernel<TV, TX, C, false, false>);
}

// K1's pr design, and K2 (n = 1)
template <typename TV, typename TX>
int launch_vsr_pr(const int* rows, const int* cols, const void* vals,
                  const float* scales, const void* x, float* y, int n_tiles,
                  int tile, int m, int n, cudaStream_t stream) {
  if (n == 1)
    return launch_vsr_scan<TV, TX, 1>(rows, cols, vals, scales, x, y, n_tiles, tile, m, 1,
                                      stream);
  return launch_vsr_scan<TV, TX, 4>(rows, cols, vals, scales, x, y, n_tiles, tile, m, n,
                                    stream);
}

template <typename TV, typename TX>
int launch_vsr_spmv_spill(const int* rows, const int* cols, const void* vals,
                          const float* scales, const void* x,
                          const int* row_base, float* part,
                          int n_tiles, int tile, int m, int win,
                          cudaStream_t stream) {
  const int warps_per_cta = kSpmvThreads / 32;
  const int grid = (n_tiles + warps_per_cta - 1) / warps_per_cta;
  const TV* v = static_cast<const TV*>(vals);
  const TX* xx = static_cast<const TX*>(x);
  if (vector_slots<TV>(rows, cols, vals, tile))
    vsr_spmv_spill_kernel<TV, TX, true><<<grid, kSpmvThreads, 0, stream>>>(
        rows, cols, v, scales, xx, row_base, part, n_tiles, tile, m, win);
  else
    vsr_spmv_spill_kernel<TV, TX, false><<<grid, kSpmvThreads, 0, stream>>>(
        rows, cols, v, scales, xx, row_base, part, n_tiles, tile, m, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// rows/cols: (n_tiles, tile) int32; vals: (n_tiles, tile) of vals_type (0
// f32, 1 bf16, 2 int8 codes, 3 fp8 e4m3 codes); scales: (n_tiles,) f32, the
// codes' scales (read for codes only, required there); x: (K,) f32 or bf16;
// y: (m,) f32, zeroed.  Returns the launch's cudaError_t.
extern "C" int repro_vsr_spmv(const int* rows, const int* cols,
                              const void* vals, int vals_type,
                              const float* scales, const void* x, int x_bf16,
                              float* y, int n_tiles, int tile, int m,
                              void* stream) {
  if (vals_type >= 2 && !scales) return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH_VALUE_TYPES(vals_type, x_bf16, repro_torch::launch_vsr_pr,
                                    rows, cols, vals, scales, x, y, n_tiles, tile,
                                    m, 1, static_cast<cudaStream_t>(stream));
}

// K1's pr design.  rows/cols/vals/scales as for repro_vsr_spmv; x: (K, n)
// row-major f32 or bf16; y: (m, n) f32, zeroed.  Returns the launch's
// cudaError_t.
extern "C" int repro_vsr_pr(const int* rows, const int* cols, const void* vals,
                            int vals_type, const float* scales, const void* x,
                            int x_bf16, float* y, int n_tiles, int tile, int m,
                            int n, void* stream) {
  if (vals_type >= 2 && !scales) return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH_VALUE_TYPES(vals_type, x_bf16, repro_torch::launch_vsr_pr,
                                    rows, cols, vals, scales, x, y, n_tiles, tile,
                                    m, n, static_cast<cudaStream_t>(stream));
}

// K5.  rows/cols/vals/scales and x as for repro_vsr_spmv; row_base:
// (n_tiles,) int32; part: (n_tiles, win) f32, fully written.  Returns the
// launch's cudaError_t.
extern "C" int repro_vsr_spmv_spill(const int* rows, const int* cols,
                                    const void* vals, int vals_type,
                                    const float* scales, const void* x,
                                    int x_bf16, const int* row_base,
                                    float* part, int n_tiles, int tile, int m,
                                    int win, void* stream) {
  if (vals_type >= 2 && !scales) return static_cast<int>(cudaErrorInvalidValue);
  return REPRO_DISPATCH_VALUE_TYPES(vals_type, x_bf16,
                                    repro_torch::launch_vsr_spmv_spill, rows, cols,
                                    vals, scales, x, row_base, part, n_tiles, tile,
                                    m, win, static_cast<cudaStream_t>(stream));
}
