// K2 — VSR SpMV, y = A·x for N = 1, on the BalancedCOO substrate, and K5,
// its spill variant.
//
// K2 replaces the TPU kernel src/repro/kernels/spmv.py::_spmv_fused_kernel
// (pallas_call in _spmv_fused_call), K5 src/repro/kernels/spmv.py::
// _spmv_kernel (pallas_call in _spmv_call): p = vals·x[cols], a log2-depth
// "add if same row" prefix scan, and a dump of each segment's end — into y
// (K2), or into the tile's (WIN,) window of an (n_tiles, WIN) partials
// buffer that a segment sum outside the kernel combines (K5).
//
// Bound on H100: bytes.  12 B of substrate plus one gathered 4 B element of
// x per nonzero against 2 flops; the scattered x[cols] reads (32 B sectors
// for 4 useful bytes when columns do not repeat) are the cost.  K5 also
// writes its 4·n_tiles·WIN B of partials.
//
// Design: the paper's Fig. 2(e) as written for a GPU.  One warp owns one
// BalancedCOO tile (equal nonzeros per warp) and walks it 32 nonzeros at a
// time with coalesced loads.  Each 32-chunk runs a segmented inclusive scan
// keyed on row id with __shfl_up_sync — the TPU kernel's jnp.roll network,
// now on real lanes.  The run that reaches lane 31 carries into the next
// chunk in registers, so each row run in a tile costs one atomicAdd into the
// caller-zeroed y (K2), or one plain store into the tile's window (K5), at
// the lane where it ends.  The TPU's sequential-grid block revisit is not
// needed: atomics resolve rows shared by two tiles (K2), and K5's caller
// sums the windows of such rows.
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

// K5 — the spill variant: the same scan, each run's sum stored into the
// tile's (win,) window of the partials at row - row_base[tile] (clamped to
// the window, as the reference clamps).  Rows are sorted within a tile, so
// each (tile, row) run is stored once, with a plain store; the warp first
// zeroes its window, so rows the tile does not touch read 0.
template <typename TV, typename TX>
__global__ void __launch_bounds__(kSpmvThreads)
vsr_spmv_spill_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                      const TV* __restrict__ vals, const TX* __restrict__ x,
                      const int* __restrict__ row_base, float* __restrict__ part,
                      int n_tiles, int tile, int m, int win) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_tiles) return;  // whole warps exit together
  float* out = part + static_cast<long long>(warp) * win;
  const int first = row_base[warp];
  for (int w = lane; w < win; w += 32) out[w] = 0.f;
  __syncwarp();  // the zeroes land before any lane's run store
  scan_tile(rows, cols, vals, x, static_cast<long long>(warp) * tile, tile, m,
            lane, [out, first, win](int r, float v) {
              out[min(max(r - first, 0), win - 1)] = v;
            });
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
  vsr_spmv_spill_kernel<TV, TX><<<grid, kSpmvThreads, 0, stream>>>(
      rows, cols, static_cast<const TV*>(vals), static_cast<const TX*>(x),
      row_base, part, n_tiles, tile, m, win);
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
