// Edge scores of the SDDMM family (K6-K10): e = <A[row], B[col]> for every
// slot of a balanced tile, in f32, computed by lane groups (K7-K10) or by
// K6's run-aware passes over staged slots (score_range_par,
// score_slots_seq); the packed softmax row statistics that K7 and K9 write
// and K8 and K10 read; and the segmented scan over a tile's row runs that
// K7, K8 and K9 share.
//
// For K7-K10, a lane group of `g` lanes owns one slot and splits the
// feature dimension d:
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

// The identity map of for_each_score_unrolled's indices onto slots.
struct SameSlot {
  __device__ int operator()(int i) const { return i; }
};

// One 16-byte piece of a feature row, and the dot product of two pieces in
// the row type (f32: 4 elements, bf16: 8).
template <typename TA>
__device__ __forceinline__ uint4 load16(const TA* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename TA>
__device__ __forceinline__ float dot16_bits(uint4 x, uint4 y) {
  if constexpr (sizeof(TA) == 4) {
    const float4 p = *reinterpret_cast<const float4*>(&x);
    const float4 q = *reinterpret_cast<const float4*>(&y);
    return p.x * q.x + p.y * q.y + p.z * q.z + p.w * q.w;
  } else {
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
}

// As for_each_score, for the slots slot_of(i), i in [lo, hi), and U slots
// a lane group at a time: where each lane reads one 16-byte piece of each
// row (d at most 32 pieces), the loads of all U slots are issued before any
// product, so a group keeps U pairs of rows in flight.  K7 and K8 use it:
// they fold the scores in shared memory after the loop, time in which the
// CTA issues no loads, so each of their warps must keep more of them in
// flight than the slot-tile K9's and K10's.
template <typename TA, int U, typename Emit, typename SlotOf = SameSlot>
__device__ __forceinline__ void for_each_score_unrolled(
    const int* __restrict__ rows, const int* __restrict__ cols,
    const TA* __restrict__ a, const TA* __restrict__ b, long long base,
    int lo, int hi, int m, int d, int g, bool vec, Emit emit,
    SlotOf slot_of = SameSlot()) {
  constexpr int V = elems16<TA>();
  const int gl = threadIdx.x & (g - 1);
  const int group = threadIdx.x / g;
  const int n_groups = blockDim.x / g;
  const bool once = vec && d <= g * V;
  for (int s0 = lo; s0 < hi; s0 += U * n_groups) {
    int slot[U], r[U], c[U];
    bool in[U];
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = s0 + u * n_groups + group;
      in[u] = i < hi;
      slot[u] = slot_of(i);
      r[u] = in[u] ? rows[base + slot[u]] : m;
      c[u] = in[u] ? cols[base + slot[u]] : 0;
      s[u] = 0.f;
    }
    if (once) {
      uint4 av[U], bv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool load = r[u] < m && gl * V < d;
        av[u] = load ? load16(a + static_cast<long long>(r[u]) * d + gl * V)
                     : make_uint4(0u, 0u, 0u, 0u);
        bv[u] = load ? load16(b + static_cast<long long>(c[u]) * d + gl * V)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = dot16_bits<TA>(av[u], bv[u]);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r[u] >= m) continue;
        const TA* ar = a + static_cast<long long>(r[u]) * d;
        const TA* br = b + static_cast<long long>(c[u]) * d;
        if (vec) {
          for (int j = gl * V; j < d; j += g * V) s[u] += dot16(ar + j, br + j);
        } else {
          for (int j = gl; j < d; j += g) s[u] += to_f32(ar[j]) * to_f32(br[j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int off = g >> 1; off > 0; off >>= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      if (in[u] && gl == 0) emit(slot[u], r[u], c[u], r[u] < m, s[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// K6's score passes, the paper's two reduction strategies on the SDDMM's
// reduction axis d.  Each hands every slot's score to its caller once, 0 at
// a padding slot (row >= m), which loads nothing.
// ---------------------------------------------------------------------------

// One piece of a feature row: 16 bytes (VEC: 4 f32 or 8 bf16 elements) or
// one element, and the dot product of two pieces in f32.
template <typename TA, bool VEC>
struct Piece {
  using T = uint4;
  static constexpr int kElems = elems16<TA>();
  __device__ static T zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static T load(const TA* row, int p) { return load16<TA>(row + p * kElems); }
  __device__ static float dot(T x, T y) { return dot16_bits<TA>(x, y); }
};

template <typename TA>
struct Piece<TA, false> {
  using T = float;
  static constexpr int kElems = 1;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const TA* row, int p) { return to_f32(__ldg(row + p)); }
  __device__ static float dot(T x, T y) { return x * y; }
};

// "par", the parallel reduction: a lane group of g lanes walks one
// contiguous range of `len` slots (rows[0, len), cols[0, len)), a
// lane owning pieces gl, gl + g, .. of each feature row (P of them, in
// registers; P = 0: any number, in a loop, nothing kept), the group
// reducing by __shfl_xor_sync.  It issues the gathers of U slots before
// their products, and calls emit(i, score) once a slot, from the group's
// first lane.  Rows are
// sorted within a tile, so a range meets each row as one run: a slot whose
// row is the previous slot's takes that slot's pieces of A[row] from
// registers instead of loading them (measured on H100: 3-6% faster than
// reloading them).  All lanes of a warp must
// call it with the same `span` (>= len): each group runs ceil(span / U)
// steps, so the shuffles see the whole warp.
template <typename TA, bool VEC, int P, int U, typename Emit>
__device__ __forceinline__ void score_range_par(const int* rows, const int* cols, int len,
                                                int span, const TA* __restrict__ a,
                                                const TA* __restrict__ b, int m, int d,
                                                int g, Emit emit) {
  using PC = Piece<TA, VEC>;
  using T = typename PC::T;
  constexpr int PR = P > 0 ? P : 1;
  const int pieces = d / PC::kElems;
  const int gl = threadIdx.x & (g - 1);
  T acur[PR];          // the pieces of A[cur], the row of the last slot
  int cur = m;
#pragma unroll
  for (int p = 0; p < PR; ++p) acur[p] = PC::zero();
  for (int k = 0; k < span; k += U) {
    int r[U], c[U];      // row m past the range
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = k + u < len;
      r[u] = in ? rows[k + u] : m;
      c[u] = in ? cols[k + u] : 0;
    }
    float s[U];
    if constexpr (P > 0) {
      T av[U][P], bv[U][P];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const TA* br = b + static_cast<long long>(c[u]) * d;
        const TA* ar = a + static_cast<long long>(r[u]) * d;
        const bool fresh = r[u] != (u ? r[u - 1] : cur);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int q = gl + p * g;
          const bool load = r[u] < m && q < pieces;
          bv[u][p] = load ? PC::load(br, q) : PC::zero();
          av[u][p] = load && fresh ? PC::load(ar, q) : (u ? av[u - 1][p] : acur[p]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) s[u] += PC::dot(av[u][p], bv[u][p]);
      }
      cur = r[U - 1];
#pragma unroll
      for (int p = 0; p < P; ++p) acur[p] = av[U - 1][p];
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = 0.f;
        if (r[u] >= m) continue;
        const TA* ar = a + static_cast<long long>(r[u]) * d;
        const TA* br = b + static_cast<long long>(c[u]) * d;
        for (int q = gl; q < pieces; q += g) s[u] += PC::dot(PC::load(ar, q), PC::load(br, q));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int off = g >> 1; off > 0; off >>= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      if (gl == 0 && k + u < len) emit(k + u, r[u] < m ? s[u] : 0.f);
    }
  }
}

// One feature row of at most one 16-byte piece as f32 elements, 0 past d:
// one 16-byte load (VEC: d is the piece) or d single elements.
template <typename TA, bool VEC>
__device__ __forceinline__ void load_short_row(const TA* row, int d,
                                               float (&e)[elems16<TA>()]) {
  constexpr int V = elems16<TA>();
  if constexpr (VEC) {
    const uint4 x = load16<TA>(row);
    if constexpr (sizeof(TA) == 4) {
      const float* f = reinterpret_cast<const float*>(&x);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = f[j];
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < V / 2; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        e[2 * j] = f.x;
        e[2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = j < d ? to_f32(__ldg(row + j)) : 0.f;
  }
}

// "seq", the sequential reduction: a thread owns a slot and loops over d
// with no shuffle.  The threads of the CTA take consecutive slots of the
// `cnt` ones at rows / cols (i, i + blockDim.x, ..), U slots a thread at a
// time, all their gathers issued before the products; emit(i, score) is
// called once a slot.  Where a row fits one piece (d <= 4 f32, <= 8 bf16) a
// slot whose row is the thread's previous slot's takes A[row] from
// registers; wider rows (a forced "seq") load both rows a piece
// at a time.
template <typename TA, bool VEC, int U, typename Emit>
__device__ __forceinline__ void score_slots_seq(const int* rows, const int* cols, int cnt,
                                                const TA* __restrict__ a,
                                                const TA* __restrict__ b, int m, int d,
                                                Emit emit) {
  using PC = Piece<TA, VEC>;
  constexpr int V = elems16<TA>();
  float acur[V];       // A[cur], the row of the thread's last slot
  int cur = m;
#pragma unroll
  for (int j = 0; j < V; ++j) acur[j] = 0.f;
  for (int k = threadIdx.x; k < cnt; k += U * blockDim.x) {
    int r[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = k + u * blockDim.x;
      r[u] = i < cnt ? rows[i] : m;
      c[u] = i < cnt ? cols[i] : 0;
    }
    float s[U];
    if (d <= V) {
      float av[U][V], bv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool fresh = r[u] != (u ? r[u - 1] : cur);
        if (r[u] < m) {
          load_short_row<TA, VEC>(b + static_cast<long long>(c[u]) * d, d, bv[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) bv[u][j] = 0.f;
        }
        if (r[u] < m && fresh) {
          load_short_row<TA, VEC>(a + static_cast<long long>(r[u]) * d, d, av[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) av[u][j] = u ? av[u - 1][j] : acur[j];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (j < d) s[u] = fmaf(av[u][j], bv[u][j], s[u]);
      }
      cur = r[U - 1];
#pragma unroll
      for (int j = 0; j < V; ++j) acur[j] = av[U - 1][j];
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = 0.f;
        if (r[u] >= m) continue;
        const TA* ar = a + static_cast<long long>(r[u]) * d;
        const TA* br = b + static_cast<long long>(c[u]) * d;
        for (int q = 0; q < d / PC::kElems; ++q) s[u] += PC::dot(PC::load(ar, q), PC::load(br, q));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = k + u * blockDim.x;
      if (i < cnt) emit(i, r[u] < m ? s[u] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// The segmented scan of a tile's row runs: the paper's segment reduction by
// shuffles (its first contribution), on values a slot at a time.  Rows are
// sorted within a tile, so each row's slots form one run.
//
// Each warp takes 32 consecutive slots (a chunk) and runs an inclusive
// __shfl_up_sync scan, a lane combining with the lane `off` below it only
// when both hold the same row.  A segment that touches neither end of its
// chunk is a whole run.  The segments at a chunk's two ends (its pieces) go
// to shared memory, and one thread folds the ≤ 2·ceil(T/32) pieces in slot
// order into runs.  The tile's first run (it holds slot 0) and its last run
// (slot T − 1) may continue in a neighbouring tile: they are the tile's edge
// runs; every other run is whole.
// ---------------------------------------------------------------------------

// The online-softmax pair (max, sum of exp(z − max)) of K7, K8 and K9.
struct SoftmaxOp {
  using T = float2;
  __device__ static T identity() { return make_float2(kSoftmaxNeg, 0.f); }
  // One slot's pair: the max floored at −1e30, as the reference's
  // scatter-max, so a row of −inf scores gives (−1e30, 0) and weights of 0.
  __device__ static T of(float z) {
    const float mx = fmaxf(z, kSoftmaxNeg);
    return make_float2(mx, expf(z - mx));
  }
  __device__ static T combine(T a, T b) {
    const float mn = fmaxf(a.x, b.x);
    return make_float2(mn, a.y * expf(a.x - mn) + b.y * expf(b.x - mn));
  }
  __device__ static T shfl_up(T v, int off) {
    return make_float2(__shfl_up_sync(0xffffffffu, v.x, off),
                       __shfl_up_sync(0xffffffffu, v.y, off));
  }
};

// The plain sum of K8's products at N = 1.
struct SumOp {
  using T = float;
  __device__ static T identity() { return 0.f; }
  __device__ static T combine(T a, T b) { return a + b; }
  __device__ static T shfl_up(T v, int off) {
    return __shfl_up_sync(0xffffffffu, v, off);
  }
};

// Shared memory of the scan's pieces, two a chunk: the values first (8-byte
// aligned at an aligned base), then the rows and the slots where they end.
template <typename Op>
struct ScanPieces {
  typename Op::T* val;
  int* row;
  int* end;
  __device__ ScanPieces(void* base, int n_chunks)
      : val(static_cast<typename Op::T*>(base)),
        row(reinterpret_cast<int*>(static_cast<float2*>(base) + 2 * n_chunks)),
        end(row + 2 * n_chunks) {}
};

// Bytes of the pieces of a tile of `tile` slots (either operation).
__host__ __device__ inline size_t scan_pieces_bytes(int tile) {
  return static_cast<size_t>((tile + 31) / 32) * 2 * (sizeof(float2) + 2 * sizeof(int));
}

// Scans the runs of the tile whose rows are s_rows[0, tile): load(slot, row)
// gives a slot's value, and emit(row, value, edge) is called once for each
// run of a row below m, `edge` set for the tile's first and last runs.
// Chunks c with head_chunks <= c < tail_chunk are skipped (K7's edge mode:
// they hold no slot of an edge run; the runs in the chunks around them are
// then wrong and emitted with edge unset, and the caller drops them).  With
// kWriteBack, s_val[s] holds a run's total at the last slot s of each of its
// segments (the caller finds a slot's segment end by a ballot), and the scan
// ends with a barrier.  Every thread of the CTA must call it.
template <typename Op, bool kWriteBack, typename Load, typename Emit>
__device__ __forceinline__ void scan_runs(
    const int* s_rows, int tile, int m, int head_chunks, int tail_chunk,
    ScanPieces<Op> p, typename Op::T* s_val, Load load, Emit emit) {
  using T = typename Op::T;
  const int n_chunks = (tile + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < n_chunks; c += blockDim.x >> 5) {
    if (c >= head_chunks && c < tail_chunk) {   // between the edge runs
      if (lane < 2) p.row[2 * c + lane] = -1;
      continue;
    }
    const int slot = c * 32 + lane;
    const int last = min(31, tile - 1 - c * 32);
    const bool in = lane <= last;
    // lanes past the tile's end get distinct negative rows: no segment
    const int r = in ? s_rows[slot] : -1 - lane;
    T v = in ? load(slot, r) : Op::identity();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T o = Op::shfl_up(v, off);
      const int orow = __shfl_up_sync(0xffffffffu, r, off);
      if (lane >= off && orow == r) v = Op::combine(v, o);
    }
    const int next = __shfl_down_sync(0xffffffffu, r, 1);
    const int first = __shfl_sync(0xffffffffu, r, 0);
    const bool at_end = lane == last;
    if (!in || (!at_end && next == r)) continue;  // not a segment's end
    if (kWriteBack) s_val[slot] = v;
    if (r == first) {                 // the chunk's first piece
      p.row[2 * c] = r;
      p.end[2 * c] = slot;
      p.val[2 * c] = v;
      if (at_end) p.row[2 * c + 1] = -1;  // the chunk is one segment
    } else if (at_end) {              // its last piece
      p.row[2 * c + 1] = r;
      p.end[2 * c + 1] = slot;
      p.val[2 * c + 1] = v;
    } else if (r < m) {
      emit(r, v, false);              // a whole run inside the chunk
    }
  }
  __syncthreads();

  // Fold the pieces in slot order.  Piece 0 is always there: chunk 0 is
  // never skipped and its first slot starts a segment.
  if (threadIdx.x == 0) {
    const int n_pieces = 2 * n_chunks;
    int cur = p.row[0], from = 0;
    T acc = p.val[0];
    for (int i = 1; i <= n_pieces; ++i) {
      const int r = i < n_pieces ? p.row[i] : -2;
      if (r == -1) continue;          // an absent piece
      if (r == cur) {
        acc = Op::combine(acc, p.val[i]);
        continue;
      }
      // the run of `cur` ends before piece i
      if (cur < m) emit(cur, acc, from == 0 || i == n_pieces);
      if (kWriteBack) {
        for (int j = from; j < i; ++j)
          if (p.row[j] == cur) s_val[p.end[j]] = acc;
      }
      if (i == n_pieces) break;
      cur = r;
      acc = p.val[i];
      from = i;
    }
  }
  if (kWriteBack) __syncthreads();
}

}  // namespace repro_torch

// FN<TA>(args...) for the feature type the flag names: 0 = f32, 1 = bf16.
#define REPRO_DISPATCH_FEATURES(AB_BF16, FN, ...)                             \
  ((AB_BF16) ? FN<__nv_bfloat16>(__VA_ARGS__) : FN<float>(__VA_ARGS__))
