// Lane groups sized to the width: the row layout shared by K1
// (sell_fwd.cu), K2 (sell_bwd_dst.cu), K4 (sell_bwd_src.cu), K5
// (pallas_fwd.cu), K6 (pallas_bwd_dst.cu), K7 (pallas_segsum.cu, one head
// of H*D features) and K8 (pallas_bwd_src.cu).
//
// A row of H*D fp32 features is owned by a group of LG lanes (a power of
// two, at most 32), so a warp holds 32 / LG rows. Inside the group, head h
// owns the LPH lanes h*LPH .. h*LPH + LPH - 1 (LPH a power of two), and lane
// `sub` of the head holds the head's vectors sub, sub + LPH, sub + 2*LPH, ...
// of VEC floats each (VEC = 4, one 16-byte load, when D is a multiple of 4
// and the tables are 16-byte aligned; else VEC = 1). Every feature a lane
// holds belongs to its own head, so a head's dot product is the lane's own
// sum followed by log2(LPH) rounds of __shfl_xor_sync inside the head's
// lanes, with no shared memory and no __syncwarp. Every lane of the head
// ends with the same sum (the butterfly adds the same pairs in every lane),
// so the per-head softmax terms are computed alike in each of them, with no
// broadcast.
//
// The geometry (host side): LPH is the smallest power of two that covers
// the head's D / VEC vectors, cut to the largest power of two with
// H * LPH <= 32; LG is the smallest power of two >= H * LPH; a lane holds
// NV = ceil(D / VEC / LPH) vectors, rounded up to a power of two for the
// template. Lanes past the last head, and vectors past D, hold zeros and
// are neither loaded nor stored.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace lane_groups {

constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int vec;  // floats per vector: 4 or 1
  int qph;  // vectors per head (D / vec)
  int lph;  // lanes per head
  int lg;   // lanes per row
  int nv;   // vectors per lane, a power of two
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// `aligned`: every fp32 table the kernel reads or writes by row is 16-byte
// aligned.
inline Geometry geometry(int heads, int head_dim, bool aligned) {
  Geometry g;
  g.vec = (head_dim % 4 == 0 && aligned) ? 4 : 1;
  g.qph = head_dim / g.vec;
  int cap = 1;
  while (cap * 2 * heads <= 32) cap *= 2;
  g.lph = 1;
  while (g.lph < g.qph && g.lph < cap) g.lph *= 2;
  g.lg = 1;
  while (g.lg < heads * g.lph) g.lg *= 2;
  const int nv = (g.qph + g.lph - 1) / g.lph;
  g.nv = 1;
  while (g.nv < nv) g.nv *= 2;
  return g;
}

// The widest per-edge feature vector the edge-feature variants of K1, K2
// and K4 take (ops/sell_fwd.py MAX_EDGE_DIM).
constexpr int kMaxEdgeDim = 16;

// Loads an edge's k features (k <= kMaxEdgeDim) into registers; every lane
// of a group reads the same slot, so the loads are broadcast in L1.
__device__ __forceinline__ void load_edge_feats(float (&f)[kMaxEdgeDim],
                                                const float* __restrict__ p,
                                                int k) {
#pragma unroll
  for (int c = 0; c < kMaxEdgeDim; ++c) f[c] = c < k ? __ldg(p + c) : 0.f;
}

// Copies W_e, laid out [k][H*D] (the wrappers transpose it), into the
// block's shared memory; every thread of the block takes part and syncs.
__device__ __forceinline__ void load_edge_weights(float* __restrict__ s,
                                                  const float* __restrict__ w,
                                                  int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = __ldg(w + i);
  __syncthreads();
}

// Where this lane's vectors start in a row, and which of them exist.
template <int VEC, int NV>
struct Lane {
  int off[NV];
  bool ok[NV];

  __device__ __forceinline__ void init(int gl, int lph, int qph, int heads,
                                       int head_dim) {
    const int h = gl / lph, sub = gl % lph;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int q = sub + lph * j;
      ok[j] = h < heads && q < qph;
      off[j] = ok[j] ? h * head_dim + q * VEC : 0;
    }
  }

  // Loads this lane's vectors of a row. `once` marks the loads
  // evict-first (__ldcs), for rows read once: streaming them through L2
  // then does not push out the small tables that are read again.
  __device__ __forceinline__ void load(float (&x)[NV * VEC],
                                       const float* __restrict__ row,
                                       bool once = false) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if constexpr (VEC == 4) {
        const float4* p = reinterpret_cast<const float4*>(row + off[j]);
        const float4 v = !ok[j] ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : once ? __ldcs(p)
                                : __ldg(p);
        x[4 * j] = v.x;
        x[4 * j + 1] = v.y;
        x[4 * j + 2] = v.z;
        x[4 * j + 3] = v.w;
      } else {
        const float* p = row + off[j];
        x[j] = !ok[j] ? 0.f : once ? __ldcs(p) : __ldg(p);
      }
    }
  }

  // x[i] += W_e f[i] over this lane's features, for the R edges of a
  // ring at once: the edge term of the score's pre-activation, from W_e
  // [k][H*D] in shared memory and each edge's features f[i]. Each W_e
  // vector is read once for the R edges. Each feature sums its k products
  // in order, then adds them to x, in K1, K2 and K4 alike, so all three
  // rebuild the same value.
  template <int R>
  __device__ __forceinline__ void add_edge(float (&x)[R][NV * VEC],
                                           const float* __restrict__ sw,
                                           const float (&f)[R][kMaxEdgeDim],
                                           int k, int hd) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
      float e[R][VEC];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) e[i][v] = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxEdgeDim; ++c) {
        if (c >= k) break;
        const float* w = sw + c * hd + off[j];
        float q[VEC];
        if constexpr (VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(w);
          q[0] = t.x;
          q[1] = t.y;
          q[2] = t.z;
          q[3] = t.w;
        } else {
          q[0] = *w;
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int v = 0; v < VEC; ++v) e[i][v] = fmaf(f[i][c], q[v], e[i][v]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[i][VEC * j + v] += e[i][v];
    }
  }

  // add_edge of one edge.
  __device__ __forceinline__ void add_edge(float (&x)[NV * VEC],
                                           const float* __restrict__ sw,
                                           const float (&f)[kMaxEdgeDim],
                                           int k, int hd) const {
    add_edge<1>(reinterpret_cast<float(&)[1][NV * VEC]>(x), sw,
                reinterpret_cast<const float(&)[1][kMaxEdgeDim]>(f), k, hd);
  }

  // acc += g (x) f over this lane's features: the edge term's weight
  // gradient, into a [k][H*D] table in shared memory that this lane's
  // group alone writes (no other lane holds these features).
  __device__ __forceinline__ void add_outer(float* __restrict__ acc,
                                            const float (&g)[NV * VEC],
                                            const float (&f)[kMaxEdgeDim],
                                            int k, int hd) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
#pragma unroll
      for (int c = 0; c < kMaxEdgeDim; ++c) {
        if (c >= k) break;
        float* a = acc + c * hd + off[j];
        if constexpr (VEC == 4) {
          float4 q = *reinterpret_cast<float4*>(a);
          q.x = fmaf(g[4 * j], f[c], q.x);
          q.y = fmaf(g[4 * j + 1], f[c], q.y);
          q.z = fmaf(g[4 * j + 2], f[c], q.z);
          q.w = fmaf(g[4 * j + 3], f[c], q.w);
          *reinterpret_cast<float4*>(a) = q;
        } else {
          *a = fmaf(g[j], f[c], *a);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ row,
                                        const float (&x)[NV * VEC]) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ok[j]) continue;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(row + off[j]) =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      } else {
        row[off[j]] = x[j];
      }
    }
  }
};

// The sum of v over the LPH lanes of this lane's head (inside `mask`, the
// lanes of this lane's group), the same value in each of them.
__device__ __forceinline__ float head_sum(float v, int lph, unsigned mask) {
  for (int o = lph >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// The real-slot count of row r of a SELL-128 slice whose ncols columns
// start at column c0 (K1, K2, K4). Slices are column-major and
// length-descending, so slot (column k, row r) is real iff r < cnt[k], and
// a row's real slots are a prefix of its columns: one binary search for
// the first column with cnt <= r. The slice's rows share its cnt in L1.
__device__ __forceinline__ int sell_row_slots(const int* __restrict__ cnt,
                                              int c0, int ncols, int r) {
  int lo = 0, hi = ncols;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cnt + c0 + mid) > r)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The lanes of this lane's group of `lg` lanes.
__device__ __forceinline__ unsigned group_mask(int lane, int lg) {
  return lg == 32 ? kFull : ((1u << lg) - 1u) << (lane & ~(lg - 1));
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls fn(Int<VEC>, Int<NV>) for the geometry's template pair; returns
// what fn returns, or cudaErrorInvalidValue for a pair out of range.
template <class Fn>
int dispatch(const Geometry& g, Fn&& fn) {
  if (g.vec == 4) {
    switch (g.nv) {
      case 1: return fn(Int<4>{}, Int<1>{});
      case 2: return fn(Int<4>{}, Int<2>{});
      case 4: return fn(Int<4>{}, Int<4>{});
      case 8: return fn(Int<4>{}, Int<8>{});
    }
  } else {
    switch (g.nv) {
      case 1: return fn(Int<1>{}, Int<1>{});
      case 2: return fn(Int<1>{}, Int<2>{});
      case 4: return fn(Int<1>{}, Int<4>{});
      case 8: return fn(Int<1>{}, Int<8>{});
      case 16: return fn(Int<1>{}, Int<16>{});
      case 32: return fn(Int<1>{}, Int<32>{});
    }
  }
  return (int)cudaErrorInvalidValue;
}

// dispatch for the edge-feature variants: with 16-byte vectors the
// template's NV is the lane's exact vector count (1 to 8), so a head
// width such as D = 80 (5 vectors a lane at 6 heads) holds no idle
// registers; 4-byte loads take NV up to 8, rounded as in dispatch.
template <class Fn>
int dispatch_edge(const Geometry& g, Fn&& fn) {
  if (g.vec == 4) {
    switch ((g.qph + g.lph - 1) / g.lph) {
      case 1: return fn(Int<4>{}, Int<1>{});
      case 2: return fn(Int<4>{}, Int<2>{});
      case 3: return fn(Int<4>{}, Int<3>{});
      case 4: return fn(Int<4>{}, Int<4>{});
      case 5: return fn(Int<4>{}, Int<5>{});
      case 6: return fn(Int<4>{}, Int<6>{});
      case 7: return fn(Int<4>{}, Int<7>{});
      case 8: return fn(Int<4>{}, Int<8>{});
    }
  } else {
    switch (g.nv) {
      case 1: return fn(Int<1>{}, Int<1>{});
      case 2: return fn(Int<1>{}, Int<2>{});
      case 4: return fn(Int<1>{}, Int<4>{});
      case 8: return fn(Int<1>{}, Int<8>{});
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace lane_groups
