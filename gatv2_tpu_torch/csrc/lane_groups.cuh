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

}  // namespace lane_groups
