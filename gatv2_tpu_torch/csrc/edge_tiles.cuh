// Edge-tile rows and hub splits: the row walk shared by K6
// (pallas_bwd_dst.cu) and K8 (pallas_bwd_src.cu).
//
// The layout (ops/pallas_attention.py): one side's rows are cut into tiles
// of 128; tile t owns the slots [rel_off[t] * te, rel_off[t + 1] * te) of
// the side's id array, sorted by row id, with padding (an id of the
// chunk's row count or more) at its end. So each row's edges are one
// contiguous run [lo, hi) of its tile's slots.
//
// A block of kBlock threads takes one tile at a time: tile_ranges reads
// the tile's ids once, coalesced, and takes every row's run from adjacent
// differences into shared memory; the block's lane groups
// (lane_groups.cuh) then take the tile's rows in turn. Long rows (the hubs
// of a power-law graph, up to ~2e5 edges) are split, so that no group
// walks more than about kHub of a row's edges:
//  - a row of kHub < len <= kSeg edges is cut into equal contiguous parts
//    over the block's groups (split_part), whose sums merge_groups adds in
//    part order through shared memory;
//  - a row of more than kSeg edges is left to segment blocks: the id array
//    is cut into segments of kSeg slots, and the segment block of segment
//    k takes the part of each such row inside it. At most two such rows
//    meet a segment (segment_runs): one that covers its first slot (slot
//    0) and one that starts inside it (slot 1), since each is longer than
//    the segment. The block splits the part over its groups as above and
//    writes one partial per (segment, slot); the launch after it
//    (merge_segments) adds each row's partials in segment order.
// No float atomics: every sum is taken in an order that the layout fixes,
// so the results do not depend on timing. The ops' wrappers mirror kSeg
// (SEG) to size the segment scratch.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace edge_tiles {

constexpr int kTileN = 128;   // rows per tile
constexpr int kBlock = 128;   // threads per block
constexpr int kWarps = kBlock / 32;
constexpr int kHub = 256;     // longer rows are split over the block
constexpr int kSeg = 1024;    // longer rows go to segment blocks

// Fills s_lo / s_hi with the run of every row base .. base + 127 of the
// tile whose slots are [t_lo, t_hi) (a row without an edge keeps [0, 0)).
// Every thread of the block calls it.
__device__ __forceinline__ void tile_ranges(const int* __restrict__ ids,
                                            int t_lo, int t_hi, int base,
                                            int* s_lo, int* s_hi) {
  __syncthreads();  // the previous tile's ranges have been read
  for (int i = threadIdx.x; i < kTileN; i += kBlock) s_lo[i] = s_hi[i] = 0;
  __syncthreads();
  for (int p = t_lo + threadIdx.x; p < t_hi; p += kBlock) {
    const int d = __ldg(ids + p);
    if (d < base || d >= base + kTileN) continue;  // padding
    if (p == t_lo || __ldg(ids + p - 1) != d) s_lo[d - base] = p;
    if (p + 1 == t_hi || __ldg(ids + p + 1) != d) s_hi[d - base] = p + 1;
  }
  __syncthreads();
}

// Part q of `parts` equal contiguous parts of [lo, hi); the last parts may
// be short or empty.
__device__ __forceinline__ void split_part(int lo, int hi, int q, int parts,
                                           int& p_lo, int& p_hi) {
  const int per = (hi - lo + parts - 1) / parts;
  p_lo = min(hi, lo + q * per);
  p_hi = min(hi, p_lo + per);
}

// x summed over the block's groups in group order, left in group 0's lanes
// (lane gl of group q holds part q's features at the offsets lane gl of
// group 0 holds them). s_buf holds F * kBlock floats. Every thread of the
// block calls it.
template <int F>
__device__ __forceinline__ void merge_groups(float (&x)[F], float* s_buf,
                                             int lg, int groups) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int f = 0; f < F; ++f) s_buf[f * kBlock + tid] = x[f];
  __syncthreads();
  if (tid < lg) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float s = s_buf[f * kBlock + tid];
      for (int q = 1; q < groups; ++q) s += s_buf[f * kBlock + q * lg + tid];
      x[f] = s;
    }
  }
  __syncthreads();  // read before the buffer is written again
}

struct Run {
  int row, lo, hi;  // row < 0: none
};

// The run through slot p if it is longer than kSeg edges, else none. rows
// is the chunk's row count (padding ids are rows or more); slots the id
// array's length.
__device__ __forceinline__ Run long_run_at(const int* __restrict__ ids,
                                           const int* __restrict__ rel_off,
                                           int te, int rows, int slots,
                                           int p) {
  const Run none{-1, 0, 0};
  const int r = __ldg(ids + p);
  if (r >= rows) return none;  // padding
  // a run of more than kSeg slots through p also holds p - kSeg/2 or
  // p + kSeg/2: two loads reject the common case
  constexpr int kHalf = kSeg / 2;
  if (!(p >= kHalf && __ldg(ids + p - kHalf) == r) &&
      !(p + kHalf < slots && __ldg(ids + p + kHalf) == r))
    return none;
  const int t = r / kTileN;
  int a = __ldg(rel_off + t) * te, b = p;  // first slot with id r
  while (a < b) {
    const int m = (a + b) >> 1;
    if (__ldg(ids + m) < r) a = m + 1; else b = m;
  }
  const int lo = a;
  a = p + 1;
  b = __ldg(rel_off + t + 1) * te;  // first slot past the run
  while (a < b) {
    const int m = (a + b) >> 1;
    if (__ldg(ids + m) <= r) a = m + 1; else b = m;
  }
  return a - lo > kSeg ? Run{r, lo, a} : none;
}

// The long runs that meet segment [p0, p1): s0, one that started before
// p0; s1, the one that starts in it.
__device__ __forceinline__ void segment_runs(const int* __restrict__ ids,
                                             const int* __restrict__ rel_off,
                                             int te, int rows, int slots,
                                             int p0, int p1, Run& s0,
                                             Run& s1) {
  const Run none{-1, 0, 0};
  const Run first = long_run_at(ids, rel_off, te, rows, slots, p0);
  s0 = first.row >= 0 && first.lo < p0 ? first : none;
  if (first.row >= 0 && first.lo == p0) {
    s1 = first;
    return;
  }
  // a long run through p1 - 1 other than `first` cannot hold p0, so it
  // starts inside the segment
  const Run last = long_run_at(ids, rel_off, te, rows, slots, p1 - 1);
  s1 = last.row >= 0 && last.row != first.row ? last : none;
}

// The second launch of K6 and K8: out[row] = the partials of every long
// run (the row that starts in segment k: meta[2k] >= 0, its end
// meta[2k + 1]) added in segment order: slot 1 of its first segment, then
// slot 0 of each later one it covers.
__global__ void merge_segments(const float* __restrict__ part,
                               const int* __restrict__ meta, int nseg,
                               int hd, float* __restrict__ out) {
  for (int k = blockIdx.x; k < nseg; k += gridDim.x) {
    const int row = meta[2 * k];
    if (row < 0) continue;
    const int k_hi = (meta[2 * k + 1] - 1) / kSeg;
    for (int f = threadIdx.x; f < hd; f += blockDim.x) {
      float s = part[(size_t)(2 * k + 1) * hd + f];
      for (int kk = k + 1; kk <= k_hi; ++kk) s += part[(size_t)2 * kk * hd + f];
      out[(size_t)row * hd + f] = s;
    }
  }
}

}  // namespace edge_tiles
