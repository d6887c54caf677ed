// Edge-tile rows and hub splits: the row walk shared by K6
// (pallas_bwd_dst.cu), K7 (pallas_segsum.cu) and K8 (pallas_bwd_src.cu).
//
// The layout (ops/pallas_attention.py): one side's rows are cut into tiles
// of 128; tile t owns the slots [rel_off[t] * te, rel_off[t + 1] * te) of
// the side's id array, sorted by row id, with padding (an id of the
// chunk's row count or more) at its end. So each row's edges are one
// contiguous run [lo, hi) of its tile's slots.
//
// A block of kBlock threads takes one tile at a time: tile_ranges reads
// the tile's ids once, coalesced (K7: all but the inside of runs longer
// than two windows of kBlock slots, which it jumps over), and takes every
// row's run from adjacent differences into shared memory; the block's lane
// groups (lane_groups.cuh) then take the tile's rows in turn. Long rows
// (the hubs of a power-law graph, up to ~2e5 edges) are split, so that no
// group walks more than about kHub of a row's edges (K7: its kSplitLen):
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

// The first slot x of [lo, hi) with ids[x] >= key, or hi; ids ascend on
// [lo, hi). One thread, a binary search.
__device__ __forceinline__ int lower_bound(const int* __restrict__ ids,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (__ldg(ids + m) < key) lo = m + 1; else hi = m;
  }
  return lo;
}

// The same slot, found by the whole block: each round cuts the range into
// kBlock parts, one probe (the part's last slot) a thread, and keeps the
// part the answer lies in, so 2e5 slots take three rounds instead of 18
// dependent loads. Every thread of the block calls it and gets the slot.
__device__ __forceinline__ int block_lower_bound(const int* __restrict__ ids,
                                                 int lo, int hi, int key) {
  while (lo < hi) {  // block-uniform
    const int step = (hi - lo + kBlock - 1) / kBlock;
    const int x = lo + (threadIdx.x + 1) * step - 1;
    // the parts whose last slot is below key are all below it, and they
    // are the first ones: the answer lies in the next part
    const int below = __syncthreads_count(x < hi && __ldg(ids + x) < key);
    lo += below * step;
    hi = min(hi, lo + step - 1);
  }
  return lo;
}

// Marks in s_lo / s_hi the ends of the run through slot p of the tile
// whose slots are [t_lo, t_hi) and rows base .. base + 127, where they are
// at p: where the adjacent ids differ.
__device__ __forceinline__ void mark_run_ends(const int* __restrict__ ids,
                                              int p, int t_lo, int t_hi,
                                              int base, int* s_lo,
                                              int* s_hi) {
  const int d = __ldg(ids + p);
  if (d < base || d >= base + kTileN) return;  // padding
  if (p == t_lo || __ldg(ids + p - 1) != d) s_lo[d - base] = p;
  if (p + 1 == t_hi || __ldg(ids + p + 1) != d) s_hi[d - base] = p + 1;
}

// Fills s_lo / s_hi with the run of every row base .. base + 127 of the
// tile whose slots are [t_lo, t_hi) (a row without an edge keeps [0, 0)).
// Every thread of the block calls it. The block reads the tile's ids kBlock
// slots at a time, coalesced. With kJump (K7; K6 and K8 read every slot),
// a run through the end of one window of kBlock slots that also fills the
// next window is jumped over: block_lower_bound finds its end, so a tile
// that holds a hub of 2e5 edges takes a few dozen rounds instead of 1,600.
template <bool kJump = false>
__device__ __forceinline__ void tile_ranges(const int* __restrict__ ids,
                                            int t_lo, int t_hi, int base,
                                            int* s_lo, int* s_hi) {
  __syncthreads();  // the previous tile's ranges have been read
  for (int i = threadIdx.x; i < kTileN; i += kBlock) s_lo[i] = s_hi[i] = 0;
  __syncthreads();
  if constexpr (!kJump) {
    for (int p = t_lo + threadIdx.x; p < t_hi; p += kBlock)
      mark_run_ends(ids, p, t_lo, t_hi, base, s_lo, s_hi);
  } else {
    for (int w = t_lo; w < t_hi; w += kBlock) {  // block-uniform
      if (w + threadIdx.x < t_hi)
        mark_run_ends(ids, w + threadIdx.x, t_lo, t_hi, base, s_lo, s_hi);
      const int next = w + kBlock;  // the run through slot next - 1: r
      if (next + kBlock > t_hi) continue;
      const int r = __ldg(ids + next - 1);
      if (__ldg(ids + next + kBlock - 1) != r) continue;  // block-uniform
      const int end = block_lower_bound(ids, next + kBlock, t_hi, r + 1);
      // the thread of slot end - 1, which marks the run's end, is skipped
      if (threadIdx.x == 0 && r >= base && r < base + kTileN)
        s_hi[r - base] = end;
      w = end - kBlock;
    }
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
// array's length. With kBlockWide every thread of the block calls it and
// the block searches for the run's ends (block_lower_bound); else one
// thread does, by binary search.
template <bool kBlockWide = false>
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
  const int t_lo = __ldg(rel_off + t) * te, t_hi = __ldg(rel_off + t + 1) * te;
  // the first slot with id r, and the first past the run
  int lo, hi;
  if constexpr (kBlockWide) {
    lo = block_lower_bound(ids, t_lo, p, r);
    hi = block_lower_bound(ids, p + 1, t_hi, r + 1);
  } else {
    lo = lower_bound(ids, t_lo, p, r);
    hi = lower_bound(ids, p + 1, t_hi, r + 1);
  }
  return hi - lo > kSeg ? Run{r, lo, hi} : none;
}

// The long runs that meet segment [p0, p1): s0, one that started before
// p0; s1, the one that starts in it. kBlockWide as for long_run_at; it
// also takes a segment that lies inside one run (the run holds p0 - 1 and
// p1, so it is longer than kSeg and meets nothing else there) from three
// loads, with s0's ends given as p0 - 1 and p1 + 1: the inside of a hub
// needs no search.
template <bool kBlockWide = false>
__device__ __forceinline__ void segment_runs(const int* __restrict__ ids,
                                             const int* __restrict__ rel_off,
                                             int te, int rows, int slots,
                                             int p0, int p1, Run& s0,
                                             Run& s1) {
  const Run none{-1, 0, 0};
  if constexpr (kBlockWide) {
    if (p0 > 0 && p1 < slots) {
      const int r = __ldg(ids + p0);
      if (r < rows && __ldg(ids + p0 - 1) == r && __ldg(ids + p1) == r) {
        s0 = Run{r, p0 - 1, p1 + 1};
        s1 = none;
        return;
      }
    }
  }
  const Run first =
      long_run_at<kBlockWide>(ids, rel_off, te, rows, slots, p0);
  s0 = first.row >= 0 && first.lo < p0 ? first : none;
  if (first.row >= 0 && first.lo == p0) {
    s1 = first;
    return;
  }
  // a long run through p1 - 1 other than `first` cannot hold p0, so it
  // starts inside the segment
  const Run last =
      long_run_at<kBlockWide>(ids, rel_off, te, rows, slots, p1 - 1);
  s1 = last.row >= 0 && last.row != first.row ? last : none;
}

// The second launch of K6, K7 and K8: out[row] = the partials of every long
// run (the row that starts in segment k: meta[2k] >= 0, its end
// meta[2k + 1]) added in segment order: slot 1 of its first segment, then
// slot 0 of each later one it covers. kBatch partials are loaded before
// they are added (K7: a hub of 2e5 edges has ~220), in the same order.
template <int kBatch = 1>
__global__ void merge_segments(const float* __restrict__ part,
                               const int* __restrict__ meta, int nseg,
                               int hd, float* __restrict__ out) {
  for (int k = blockIdx.x; k < nseg; k += gridDim.x) {
    const int row = meta[2 * k];
    if (row < 0) continue;
    const int k_hi = (meta[2 * k + 1] - 1) / kSeg;
    for (int f = threadIdx.x; f < hd; f += blockDim.x) {
      float s = part[(size_t)(2 * k + 1) * hd + f];
      int kk = k + 1;
      for (; kk + kBatch - 1 <= k_hi; kk += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          v[j] = part[(size_t)2 * (kk + j) * hd + f];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) s += v[j];
      }
      for (; kk <= k_hi; ++kk) s += part[(size_t)2 * kk * hd + f];
      out[(size_t)row * hd + f] = s;
    }
  }
}

}  // namespace edge_tiles
