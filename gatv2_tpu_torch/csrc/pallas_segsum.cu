// K7 — the streamed-operand GATv2 attention backward, phase 2 (source
// rows): the per-source-row sum of the c1 packets, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/pallas_attention.py:_segsum_src_kernel
// (launched by _segsum_src). It computes the same function: for every source
// node i of the source-sorted edge tiles (the CSC mirror of the layout),
//     dzs[i] = sum over the entries p with src_sorted_ids[p] == i
//              of c1[gather_perm[p]]
// where c1 holds K6's packets in destination-sorted edge order and
// gather_perm maps each source-sorted entry to its edge's position there.
// The entries are summed in source-sorted order (a split row: in order
// within each part, then the parts in order).
//
// What bounds it on this card: memory. Each real edge reads one c1 row of
// H*D fp32 (1 KB at H*D = 256) and its gather_perm id, and does one add per
// feature; each source row's dzs is written once. The packets are read
// straight through gather_perm: the TPU path first writes the permuted copy
// take(c1, gather_perm) to device memory and reads it back, then reduces it
// with one-hot matmuls.
//
// The design (a first version gave one warp to each source row, found its
// entries by two binary searches in device memory, left 16 of 32 lanes
// idle at H*D = 16, kept one packet in flight and walked a hub's
// out-edges in that one warp: 0.766 / 0.276 / 0.267 ms at H*D = 256 / 32 /
// 16 on a products-sub minibatch, and 306.7 ms over the three layers of an
// arxiv-pl training step, whose largest source row has 226,772 edges):
//  - one block of 128 threads per 128-node source tile (edge_tiles.cuh):
//    row ranges from adjacent differences of the tile's sorted source ids
//    in shared memory, the inside of a run longer than two windows of 128
//    slots jumped over by a block-wide search for its end (reading every
//    slot instead: 1.31 / 0.96 / 0.53 ms on arxiv-pl's layout against 0.65
//    / 0.12 / 0.08); padding entries carry the padded node count, so
//    they name no row and are never read (K6 leaves the padding slots of
//    c1 unwritten: they may hold NaN); a row without an out-edge writes
//    dzs = 0;
//  - lane groups sized to H*D (lane_groups.cuh, one "head" of H*D
//    features): 4 lanes of 16-byte vectors a row at H*D = 16, so a warp
//    sums 8 rows, and 32 lanes at H*D >= 128;
//  - a register ring of R = kRing<F> packets: a group issues the loads of
//    R packets (and of the next R ids) before it adds the first;
//  - long rows split (edge_tiles.cuh): a row of 32 < len <= 1024 entries
//    over the block's groups (at K6's and K8's 256, arxiv-pl's rows of up
//    to 256 entries walked by one group took 0.22 / 0.19 ms at H*D = 32 /
//    16 against 0.12 / 0.08), a longer one over segment blocks of 1024
//    slots (which find the runs that meet their segment with block-wide
//    searches, or, inside a run, with three loads) and a merge launch, all
//    partials added in part order, with no atomics.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): 0.559 / 0.108
// / 0.087 ms at H*D = 256 / 32 / 16 on a products-sub minibatch (device
// 0.546 / 0.095 / 0.062 ms; bound 0.458 / 0.059 / 0.031; index_add_ 8.33 /
// 1.80 / 1.28) and 0.674 / 0.136 / 0.113 ms on arxiv-pl (device 0.659 /
// 0.119 / 0.078; bound 0.411 / 0.054 / 0.028; index_add_ 2.30 / 0.81 /
// 0.47). A bare gather of the same c1 rows through gather_perm, without
// the dzs writes, takes 0.34 / 0.05-0.07 / 0.033 ms and 0.39-0.41 / 0.06 /
// 0.035 (tools/torch_kernel_variants.py): random rows of 64 or 128 bytes
// do not reach the bound's rate, and at H*D 16 and 32 K7's dzs writes,
// its tile walk, the hub segments' chains and the merge launch (10 us on
// arxiv-pl) come on top of it.

#include <cuda_runtime.h>

#include <cstddef>

#include "edge_tiles.cuh"
#include "lane_groups.cuh"

namespace {

using namespace edge_tiles;
using namespace lane_groups;

constexpr int kMaxHd = 512;  // H*D per launch (the op splits heads)
// Packets a group keeps in flight (the register ring), the blocks per SM
// the register budget is cut for, and whether c1 rows, read once each, are
// loaded evict-first (streamed through L2, so the ids stay there), by F =
// floats per lane. tools/torch_kernel_variants.py measured (H*D = 256 / 32
// / 16, products-sub batch | arxiv-pl; NVIDIA H100 80GB HBM3, 700.00 W):
// F = 4, one packet at 16 blocks (32 registers) 0.102 / 0.068 | 0.123 /
// 0.082 ms against 0.099 / 0.068 | 0.156 / 0.102 for 2 (16 B spilled) and
// 0.109 / 0.073 | 0.165 / 0.106 for 4 at 12 blocks; F = 8, 4 packets at 8
// blocks 0.554 | 0.659 ms, the same as 1 at 12, where 8 at 4 take 0.631 |
// 0.647; evict-first loads 0.100 / 0.068 | 0.123 / 0.081 against
// ordinary 0.098 / 0.069 | 0.137 / 0.097 at F = 4, and 0.572 | 0.652
// against 0.553 | 0.660 at F = 8.
template <int F>
constexpr bool kEvictFirst = F <= 4;
template <int F>
constexpr int kRing = F <= 4 ? 1 : F <= 16 ? 4 : 2;
template <int F>
constexpr int kMinBlocks = F <= 4 ? 16 : F <= 8 ? 8 : F <= 16 ? 4 : 2;
// partials the merge launch loads before it adds them (arxiv-pl, 256
// lanes: 0.659 ms against 0.672 one at a time and 0.663 for 64)
constexpr int kMergeBatch = 16;
// Rows of more entries are split over the block's groups (edge_tiles.cuh
// kHub is K6's and K8's): K7 does one add per feature an entry, so what
// bounds a long row in one group is its chain of dependent loads, len / R
// rounds (arxiv-pl at H*D = 32 / 16: 0.123 / 0.082 ms against 0.123 /
// 0.083 at 16 and 0.126 / 0.096 at 64).
constexpr int kSplitLen = 32;

// acc = the sum of the packets of the entries [lo, hi) (a row, or one
// part of it), in entry order.
template <int VEC, int NV>
__device__ __forceinline__ void packet_sum(const Lane<VEC, NV>& ln,
                                           const float* __restrict__ c1,
                                           const int* __restrict__ perm,
                                           int lo, int hi, int hd,
                                           float (&acc)[NV * VEC]) {
  constexpr int F = NV * VEC;
  constexpr int R = kRing<F>;
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  if (hi <= lo) return;  // group-uniform
  int id[R];
#pragma unroll
  for (int i = 0; i < R; ++i) id[i] = lo + i < hi ? __ldg(perm + lo + i) : 0;
  for (int e0 = lo; e0 < hi; e0 += R) {
    float v[R][F];
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (e0 + i < hi)
        ln.load(v[i], c1 + (size_t)id[i] * hd, kEvictFirst<F>);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = e0 + R + i;
      id[i] = e < hi ? __ldg(perm + e) : 0;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (e0 + i >= hi) break;  // group-uniform
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += v[i][f];
    }
  }
}

// Blocks [0, seg_blocks) are segment blocks (edge_tiles.cuh), striding
// over the nseg segments of kSeg slots; the others take one source tile
// each. The segment blocks come first: a hub's segments are the longest
// work, and without a hub their few loads overlap the tiles' instead of
// trailing them.
template <int VEC, int NV>
__global__ void __launch_bounds__(kBlock, kMinBlocks<NV * VEC>)
pallas_segsum_kernel(const float* __restrict__ c1,
                     const int* __restrict__ perm,
                     const int* __restrict__ src_ids,
                     const int* __restrict__ rel_off, int te, int tiles,
                     int seg_blocks, int slots, int nseg, int hd, int lg,
                     int lph, int qph,
                     float* __restrict__ dzs, float* __restrict__ seg_part,
                     int* __restrict__ seg_meta) {
  constexpr int F = NV * VEC;
  __shared__ int s_lo[kTileN], s_hi[kTileN];
  __shared__ float s_buf[F * kBlock];  // part sums
  const int tid = threadIdx.x;
  const int gl = (tid & 31) & (lg - 1);
  const int groups = kBlock / lg;
  const int grp = tid / lg;  // this lane's group in the block
  Lane<VEC, NV> ln;
  ln.init(gl, lph, qph, 1, hd);
  float acc[F];

  if (blockIdx.x >= seg_blocks) {  // block-uniform
    const int tile = blockIdx.x - seg_blocks;
    const int base = tile * kTileN;
    tile_ranges<true>(src_ids, rel_off[tile] * te, rel_off[tile + 1] * te,
                      base, s_lo, s_hi);
    bool split = false;
    for (int i = grp; i < kTileN; i += groups) {
      const int lo = s_lo[i], hi = s_hi[i];
      if (hi - lo > kSplitLen) {  // group-uniform: below, or segment blocks
        split = true;
        continue;
      }
      packet_sum(ln, c1, perm, lo, hi, hd, acc);
      ln.store(dzs + (size_t)(base + i) * hd, acc);
    }
    if (!__syncthreads_or(split)) return;  // the tile has no hub row
    for (int i = 0; i < kTileN; ++i) {  // block-uniform
      const int lo = s_lo[i], hi = s_hi[i];
      if (hi - lo <= kSplitLen || hi - lo > kSeg) continue;
      int p_lo, p_hi;
      split_part(lo, hi, grp, groups, p_lo, p_hi);
      packet_sum(ln, c1, perm, p_lo, p_hi, hd, acc);
      merge_groups(acc, s_buf, lg, groups);
      if (grp == 0) ln.store(dzs + (size_t)(base + i) * hd, acc);
    }
    return;
  }
  const int rows = tiles * kTileN;
  for (int k = blockIdx.x; k < nseg; k += seg_blocks) {
    const int p0 = k * kSeg, p1 = min(p0 + kSeg, slots);
    Run run[2];  // the same in every thread
    segment_runs<true>(src_ids, rel_off, te, rows, slots, p0, p1, run[0],
                       run[1]);
    if (tid == 0) {
      seg_meta[2 * k] = run[1].row;
      seg_meta[2 * k + 1] = run[1].hi;
    }
    for (int s = 0; s < 2; ++s) {
      if (run[s].row < 0) continue;  // block-uniform
      int p_lo, p_hi;
      split_part(max(run[s].lo, p0), min(run[s].hi, p1), grp, groups, p_lo,
                 p_hi);
      packet_sum(ln, c1, perm, p_lo, p_hi, hd, acc);
      merge_groups(acc, s_buf, lg, groups);
      if (grp == 0) ln.store(seg_part + (size_t)(2 * k + s) * hd, acc);
    }
  }
}

}  // namespace

extern "C" {

// Launches K7 on `stream` for `rows` source rows (a multiple of 128) over
// the `slots` entries of the source-sorted layout: `seg_blocks` segment
// blocks over the ceil(slots / 1024) segments and one block per 128-row
// tile, then the merge of the segments' partials (seg_part: 2 rows of
// H*D per segment, seg_meta: 2 ints per segment). Returns the cudaError_t
// of the launches (0 on success).
int gatv2_pallas_segsum(const float* c1, const int* gather_perm,
                        const int* src_ids, const int* rel_off, int te,
                        int rows, int slots, int hd, int seg_blocks,
                        float* dzs, float* seg_part, int* seg_meta,
                        cudaStream_t stream) {
  const int nseg = (slots + kSeg - 1) / kSeg;
  if (rows <= 0 || rows % kTileN != 0 || te <= 0 || slots <= 0 ||
      seg_blocks <= 0 || seg_blocks > nseg || hd <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int tiles = rows / kTileN;
  // K7 has no heads: the row's H*D features are one "head" of the geometry
  const Geometry geo =
      geometry(1, hd, aligned16(c1) && aligned16(dzs) && aligned16(seg_part));
  const int err = dispatch(geo, [&](auto vec, auto nv) {
    pallas_segsum_kernel<decltype(vec)::value, decltype(nv)::value>
        <<<tiles + seg_blocks, kBlock, 0, stream>>>(
            c1, gather_perm, src_ids, rel_off, te, tiles, seg_blocks, slots,
            nseg, hd, geo.lg, geo.lph, geo.qph, dzs, seg_part, seg_meta);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  merge_segments<kMergeBatch><<<seg_blocks, kBlock, 0, stream>>>(
      seg_part, seg_meta, nseg, hd, dzs);
  return (int)cudaGetLastError();
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
