// K8 — the streamed-operand GATv2 attention backward, phase 2b (source rows
// of a chunked layout): d_zs by per-edge recompute, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/pallas_attention.py:_bwd_src_kernel
// (launched by _bwd_src_chunk, math in _edge_backward_core). It computes the
// same function: for every source node i of one chunk of the source-sorted
// edge tiles (the CSC mirror of the layout), and each of its edges e with
// global destination j = dst_e, sigma = sr[j][h] and r = sr[j][16 + h] (the
// op's _sigma_r_table rows),
//     s      = zs[i] + zd[j]
//     s_act  = LeakyReLU(s)
//     sc_h   = <s_act_h, a_h>
//     alpha  = exp(clip(sc_h - sigma, -80, 0))
//     dalpha = <g[j]_h, zs[i]_h>
//     de     = alpha * (dalpha - r)
//     ds     = de * a_h * (s > 0 ? 1 : slope)
//     dzs[i] += alpha * g[j] + ds
// i.e. the sum of K6's packets c1 over the node's out-edges, rebuilt from
// the destination side instead of read from a packet buffer. The edges are
// summed in source-sorted order, as the TPU kernel does (a split row: in
// order within each part, then the parts in order).
//
// What bounds it on this card: memory, and on a random graph not the
// kernel's byte bound (each destination row read once) but the per-edge
// gather floor: the zd and g tables (1 GB at H*D = 256 on products-sub)
// outgrow the 50 MB L2 and a random graph's destinations have little
// locality, so each real edge reads one zd row, one g row, the two 32-byte
// sectors of its sr row that hold sigma and r, and its id from device
// memory, plus the rows' zs reads and dzs writes. Every edge's gathers are
// independent, so what the design has to do is keep enough of them in
// flight, as K4 (sell_bwd_src.cu) does on the SELL layout.
//
// The design (a first version gave one warp to each source node, found its
// range by two binary searches in device memory, summed heads over shared
// memory with two __syncwarp per edge and walked a hub's out-edges in that
// one warp: 4.502 / 0.911 / 0.917 ms at H*D = 256 / 32 / 16 on
// products-sub's full-graph source chunk 0):
//  - one block of 128 threads per 128-node source tile of the chunk
//    (edge_tiles.cuh): row ranges from adjacent differences of the tile's
//    sorted chunk-relative source ids in shared memory (padding carries the
//    chunk's row count or more, so it names no row of any tile); a row
//    without an out-edge writes dzs = 0;
//  - lane groups sized to the width (lane_groups.cuh), as in K4: the row's
//    zs stays in registers; each edge's zd and g rows are read through its
//    global destination id with evict-first loads (read once: they stream
//    through L2 without pushing out the sr table and the ids), and sigma
//    and r from its sr row; head sums are shuffle-only inside the head and
//    every lane of a head computes alpha and de itself;
//  - a register ring of R = kRing<F> edges: a group issues the zd, g,
//    sigma and r loads of R edges (and the next R ids) before it computes
//    the first, and the register budget is cut per width (kMinBlocks);
//  - source hubs split (edge_tiles.cuh): a row of 256 < len <= 1024 edges
//    over the block's groups, a longer one over segment blocks of 1024
//    slots and a merge launch, all partials added in part order, with no
//    atomics.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W): 3.215 / 0.548 / 0.405 ms at
// H*D = 256 / 32 / 16 on products-sub's full-graph source chunk 0
// (chip_smoke.py; per-edge gather floor 2.686 / 0.411 / 0.249 ms). On a
// synthetic chunk of that shape (tools/torch_kernel_variants.py) it takes
// 3.192 / 0.548 / 0.397 ms where a bare gather of the same rows in the
// same order takes 2.731 / 0.466 / 0.378: within 1.05-1.18x of what the
// memory system delivers for its access pattern. On arxiv-pl on 3 chunks
// one training step's K8 device time fell from 656 ms (a 226,924-edge
// source hub in one warp) to 5.0 ms.

#include <cuda_runtime.h>

#include <cstddef>

#include "edge_tiles.cuh"
#include "lane_groups.cuh"

namespace {

using namespace edge_tiles;
using namespace lane_groups;

constexpr int kMaxHd = 512;    // H*D per launch (the op splits heads)
constexpr int kMaxHeads = 16;  // heads per launch (the op's STATS_L)
constexpr int kStats = 16;     // sr row: sigma lanes [0, 16), r [16, 32)
constexpr float kExpClamp = -80.0f;
// zd and g rows are read once per edge: evict-first loads
// (tools/torch_kernel_variants.py times ordinary ones).
constexpr bool kEvictFirst = true;

// Edges a group keeps in flight (the register ring), and the blocks per SM
// the register budget is cut for, by F = floats per lane. On a synthetic
// products-sub source chunk 0 tools/torch_kernel_variants.py measured
// (H*D = 256 / 32 / 16; NVIDIA H100 80GB HBM3, 700.00 W): 2 edges at 8
// blocks (F = 4: 64 registers) 0.571 / 0.396 ms at 32 / 16 against 0.624
// / 0.418 for K4's 4 at 6 blocks (80, spilling); 4 edges at 4 blocks (F =
// 8: 114 registers) 3.333 ms at 256 against 3.445 for 2 at 6 blocks (80,
// spilling) and 3.311 for 4 at 3 blocks (156).
template <int F>
constexpr int kRing = F <= 4 ? 2 : F <= 8 ? 4 : 1;
template <int F>
constexpr int kMinBlocks = F <= 4 ? 8 : F <= 8 ? 4 : F <= 16 ? 3 : 1;

// acc = the packet sum of source row `row` over its edges [lo, hi) (all of
// them or one part).
template <int VEC, int NV>
__device__ __forceinline__ void src_edges(
    const Lane<VEC, NV>& ln, const float* __restrict__ zs,
    const float* __restrict__ zd, const float* __restrict__ g,
    const float* __restrict__ sr, const int* __restrict__ dst_ids,
    const float (&av)[NV * VEC], int row, int lo, int hi, int hd, int h,
    bool own_head, int lph, unsigned mask, float slope,
    float (&acc)[NV * VEC]) {
  constexpr int F = NV * VEC;
  constexpr int R = kRing<F>;
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  if (hi <= lo) return;  // group-uniform
  float z[F];  // the row's resident zs
  ln.load(z, zs + (size_t)row * hd);
  int id[R];
#pragma unroll
  for (int i = 0; i < R; ++i) id[i] = lo + i < hi ? __ldg(dst_ids + lo + i) : 0;
  for (int e0 = lo; e0 < hi; e0 += R) {
    float zdv[R][F], gv[R][F], sg[R], rv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool real = e0 + i < hi;
      if (real) {
        ln.load(zdv[i], zd + (size_t)id[i] * hd, kEvictFirst);
        ln.load(gv[i], g + (size_t)id[i] * hd, kEvictFirst);
      }
      const float* st = sr + (size_t)id[i] * (2 * kStats);
      sg[i] = real && own_head ? __ldg(st + h) : 0.f;
      rv[i] = real && own_head ? __ldg(st + kStats + h) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = e0 + R + i;
      id[i] = e < hi ? __ldg(dst_ids + e) : 0;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (e0 + i >= hi) break;  // group-uniform
      float sc = 0.f, dal = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float s = z[f] + zdv[i][f];
        sc += av[f] * (s > 0.f ? s : slope * s);
        dal += gv[i][f] * z[f];
      }
      sc = head_sum(sc, lph, mask);
      dal = head_sum(dal, lph, mask);
      const float alpha = expf(fminf(fmaxf(sc - sg[i], kExpClamp), 0.f));
      const float de = alpha * (dal - rv[i]);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float s = z[f] + zdv[i][f];
        acc[f] += alpha * gv[i][f] + de * av[f] * (s > 0.f ? 1.f : slope);
      }
    }
  }
}

// Blocks [0, tiles) take one source tile each; the others are segment
// blocks (edge_tiles.cuh), striding over the nseg segments of kSeg slots.
template <int VEC, int NV>
__global__ void __launch_bounds__(kBlock, kMinBlocks<NV * VEC>)
pallas_bwd_src_kernel(const float* __restrict__ zs,
                      const float* __restrict__ zd,
                      const float* __restrict__ g,
                      const float* __restrict__ sr,
                      const float* __restrict__ a,
                      const int* __restrict__ src_ids,
                      const int* __restrict__ dst_ids,
                      const int* __restrict__ rel_off, int te, int tiles,
                      int slots, int nseg, int heads, int head_dim, int lg,
                      int lph, int qph, float slope, float* __restrict__ dzs,
                      float* __restrict__ seg_part,
                      int* __restrict__ seg_meta) {
  constexpr int F = NV * VEC;
  __shared__ int s_lo[kTileN], s_hi[kTileN];
  __shared__ float s_buf[F * kBlock];  // part sums
  __shared__ Run s_run[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int hd = heads * head_dim;
  const int gl = lane & (lg - 1);
  const unsigned mask = group_mask(lane, lg);
  const int h = gl / lph;
  const bool own_head = h < heads;
  const int groups = kBlock / lg;
  const int grp = tid / lg;  // this lane's group in the block
  Lane<VEC, NV> ln;
  ln.init(gl, lph, qph, heads, head_dim);
  float av[F], acc[F];
  ln.load(av, a);

  if (blockIdx.x < tiles) {  // block-uniform
    const int base = blockIdx.x * kTileN;
    tile_ranges(src_ids, rel_off[blockIdx.x] * te,
                rel_off[blockIdx.x + 1] * te, base, s_lo, s_hi);
    bool split = false;
    for (int i = grp; i < kTileN; i += groups) {
      const int lo = s_lo[i], hi = s_hi[i];
      if (hi - lo > kHub) {  // group-uniform: below, or segment blocks
        split = true;
        continue;
      }
      src_edges(ln, zs, zd, g, sr, dst_ids, av, base + i, lo, hi, hd, h,
                own_head, lph, mask, slope, acc);
      ln.store(dzs + (size_t)(base + i) * hd, acc);
    }
    if (!__syncthreads_or(split)) return;  // the tile has no hub row
    for (int i = 0; i < kTileN; ++i) {  // block-uniform
      const int lo = s_lo[i], hi = s_hi[i];
      if (hi - lo <= kHub || hi - lo > kSeg) continue;
      int p_lo, p_hi;
      split_part(lo, hi, grp, groups, p_lo, p_hi);
      src_edges(ln, zs, zd, g, sr, dst_ids, av, base + i, p_lo, p_hi, hd, h,
                own_head, lph, mask, slope, acc);
      merge_groups(acc, s_buf, lg, groups);
      if (grp == 0) ln.store(dzs + (size_t)(base + i) * hd, acc);
    }
    return;
  }
  const int rows = tiles * kTileN;
  for (int k = blockIdx.x - tiles; k < nseg; k += gridDim.x - tiles) {
    const int p0 = k * kSeg, p1 = min(p0 + kSeg, slots);
    __syncthreads();  // the previous segment's runs have been read
    if (tid == 0) {
      segment_runs(src_ids, rel_off, te, rows, slots, p0, p1, s_run[0],
                   s_run[1]);
      seg_meta[2 * k] = s_run[1].row;
      seg_meta[2 * k + 1] = s_run[1].hi;
    }
    __syncthreads();
    for (int s = 0; s < 2; ++s) {
      const Run run = s_run[s];
      if (run.row < 0) continue;  // block-uniform
      int p_lo, p_hi;
      split_part(max(run.lo, p0), min(run.hi, p1), grp, groups, p_lo, p_hi);
      src_edges(ln, zs, zd, g, sr, dst_ids, av, run.row, p_lo, p_hi, hd, h,
                own_head, lph, mask, slope, acc);
      merge_groups(acc, s_buf, lg, groups);
      if (grp == 0) ln.store(seg_part + (size_t)(2 * k + s) * hd, acc);
    }
  }
}

}  // namespace

extern "C" {

// Launches K8 on `stream` for the `rows` source rows of one chunk (a
// multiple of 128) over its `slots` edge slots: one block per 128-row tile
// and `seg_blocks` segment blocks over the ceil(slots / 1024) segments,
// then the merge of the segments' partials (seg_part: 2 rows of H*D per
// segment, seg_meta: 2 ints per segment). Returns the cudaError_t of the
// launches (0 on success).
int gatv2_pallas_bwd_src(const float* zs, const float* zd, const float* g,
                         const float* sr, const float* a, const int* src_ids,
                         const int* dst_ids, const int* rel_off, int te,
                         int rows, int slots, int heads, int head_dim,
                         float slope, int seg_blocks, float* dzs,
                         float* seg_part, int* seg_meta,
                         cudaStream_t stream) {
  const int hd = heads * head_dim;
  const int nseg = (slots + kSeg - 1) / kSeg;
  if (rows <= 0 || rows % kTileN != 0 || te <= 0 || slots <= 0 ||
      seg_blocks <= 0 || seg_blocks > nseg || heads <= 0 ||
      heads > kMaxHeads || head_dim <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int tiles = rows / kTileN;
  const Geometry geo = geometry(
      heads, head_dim,
      aligned16(zs) && aligned16(zd) && aligned16(g) && aligned16(a) &&
          aligned16(dzs) && aligned16(seg_part));
  const int err = dispatch(geo, [&](auto vec, auto nv) {
    pallas_bwd_src_kernel<decltype(vec)::value, decltype(nv)::value>
        <<<tiles + seg_blocks, kBlock, 0, stream>>>(
            zs, zd, g, sr, a, src_ids, dst_ids, rel_off, te, tiles, slots,
            nseg, heads, head_dim, geo.lg, geo.lph, geo.qph, slope, dzs,
            seg_part, seg_meta);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  merge_segments<<<seg_blocks, kBlock, 0, stream>>>(seg_part, seg_meta, nseg,
                                                    hd, dzs);
  return (int)cudaGetLastError();
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
