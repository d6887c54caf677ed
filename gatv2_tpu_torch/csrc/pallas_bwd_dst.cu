// K6 — the streamed-operand GATv2 attention backward, phase 1 (destination
// rows), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/pallas_attention.py:_bwd_dst_kernel
// (launched by _bwd_dst_chunk, math in _edge_backward_core), with and without
// emit_c1. It computes the same function: for
// every real edge e of the destination-sorted edge tiles, with j = dst_e,
// sigma = sr[j][h] and r = sr[j][16 + h] (the op's _sigma_r_table rows),
//     s      = zs[src_e] + zd[j]
//     s_act  = LeakyReLU(s)
//     sc_h   = <s_act_h, a_h>
//     alpha  = exp(clip(sc_h - sigma, -80, 0))
//     dalpha = <g[j]_h, zs[src_e]_h>
//     de     = alpha * (dalpha - r)
//     ds     = de * a_h * (s > 0 ? 1 : slope)
// and accumulates dzd[j] += ds (per row), d_a += de * s_act, and writes the
// per-edge packet c1[e] = alpha * g[j] + ds, which K7 (pallas_segsum.cu)
// sums per source row into d_zs. On a chunked layout (the TPU kernel's
// emit_c1=False, one launch per chunk of node tiles) c1 is null and no
// packet is written: K8 (pallas_bwd_src.cu) recomputes each edge's packet
// from the source side instead. dzd and d_a are the same numbers either way.
//
// What bounds it on this card: memory. Each real edge reads one zs row and
// writes one c1 row of H*D fp32 (2 KB per edge at H*D = 256), against about
// 15 fp32 operations per feature, far below the card's fp32 rate per byte.
// A sampled batch's sources repeat little, so the per-edge gather floor
// (one zs row read and one c1 row written per real edge, plus the rows' zd,
// g, sigma, r and dzd) is close to the byte bound; what the design has to
// do is keep enough gathers in flight, spend nothing on rows without edges
// and keep a hub row off one lane group's serial path.
//
// The design (a first version gave one warp to each row, found its range
// by two binary searches in device memory, summed heads over shared memory
// with two __syncwarp per edge and walked a hub's edges in that one warp:
// 1.143 / 0.282 / 0.292 ms at H*D = 256 / 32 / 16 on a products-sub batch):
//  - one block of 128 threads per 128-node destination tile, as in K5
//    (edge_tiles.cuh): row ranges from adjacent differences of the tile's
//    sorted ids in shared memory; the layout is unchanged. Padding slots
//    are never visited: their c1 rows are left unwritten (K7 skips them by
//    id), and a row without an edge writes dzd = 0;
//  - lane groups sized to the width (lane_groups.cuh), as in K2: 16-byte
//    vectors when D % 4 == 0 and the tables are aligned; the row's zd, g,
//    sigma and r are read once per row, each zs[src] through its id; the
//    score and dalpha head sums are shuffle-only inside the head, every
//    lane of a head computes alpha and de itself, and each edge's c1 row is
//    written by the group's vector stores in slot order;
//  - a rotating register ring of R = kRing<F> zs rows (the loads of the
//    next R - 1 edges in flight while one is computed) and the register
//    budget cut per width (kMinBlocks);
//  - hub rows split (edge_tiles.cuh): a row of 256 < len <= 1024 edges
//    over the block's groups, a longer one over segment blocks of 1024
//    slots and a merge launch; sigma and r are known per row, so the parts'
//    dzd sums simply add, in part order;
//  - dzd and d_a do not depend on emit_c1: their adds are explicit
//    (__fadd_rn, fmaf), so the packet branch cannot change how they are
//    contracted. d_a has no float atomics: each lane sums its own features
//    over the edges it takes, then the warp's groups are added by
//    __shfl_xor_sync and the block's warps in warp order, one partial per
//    block, which the wrapper sums in a fixed order. Tile blocks stride
//    over the tiles, so the partials stay at most (4096 + 512) x H*D.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W): 1.116 / 0.176 / 0.157 ms at
// H*D = 256 / 32 / 16 on a products-sub batch with packets (chip_smoke.py,
// the wrapper's time; per-edge gather floor 0.822 / 0.105 / 0.054 ms). On
// a synthetic batch of that shape (tools/torch_kernel_variants.py) the
// launch takes 1.044 / 0.169 / 0.100 ms, 0.709 / 0.127 / 0.078 without
// packets, where a bare gather of one zs row and store of one c1 row per
// edge takes 0.715 / 0.111 / 0.061: the rest at H*D = 256 is the dzd rows
// (the batch's ~389k rows without an edge write zeros) and the rows' zd
// and g. On arxiv-pl, whose largest row has 226,924 edges, one training
// step's K6 device time fell from 471 ms (the hub in one warp) to 3.8 ms.

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
// zs rows are read with ordinary loads (tools/torch_kernel_variants.py
// times evict-first ones).
constexpr bool kZsEvictFirst = false;

// zs rows a group keeps in the ring, and the blocks per SM the register
// budget is cut for, by F = floats per lane. On a synthetic products-sub
// batch with packets tools/torch_kernel_variants.py measured (H*D = 256 /
// 32 / 16; NVIDIA H100 80GB HBM3, 700.00 W): a ring of 2 at 8 blocks (F =
// 4, 64 registers) and 4 (F = 8, 125) 1.060 / 0.168 / 0.102 ms; one edge
// at a time 1.186 / 0.192 / 0.117, also at 12 / 6 blocks 1.241 / 0.217 /
// 0.135; 4 edges at 6 / 3 blocks 1.156 / 0.229 / 0.130; 2 at 6 / 3 blocks
// 1.169 / 0.219 / 0.129. Evict-first zs loads or c1 stores gain nothing.
template <int F>
constexpr int kRing = F <= 8 ? 2 : 1;
template <int F>
constexpr int kMinBlocks = F <= 4 ? 8 : F <= 8 ? 4 : F <= 16 ? 2 : 1;

// The edges [lo, hi) of destination row `row` (all of its edges or one
// part): dacc = their dzd sum, da_acc += their d_a terms, and with c1 each
// edge's packet.
template <int VEC, int NV>
__device__ __forceinline__ void dst_edges(
    const Lane<VEC, NV>& ln, const float* __restrict__ zs,
    const float* __restrict__ zd, const float* __restrict__ g,
    const float* __restrict__ sr, const int* __restrict__ src_ids,
    const float (&av)[NV * VEC], int row, int lo, int hi, int hd, int h,
    bool own_head, int lph, unsigned mask, float slope,
    float (&dacc)[NV * VEC], float (&da_acc)[NV * VEC],
    float* __restrict__ c1) {
  constexpr int F = NV * VEC;
  constexpr int R = kRing<F>;
#pragma unroll
  for (int f = 0; f < F; ++f) dacc[f] = 0.f;
  if (hi <= lo) return;  // group-uniform
  float zdv[F], gv[F];
  ln.load(zdv, zd + (size_t)row * hd);
  ln.load(gv, g + (size_t)row * hd);
  const float* st = sr + (size_t)row * (2 * kStats);
  const float sig = own_head ? __ldg(st + h) : 0.f;
  const float r_h = own_head ? __ldg(st + kStats + h) : 0.f;
  // the ring: slot j holds an edge's zs row from its load to its compute,
  // and id[j] the source id of the next edge loaded into it; while edge k
  // is computed, the loads of edges k+1 .. k+R-1 are in flight and the
  // ids of the next R edges are known
  int id[R];
  float z[R][F];
#pragma unroll
  for (int j = 0; j < R; ++j)
    id[j] = lo + j < hi ? __ldg(src_ids + lo + j) : 0;
#pragma unroll
  for (int j = 0; j + 1 < R; ++j) {
    if (lo + j < hi) ln.load(z[j], zs + (size_t)id[j] * hd, kZsEvictFirst);
    id[j] = lo + j + R < hi ? __ldg(src_ids + lo + j + R) : 0;
  }
  for (int k0 = lo; k0 < hi; k0 += R) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = k0 + i;
      if (k >= hi) break;  // group-uniform
      const int j = (i + R - 1) % R;  // the slot of edge k + R - 1
      if (k + R - 1 < hi) {
        ln.load(z[j], zs + (size_t)id[j] * hd, kZsEvictFirst);
        const int kn = k + 2 * R - 1;
        id[j] = kn < hi ? __ldg(src_ids + kn) : 0;
      }
      float sc = 0.f, dal = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float s = z[i][f] + zdv[f];
        sc += av[f] * (s > 0.f ? s : slope * s);
        dal += gv[f] * z[i][f];
      }
      sc = head_sum(sc, lph, mask);
      dal = head_sum(dal, lph, mask);
      const float alpha = expf(fminf(fmaxf(sc - sig, kExpClamp), 0.f));
      const float de = alpha * (dal - r_h);
      float pk[F];  // this edge's packet c1
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float s = z[i][f] + zdv[f];
        const bool pos = s > 0.f;
        const float ds = de * av[f] * (pos ? 1.f : slope);
        // explicit roundings: whether the packet is written (ds used twice
        // or once) must not change how dzd and d_a are contracted
        dacc[f] = __fadd_rn(dacc[f], ds);
        da_acc[f] = fmaf(de, pos ? s : slope * s, da_acc[f]);
        pk[f] = alpha * gv[f] + ds;
      }
      if (c1 != nullptr) ln.store(c1 + (size_t)k * hd, pk);
    }
  }
}

// Blocks [0, tile_blocks) stride over the tiles; the others are segment
// blocks (edge_tiles.cuh), striding over the nseg segments of kSeg slots.
template <int VEC, int NV>
__global__ void __launch_bounds__(kBlock, kMinBlocks<NV * VEC>)
pallas_bwd_dst_kernel(const float* __restrict__ zs,
                      const float* __restrict__ zd,
                      const float* __restrict__ g,
                      const float* __restrict__ sr,
                      const float* __restrict__ a,
                      const int* __restrict__ dst_ids,
                      const int* __restrict__ src_ids,
                      const int* __restrict__ rel_off, int te, int tiles,
                      int slots, int tile_blocks, int nseg, int heads,
                      int head_dim, int lg, int lph, int qph, float slope,
                      float* __restrict__ dzd, float* __restrict__ da_part,
                      float* __restrict__ c1, float* __restrict__ seg_part,
                      int* __restrict__ seg_meta) {
  constexpr int F = NV * VEC;
  __shared__ int s_lo[kTileN], s_hi[kTileN];
  __shared__ float s_buf[F * kBlock];  // part sums, then d_a partials
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
  float av[F], da_acc[F], dacc[F];
  ln.load(av, a);
#pragma unroll
  for (int f = 0; f < F; ++f) da_acc[f] = 0.f;

  if (blockIdx.x < tile_blocks) {  // block-uniform
    for (int tile = blockIdx.x; tile < tiles; tile += tile_blocks) {
      const int base = tile * kTileN;
      tile_ranges(dst_ids, rel_off[tile] * te, rel_off[tile + 1] * te, base,
                  s_lo, s_hi);
      bool split = false;
      for (int i = grp; i < kTileN; i += groups) {
        const int lo = s_lo[i], hi = s_hi[i];
        if (hi - lo > kHub) {  // group-uniform: below, or segment blocks
          split = true;
          continue;
        }
        dst_edges(ln, zs, zd, g, sr, src_ids, av, base + i, lo, hi, hd, h,
                  own_head, lph, mask, slope, dacc, da_acc, c1);
        ln.store(dzd + (size_t)(base + i) * hd, dacc);
      }
      if (!__syncthreads_or(split)) continue;  // the tile has no hub row
      for (int i = 0; i < kTileN; ++i) {  // block-uniform
        const int lo = s_lo[i], hi = s_hi[i];
        if (hi - lo <= kHub || hi - lo > kSeg) continue;
        int p_lo, p_hi;
        split_part(lo, hi, grp, groups, p_lo, p_hi);
        dst_edges(ln, zs, zd, g, sr, src_ids, av, base + i, p_lo, p_hi, hd,
                  h, own_head, lph, mask, slope, dacc, da_acc, c1);
        merge_groups(dacc, s_buf, lg, groups);
        if (grp == 0) ln.store(dzd + (size_t)(base + i) * hd, dacc);
      }
    }
  } else {
    const int rows = tiles * kTileN;
    for (int k = blockIdx.x - tile_blocks; k < nseg;
         k += gridDim.x - tile_blocks) {
      const int p0 = k * kSeg, p1 = min(p0 + kSeg, slots);
      __syncthreads();  // the previous segment's runs have been read
      if (tid == 0) {
        segment_runs(dst_ids, rel_off, te, rows, slots, p0, p1, s_run[0],
                     s_run[1]);
        seg_meta[2 * k] = s_run[1].row;
        seg_meta[2 * k + 1] = s_run[1].hi;
      }
      __syncthreads();
      for (int s = 0; s < 2; ++s) {
        const Run run = s_run[s];
        if (run.row < 0) continue;  // block-uniform
        int p_lo, p_hi;
        split_part(max(run.lo, p0), min(run.hi, p1), grp, groups, p_lo,
                   p_hi);
        dst_edges(ln, zs, zd, g, sr, src_ids, av, run.row, p_lo, p_hi, hd,
                  h, own_head, lph, mask, slope, dacc, da_acc, c1);
        merge_groups(dacc, s_buf, lg, groups);
        if (grp == 0) ln.store(seg_part + (size_t)(2 * k + s) * hd, dacc);
      }
    }
  }

  // the block's d_a partial: the warp's groups added over the group-index
  // bits (every lane ends with the same sums), then the warps in warp order
#pragma unroll
  for (int f = 0; f < F; ++f)
    for (int o = lg; o < 32; o <<= 1)
      da_acc[f] += __shfl_xor_sync(kFull, da_acc[f], o);
  const int warp = tid >> 5;
  __syncthreads();  // s_buf is free (hd <= 32 * F, so kWarps rows fit)
  if (lane < lg) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ln.ok[j]) continue;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        s_buf[warp * hd + ln.off[j] + v] = da_acc[VEC * j + v];
    }
  }
  __syncthreads();
  for (int f = tid; f < hd; f += kBlock) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_buf[w * hd + f];
    da_part[(size_t)blockIdx.x * hd + f] = s;
  }
}

}  // namespace

extern "C" {

// Launches K6 on `stream` for the `rows` destination rows of one chunk (a
// multiple of 128) over its `slots` edge slots: `tile_blocks` blocks that
// stride over the tiles and `seg_blocks` segment blocks over the
// ceil(slots / 1024) segments, then the merge of the segments' partials
// (seg_part: 2 rows of H*D per segment, seg_meta: 2 ints per segment).
// da_part holds (tile_blocks + seg_blocks) x H*D partials. c1 may be null:
// then no packet is written. Returns the cudaError_t of the launches (0 on
// success).
int gatv2_pallas_bwd_dst(const float* zs, const float* zd, const float* g,
                         const float* sr, const float* a, const int* dst_ids,
                         const int* src_ids, const int* rel_off, int te,
                         int rows, int slots, int heads, int head_dim,
                         float slope, int tile_blocks, int seg_blocks,
                         float* dzd, float* da_part, float* c1,
                         float* seg_part, int* seg_meta,
                         cudaStream_t stream) {
  const int hd = heads * head_dim;
  const int nseg = (slots + kSeg - 1) / kSeg;
  if (rows <= 0 || rows % kTileN != 0 || te <= 0 || slots <= 0 ||
      tile_blocks <= 0 || seg_blocks <= 0 || seg_blocks > nseg ||
      heads <= 0 || heads > kMaxHeads || head_dim <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(
      heads, head_dim,
      aligned16(zs) && aligned16(zd) && aligned16(g) && aligned16(a) &&
          aligned16(dzd) && aligned16(seg_part) &&
          (c1 == nullptr || aligned16(c1)));
  const int err = dispatch(geo, [&](auto vec, auto nv) {
    pallas_bwd_dst_kernel<decltype(vec)::value, decltype(nv)::value>
        <<<tile_blocks + seg_blocks, kBlock, 0, stream>>>(
            zs, zd, g, sr, a, dst_ids, src_ids, rel_off, te, rows / kTileN,
            slots, tile_blocks, nseg, heads, head_dim, geo.lg, geo.lph,
            geo.qph, slope, dzd, da_part, c1, seg_part, seg_meta);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  merge_segments<<<seg_blocks, kBlock, 0, stream>>>(seg_part, seg_meta, nseg,
                                                    hd, dzd);
  return (int)cudaGetLastError();
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
