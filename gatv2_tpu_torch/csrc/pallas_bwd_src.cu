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
// summed in source-sorted order, as the TPU kernel does.
//
// What bounds it on this card: memory. Each real edge reads one zd row and
// one g row of H*D fp32 (2 KB per edge at H*D = 256), against about 12 fp32
// operations per feature, far below the card's fp32 rate per byte.
//
// What this simple design does about it:
//  - the TPU kernel streams zs, zd, g and sigma_r PRE-GATHERED per edge
//    ([E/G, 3*H*D + 128] written by XLA gathers and read back, per chunk)
//    and reduces dzs with one-hot matmuls. Here one warp owns one source
//    node: it finds the node's edge range by binary search over the tile's
//    sorted chunk-relative source ids, reads its zs row once and holds it in
//    registers, and reads each edge's zd and g rows, sigma and r straight
//    through the edge's global destination id: no edge-space buffer;
//  - padding edges (source id = the chunk's row count, sorted last) are
//    never visited, so their destination id (0) is never read; a node
//    without an out-edge writes dzs = 0;
//  - lane t holds features t, t+32, ..., so every zd / g read is coalesced,
//    and the next edge's rows are loaded while the current one is
//    processed;
//  - each head's two dot products (score and dalpha) are summed by a group
//    of G = 32/H (power of two) lanes over shared memory, then by shuffles,
//    so each edge costs H exponentials, not H*D;
//  - no float atomics: each node is one warp's, so the result is
//    deterministic. A hub's out-edges run serially in its warp, as K5/K6 do
//    with a hub's in-edges.
// Faster variants (several rows per warp, a hub split over warps, TMA) come
// later.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileN = 128;    // source nodes per tile
constexpr int kWarps = 8;      // rows per thread block
constexpr int kMaxHd = 512;    // H*D per launch (the op splits heads)
constexpr int kMaxHeads = 16;  // heads per launch (the op's STATS_L)
constexpr int kStats = 16;     // sr row: sigma lanes [0, 16), r [16, 32)
constexpr float kExpClamp = -80.0f;
constexpr unsigned kFull = 0xffffffffu;

// The first position p in [lo, hi) with ids[p] >= key; ids ascend there.
__device__ __forceinline__ int lower_bound(const int* __restrict__ ids,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int NF>
__device__ __forceinline__ void load_row(float (&z)[NF],
                                         const float* __restrict__ row,
                                         int lane, int hd) {
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    z[j] = f < hd ? __ldg(row + f) : 0.f;
  }
}

template <int NF>  // features per lane: H*D <= 32 * NF
__global__ void __launch_bounds__(kWarps * 32)
pallas_bwd_src_kernel(const float* __restrict__ zs,
                      const float* __restrict__ zd,
                      const float* __restrict__ g,
                      const float* __restrict__ sr,
                      const float* __restrict__ a,
                      const int* __restrict__ src_ids,
                      const int* __restrict__ dst_ids,
                      const int* __restrict__ rel_off, int te, int rows,
                      int heads, int head_dim, float slope,
                      float* __restrict__ dzs) {
  // per-feature terms of the two head sums: a_f * s_act_f and g_f * zs_f
  __shared__ float part_sc[kWarps][32 * NF];
  __shared__ float part_dal[kWarps][32 * NF];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // warp-uniform; the kernel syncs warps only
  const int hd = heads * head_dim;
  // lane groups: G lanes sum head h = lane / G
  int group = 1;
  while (group * 2 * heads <= 32) group *= 2;
  const int h = lane / group;
  const int gl = lane % group;
  const bool own_head = h < heads;

  int src_lane[NF];  // a lane of the group owning each feature's head
  float av[NF];
  float acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    src_lane[j] = f < hd ? (f / head_dim) * group : 0;
    av[j] = f < hd ? a[f] : 0.f;
    acc[j] = 0.f;
  }
  float* ps = part_sc[warp];
  float* pq = part_dal[warp];

  const int tile = row / kTileN;
  const int t_hi = rel_off[tile + 1] * te;
  const int e_lo = lower_bound(src_ids, rel_off[tile] * te, t_hi, row);
  const int e_hi = lower_bound(src_ids, e_lo, t_hi, row + 1);
  if (e_hi > e_lo) {
    float z[NF];  // the node's resident zs
    load_row<NF>(z, zs + (size_t)row * hd, lane, hd);
    for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
      const int nb = min(32, e_hi - e0);
      const int my_id = lane < nb ? dst_ids[e0 + lane] : 0;
      int id = __shfl_sync(kFull, my_id, 0);
      float zdn[NF], gn[NF];
      load_row<NF>(zdn, zd + (size_t)id * hd, lane, hd);
      load_row<NF>(gn, g + (size_t)id * hd, lane, hd);
      float sig_n = own_head ? sr[(size_t)id * 2 * kStats + h] : 0.f;
      float r_n = own_head ? sr[(size_t)id * 2 * kStats + kStats + h] : 0.f;
      for (int t = 0; t < nb; ++t) {
        float zdv[NF], gv[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          zdv[j] = zdn[j];
          gv[j] = gn[j];
        }
        const float sig_h = sig_n, r_h = r_n;
        id = __shfl_sync(kFull, my_id, (t + 1) & 31);
        if (t + 1 < nb) {
          load_row<NF>(zdn, zd + (size_t)id * hd, lane, hd);
          load_row<NF>(gn, g + (size_t)id * hd, lane, hd);
          sig_n = own_head ? sr[(size_t)id * 2 * kStats + h] : 0.f;
          r_n = own_head ? sr[(size_t)id * 2 * kStats + kStats + h] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = lane + 32 * j;
          if (f < hd) {
            const float s = z[j] + zdv[j];
            ps[f] = av[j] * (s > 0.f ? s : slope * s);
            pq[f] = gv[j] * z[j];
          }
        }
        __syncwarp();
        float sc = 0.f, dal = 0.f;
        if (own_head) {
          for (int d = gl; d < head_dim; d += group) {
            sc += ps[h * head_dim + d];
            dal += pq[h * head_dim + d];
          }
        }
        for (int o = group / 2; o > 0; o >>= 1) {
          sc += __shfl_xor_sync(kFull, sc, o);
          dal += __shfl_xor_sync(kFull, dal, o);
        }
        __syncwarp();  // every read of ps/pq is done before the next edge
        const float alpha = expf(fminf(fmaxf(sc - sig_h, kExpClamp), 0.f));
        const float de = alpha * (dal - r_h);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int f = lane + 32 * j;
          const float aj = __shfl_sync(kFull, alpha, src_lane[j]);
          const float dej = __shfl_sync(kFull, de, src_lane[j]);
          if (f < hd) {
            const float s = z[j] + zdv[j];
            const float ds = dej * av[j] * (s > 0.f ? 1.f : slope);
            acc[j] += aj * gv[j] + ds;
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    if (f < hd) dzs[(size_t)row * hd + f] = acc[j];
  }
}

template <int NF>
int launch(const float* zs, const float* zd, const float* g, const float* sr,
           const float* a, const int* src_ids, const int* dst_ids,
           const int* rel_off, int te, int rows, int heads, int head_dim,
           float slope, float* dzs, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  pallas_bwd_src_kernel<NF><<<blocks, kWarps * 32, 0, stream>>>(
      zs, zd, g, sr, a, src_ids, dst_ids, rel_off, te, rows, heads, head_dim,
      slope, dzs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K8 on `stream` for `rows` source rows of one chunk (a multiple of
// 128). Returns the cudaError_t of the launch (0 on success).
int gatv2_pallas_bwd_src(const float* zs, const float* zd, const float* g,
                         const float* sr, const float* a, const int* src_ids,
                         const int* dst_ids, const int* rel_off, int te,
                         int rows, int heads, int head_dim, float slope,
                         float* dzs, cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || te <= 0 || heads <= 0 || heads > kMaxHeads ||
      head_dim <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int nf = (hd + 31) / 32;
  if (nf <= 1)
    return launch<1>(zs, zd, g, sr, a, src_ids, dst_ids, rel_off, te, rows,
                     heads, head_dim, slope, dzs, stream);
  if (nf <= 2)
    return launch<2>(zs, zd, g, sr, a, src_ids, dst_ids, rel_off, te, rows,
                     heads, head_dim, slope, dzs, stream);
  if (nf <= 4)
    return launch<4>(zs, zd, g, sr, a, src_ids, dst_ids, rel_off, te, rows,
                     heads, head_dim, slope, dzs, stream);
  if (nf <= 8)
    return launch<8>(zs, zd, g, sr, a, src_ids, dst_ids, rel_off, te, rows,
                     heads, head_dim, slope, dzs, stream);
  return launch<16>(zs, zd, g, sr, a, src_ids, dst_ids, rel_off, te, rows,
                    heads, head_dim, slope, dzs, stream);
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
