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
//
// What this simple design does about it:
//  - the TPU kernel streams zs and a [zd | g | sigma_r] block PRE-GATHERED
//    per edge ([E, 3*H*D + 128] written by XLA gathers and read back) and
//    reduces dzd with one-hot matmuls. Here one warp owns one destination
//    row: it finds the row's edge range by binary search over the tile's
//    sorted destination ids, reads zd, g, sigma and r of the row once, and
//    each zs[src_e] straight through the source ids;
//  - padding edges are never visited: their c1 slots are left unwritten
//    (K7 skips them by id), and a row without an edge writes dzd = 0, which
//    is what the TPU kernel's zero padding rows give;
//  - lane t holds features t, t+32, ..., so every zs read and c1 write is
//    coalesced, and the next edge's zs row is loaded while the current one
//    is processed;
//  - each head's two dot products (score and dalpha) are summed by a group
//    of G = 32/H (power of two) lanes over shared memory, then by shuffles,
//    so each edge costs H exponentials, not H*D;
//  - d_a is summed per thread block in a fixed order and written as one
//    partial per block (no float atomics, so the result is deterministic);
//    the wrapper sums the partials. Blocks stride over rows so the partials
//    stay few.
// Faster variants (several rows per warp, TMA) come later.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileN = 128;    // destination nodes per tile
constexpr int kWarps = 8;      // rows in flight per thread block
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
pallas_bwd_dst_kernel(const float* __restrict__ zs,
                      const float* __restrict__ zd,
                      const float* __restrict__ g,
                      const float* __restrict__ sr,
                      const float* __restrict__ a,
                      const int* __restrict__ dst_ids,
                      const int* __restrict__ src_ids,
                      const int* __restrict__ rel_off, int te, int rows,
                      int heads, int head_dim, float slope,
                      float* __restrict__ dzd, float* __restrict__ da_part,
                      float* __restrict__ c1) {
  // per-feature terms of the two head sums: a_f * s_act_f and g_f * zs_f
  __shared__ float part_sc[kWarps][32 * NF];
  __shared__ float part_dal[kWarps][32 * NF];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hd = heads * head_dim;
  // lane groups: G lanes sum head h = lane / G
  int group = 1;
  while (group * 2 * heads <= 32) group *= 2;
  const int h = lane / group;
  const int gl = lane % group;

  int src_lane[NF];  // a lane of the group owning each feature's head
  float av[NF];
  float da_acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    src_lane[j] = f < hd ? (f / head_dim) * group : 0;
    av[j] = f < hd ? a[f] : 0.f;
    da_acc[j] = 0.f;
  }
  float* ps = part_sc[warp];
  float* pq = part_dal[warp];
  const bool emit = c1 != nullptr;  // uniform over the launch

  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {  // warp-uniform
    const int tile = row / kTileN;
    const int t_hi = rel_off[tile + 1] * te;
    const int e_lo = lower_bound(dst_ids, rel_off[tile] * te, t_hi, row);
    const int e_hi = lower_bound(dst_ids, e_lo, t_hi, row + 1);
    float dacc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) dacc[j] = 0.f;

    if (e_hi > e_lo) {
      const float* zd_row = zd + (size_t)row * hd;
      const float* g_row = g + (size_t)row * hd;
      float zdv[NF], gv[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = lane + 32 * j;
        zdv[j] = f < hd ? zd_row[f] : 0.f;
        gv[j] = f < hd ? g_row[f] : 0.f;
      }
      const float* sr_row = sr + (size_t)row * (2 * kStats);
      const float sig_h = h < heads ? sr_row[h] : 0.f;
      const float r_h = h < heads ? sr_row[kStats + h] : 0.f;
      for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
        const int nb = min(32, e_hi - e0);
        const int my_id = lane < nb ? src_ids[e0 + lane] : 0;
        float zn[NF];
        load_row<NF>(zn, zs + (size_t)__shfl_sync(kFull, my_id, 0) * hd,
                     lane, hd);
        for (int t = 0; t < nb; ++t) {
          float z[NF];
#pragma unroll
          for (int j = 0; j < NF; ++j) z[j] = zn[j];
          const int next = __shfl_sync(kFull, my_id, (t + 1) & 31);
          if (t + 1 < nb) load_row<NF>(zn, zs + (size_t)next * hd, lane, hd);
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
          if (h < heads) {
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
          float* c1_row = emit ? c1 + (size_t)(e0 + t) * hd : nullptr;
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            const int f = lane + 32 * j;
            const float aj = emit ? __shfl_sync(kFull, alpha, src_lane[j]) : 0.f;
            const float dej = __shfl_sync(kFull, de, src_lane[j]);
            if (f < hd) {
              const float s = z[j] + zdv[j];
              const bool pos = s > 0.f;
              const float ds = dej * av[j] * (pos ? 1.f : slope);
              dacc[j] += ds;
              da_acc[j] += dej * (pos ? s : slope * s);
              if (emit) c1_row[f] = aj * gv[j] + ds;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = lane + 32 * j;
      if (f < hd) dzd[(size_t)row * hd + f] = dacc[j];
    }
  }

  // the block's d_a partial: the warps' sums added in warp order
  __syncthreads();  // every warp is done with its part_sc row
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    if (f < hd) part_sc[warp][f] = da_acc[j];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < hd; f += kWarps * 32) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part_sc[w][f];
    da_part[(size_t)blockIdx.x * hd + f] = s;
  }
}

template <int NF>
int launch(const float* zs, const float* zd, const float* g, const float* sr,
           const float* a, const int* dst_ids, const int* src_ids,
           const int* rel_off, int te, int rows, int heads, int head_dim,
           float slope, int blocks, float* dzd, float* da_part, float* c1,
           cudaStream_t stream) {
  pallas_bwd_dst_kernel<NF><<<blocks, kWarps * 32, 0, stream>>>(
      zs, zd, g, sr, a, dst_ids, src_ids, rel_off, te, rows, heads, head_dim,
      slope, dzd, da_part, c1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K6 on `stream` for `rows` destination rows (a multiple of 128)
// with `blocks` thread blocks of 8 warps; da_part holds blocks x H*D
// partials. c1 may be null: then no packet is written. Returns the
// cudaError_t of the launch (0 on success).
int gatv2_pallas_bwd_dst(const float* zs, const float* zd, const float* g,
                         const float* sr, const float* a, const int* dst_ids,
                         const int* src_ids, const int* rel_off, int te,
                         int rows, int heads, int head_dim, float slope,
                         int blocks, float* dzd, float* da_part, float* c1,
                         cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || te <= 0 || blocks <= 0 || heads <= 0 ||
      heads > kMaxHeads || head_dim <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int nf = (hd + 31) / 32;
  if (nf <= 1)
    return launch<1>(zs, zd, g, sr, a, dst_ids, src_ids, rel_off, te, rows,
                     heads, head_dim, slope, blocks, dzd, da_part, c1,
                     stream);
  if (nf <= 2)
    return launch<2>(zs, zd, g, sr, a, dst_ids, src_ids, rel_off, te, rows,
                     heads, head_dim, slope, blocks, dzd, da_part, c1,
                     stream);
  if (nf <= 4)
    return launch<4>(zs, zd, g, sr, a, dst_ids, src_ids, rel_off, te, rows,
                     heads, head_dim, slope, blocks, dzd, da_part, c1,
                     stream);
  if (nf <= 8)
    return launch<8>(zs, zd, g, sr, a, dst_ids, src_ids, rel_off, te, rows,
                     heads, head_dim, slope, blocks, dzd, da_part, c1,
                     stream);
  return launch<16>(zs, zd, g, sr, a, dst_ids, src_ids, rel_off, te, rows,
                    heads, head_dim, slope, blocks, dzd, da_part, c1, stream);
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
