// K4 — the SELL-128 GATv2 attention backward, phase 2b (source rows of a
// chunked layout): d_zs by per-edge recompute, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/sell_attention.py:_sell_bwd_src_kernel
// (launched by _sell_bwd_src). It computes the same function: for every
// virtual row j of one chunk of the source-sorted SELL-128 layout, with
// source node n = perm[j] and, for each real slot of the row, dst = the
// slot's global destination id,
//     s      = zs[n] + zd[dst]
//     s_act  = LeakyReLU(s)
//     sc_h   = <s_act_h, a_h>
//     alpha  = exp(clip(sc_h - sigma[dst,h], -80, 0))
//     dalpha = <g[dst]_h, zs[n]_h>
//     de     = alpha * (dalpha - r[dst,h])
//     ds     = de * a_h * (s > 0 ? 1 : slope)
//     dzs[j] += alpha * g[dst] + ds
// i.e. the sum of K2's packets c1 over the row's edges, rebuilt from the
// destination side instead of read from a packet buffer. The columns are
// summed in order, as the TPU kernel does.
//
// What bounds it on this card: memory. Each real edge reads one zd row and
// one g row of H*D fp32 (1 KB per edge at H*D = 128), against about 12 fp32
// operations per feature, far below the card's fp32 rate per byte.
//
// What this simple design does about it:
//  - the TPU path gathers zd, g and the packed [sigma | r] block per edge
//    into three [E/G, .] streams in device memory and reads them back
//    (about 2 * H*D + 128 fp32 written and read per edge, per chunk). Here
//    each slot's zd and g rows, sigma and r are read straight through the
//    slot's destination id, so the chunked backward holds no edge-space
//    buffer at all;
//  - one warp per virtual source row; the row's zs is read once and held in
//    registers; lane t holds features t, t+32, ..., so every zd / g read is
//    coalesced, and the next edge's rows are loaded while the current one is
//    processed;
//  - only the row's real slots are visited: in column-major, length-
//    descending slices, slot (column k, row r) is real iff r < cnt[k], a
//    prefix of the row's columns. Padding slots (whose id is the padded
//    node count) are never read; in the TPU kernel they gather zero rows and
//    add exactly 0. A row without edges writes 0;
//  - each head's two dot products (score and dalpha) are summed by a group
//    of G = 32/H (power of two) lanes over shared memory, then by shuffles,
//    so each edge costs H exponentials, not H*D;
//  - no float atomics: each row is one warp's, so the result is
//    deterministic.
// Faster variants (several rows per warp, TMA) come later.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileN = 128;    // rows per SELL slice
constexpr int kWarps = 8;      // rows per thread block
constexpr int kMaxHd = 512;    // H*D per launch (the op splits heads)
constexpr int kMaxHeads = 32;  // heads per launch: one lane group each
constexpr float kExpClamp = -80.0f;
constexpr unsigned kFull = 0xffffffffu;

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
sell_bwd_src_kernel(const float* __restrict__ zs, const float* __restrict__ zd,
                    const float* __restrict__ g,
                    const float* __restrict__ sigma,
                    const float* __restrict__ rr, const float* __restrict__ a,
                    const int* __restrict__ perm,
                    const int* __restrict__ gather_ids,
                    const int* __restrict__ cnt,
                    const int* __restrict__ col_off, int rows, int heads,
                    int head_dim, float slope, float* __restrict__ dzs) {
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

  const int r = row % kTileN;
  const int c0 = col_off[row / kTileN];
  const int ncols = col_off[row / kTileN + 1] - c0;
  if (ncols > 0 && r < cnt[c0]) {
    float z[NF];  // the row's resident zs
    load_row<NF>(z, zs + (size_t)perm[row] * hd, lane, hd);
    for (int k0 = 0; k0 < ncols; k0 += 32) {
      const int k = k0 + lane;
      const bool real = k < ncols && r < cnt[c0 + k];
      // real slots are a prefix, so the count is the first non-real lane
      const int nb = __popc(__ballot_sync(kFull, real));
      const int my_id = real ? gather_ids[(size_t)(c0 + k) * kTileN + r] : 0;
      int id = __shfl_sync(kFull, my_id, 0);
      float zdn[NF], gn[NF];
      load_row<NF>(zdn, zd + (size_t)id * hd, lane, hd);
      load_row<NF>(gn, g + (size_t)id * hd, lane, hd);
      float sig_n = own_head ? sigma[(size_t)id * heads + h] : 0.f;
      float r_n = own_head ? rr[(size_t)id * heads + h] : 0.f;
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
          sig_n = own_head ? sigma[(size_t)id * heads + h] : 0.f;
          r_n = own_head ? rr[(size_t)id * heads + h] : 0.f;
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
      if (nb < 32) break;
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    if (f < hd) dzs[(size_t)row * hd + f] = acc[j];
  }
}

template <int NF>
int launch(const float* zs, const float* zd, const float* g,
           const float* sigma, const float* rr, const float* a,
           const int* perm, const int* gather_ids, const int* cnt,
           const int* col_off, int rows, int heads, int head_dim, float slope,
           float* dzs, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  sell_bwd_src_kernel<NF><<<blocks, kWarps * 32, 0, stream>>>(
      zs, zd, g, sigma, rr, a, perm, gather_ids, cnt, col_off, rows, heads,
      head_dim, slope, dzs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K4 on `stream` for `rows` virtual source rows of one chunk (a
// multiple of 128). Returns the cudaError_t of the launch (0 on success).
int gatv2_sell_bwd_src(const float* zs, const float* zd, const float* g,
                       const float* sigma, const float* r, const float* a,
                       const int* perm, const int* gather_ids, const int* cnt,
                       const int* col_off, int rows, int heads, int head_dim,
                       float slope, float* dzs, cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || heads <= 0 || heads > kMaxHeads || head_dim <= 0 ||
      hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int nf = (hd + 31) / 32;
  if (nf <= 1)
    return launch<1>(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off,
                     rows, heads, head_dim, slope, dzs, stream);
  if (nf <= 2)
    return launch<2>(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off,
                     rows, heads, head_dim, slope, dzs, stream);
  if (nf <= 4)
    return launch<4>(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off,
                     rows, heads, head_dim, slope, dzs, stream);
  if (nf <= 8)
    return launch<8>(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off,
                     rows, heads, head_dim, slope, dzs, stream);
  return launch<16>(zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off,
                    rows, heads, head_dim, slope, dzs, stream);
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
