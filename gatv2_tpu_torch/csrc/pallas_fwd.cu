// K5 — the streamed-operand GATv2 attention forward over destination-sorted
// edge tiles, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/pallas_attention.py:_attention_kernel
// (launched by _forward_chunk). It computes the same function: for every
// destination node j of a chunk (its 128-node tiles own contiguous,
// tile_e-padded runs of destination-sorted edges), an online softmax over
// j's in-edges e of
//     score = a_h . LeakyReLU(zs[src_e] + zd[j])        (per head h)
// with the reference's exp(clip(score - m, -80, 0)) and +1e-8 denominator,
// writing out[j] = acc / (l + 1e-8) and the per-head max m and sum-exp l
// (the backward's residuals). A node without an in-edge gets out = 0,
// m = -1e30, l = 0, as the TPU kernel's one-hot reductions leave it.
//
// What bounds it on this card: memory. Each real edge reads one zs row of
// H*D fp32 (1 KB at H*D = 256) and two 4-byte ids, and does about a dozen
// fp32 operations per element, below the card's fp32 rate per byte.
//
// What this simple design does about it:
//  - the TPU kernel streams zs and zd PRE-GATHERED per edge ([E, H*D] each,
//    written by XLA gathers and read back) and reduces per destination with
//    one-hot (dst == node) matmuls on its MXU. Here one warp owns one
//    destination row: it finds the row's edge range by binary search over
//    the tile's sorted destination ids (between rel_off[t] * te and
//    rel_off[t+1] * te; padding ids exceed every row, so they sort last),
//    reads zd[j] once and each zs[src_e] straight through the source ids.
//    No per-edge copy is written, and padding edges are never visited;
//  - lane t holds features t, t+32, ..., so every row read is coalesced
//    (128 bytes per warp instruction), and the next edge's row is loaded
//    while the current one is processed; 32 source ids are loaded at once,
//    one per lane, then broadcast by shuffle;
//  - each head's score is summed by a group of G = 32/H (power of two)
//    lanes over shared memory, then by shuffles; the group's first lane
//    keeps the head's running max and sum-exp and broadcasts the rescale
//    factors, so each edge costs 2H exponentials, not 2HD.
// Faster variants (several rows in flight per warp, TMA) come later.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileN = 128;    // destination nodes per tile
constexpr int kWarps = 8;      // rows per thread block
constexpr int kMaxHd = 512;    // H*D per launch (the op splits heads)
constexpr int kMaxHeads = 16;  // heads per launch (the op's STATS_L)
constexpr float kNegInf = -1e30f;
constexpr float kExpClamp = -80.0f;
constexpr float kSoftmaxEps = 1e-8f;
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
pallas_fwd_kernel(const float* __restrict__ zs, const float* __restrict__ zd,
                  const float* __restrict__ a,
                  const int* __restrict__ dst_ids,
                  const int* __restrict__ src_ids,
                  const int* __restrict__ rel_off, int te, int rows,
                  int heads, int head_dim, float slope,
                  float* __restrict__ out, float* __restrict__ m_out,
                  float* __restrict__ l_out) {
  __shared__ float part[kWarps][32 * NF];  // a_f * LeakyReLU(s_f)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // warp-uniform; the kernel syncs warps only
  const int hd = heads * head_dim;
  const int tile = row / kTileN;
  const int t_hi = rel_off[tile + 1] * te;
  const int e_lo = lower_bound(dst_ids, rel_off[tile] * te, t_hi, row);
  const int e_hi = lower_bound(dst_ids, e_lo, t_hi, row + 1);
  // lane groups: G lanes sum head h = lane / G; lane h * G owns its stats
  int group = 1;
  while (group * 2 * heads <= 32) group *= 2;
  const int h = lane / group;
  const int g = lane % group;
  const bool owner = g == 0 && h < heads;

  int src_lane[NF];  // the lane owning the head of each of this lane's features
  float acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    src_lane[j] = f < hd ? (f / head_dim) * group : 0;
    acc[j] = 0.f;
  }
  float mh = kNegInf, lh = 0.f;  // the head's stats, on owner lanes

  if (e_hi > e_lo) {
    float zdv[NF], av[NF];
    const float* zd_row = zd + (size_t)row * hd;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = lane + 32 * j;
      zdv[j] = f < hd ? zd_row[f] : 0.f;
      av[j] = f < hd ? a[f] : 0.f;
    }
    float* pw = part[warp];
    for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
      const int nb = min(32, e_hi - e0);
      const int my_id = lane < nb ? src_ids[e0 + lane] : 0;
      float zn[NF];
      load_row<NF>(zn, zs + (size_t)__shfl_sync(kFull, my_id, 0) * hd, lane,
                   hd);
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
            pw[f] = av[j] * (s > 0.f ? s : slope * s);
          }
        }
        __syncwarp();
        float sc = 0.f;
        if (h < heads)
          for (int d = g; d < head_dim; d += group) sc += pw[h * head_dim + d];
        for (int o = group / 2; o > 0; o >>= 1)
          sc += __shfl_xor_sync(kFull, sc, o);
        __syncwarp();  // every read of pw is done before the next edge
        float c = 1.f, p = 0.f;
        if (owner) {
          const float new_m = fmaxf(mh, sc);
          c = expf(mh - new_m);
          p = expf(fminf(fmaxf(sc - new_m, kExpClamp), 0.f));
          lh = c * lh + p;
          mh = new_m;
        }
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const float cj = __shfl_sync(kFull, c, src_lane[j]);
          const float pj = __shfl_sync(kFull, p, src_lane[j]);
          acc[j] = cj * acc[j] + pj * z[j];
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    const float lj = __shfl_sync(kFull, lh, src_lane[j]);
    if (f < hd) out[(size_t)row * hd + f] = acc[j] / (lj + kSoftmaxEps);
  }
  if (owner) {
    m_out[(size_t)row * heads + h] = mh;
    l_out[(size_t)row * heads + h] = lh;
  }
}

template <int NF>
int launch(const float* zs, const float* zd, const float* a,
           const int* dst_ids, const int* src_ids, const int* rel_off, int te,
           int rows, int heads, int head_dim, float slope, float* out,
           float* m, float* l, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  pallas_fwd_kernel<NF><<<blocks, kWarps * 32, 0, stream>>>(
      zs, zd, a, dst_ids, src_ids, rel_off, te, rows, heads, head_dim, slope,
      out, m, l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5 on `stream` for the `rows` destination rows of one chunk (a
// multiple of 128; zd points at the chunk's first row). Returns the
// cudaError_t of the launch (0 on success).
int gatv2_pallas_fwd(const float* zs, const float* zd, const float* a,
                     const int* dst_ids, const int* src_ids,
                     const int* rel_off, int te, int rows, int heads,
                     int head_dim, float slope, float* out, float* m,
                     float* l, cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || te <= 0 || heads <= 0 || heads > kMaxHeads ||
      head_dim <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int nf = (hd + 31) / 32;
  if (nf <= 1)
    return launch<1>(zs, zd, a, dst_ids, src_ids, rel_off, te, rows, heads,
                     head_dim, slope, out, m, l, stream);
  if (nf <= 2)
    return launch<2>(zs, zd, a, dst_ids, src_ids, rel_off, te, rows, heads,
                     head_dim, slope, out, m, l, stream);
  if (nf <= 4)
    return launch<4>(zs, zd, a, dst_ids, src_ids, rel_off, te, rows, heads,
                     head_dim, slope, out, m, l, stream);
  if (nf <= 8)
    return launch<8>(zs, zd, a, dst_ids, src_ids, rel_off, te, rows, heads,
                     head_dim, slope, out, m, l, stream);
  return launch<16>(zs, zd, a, dst_ids, src_ids, rel_off, te, rows, heads,
                    head_dim, slope, out, m, l, stream);
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
