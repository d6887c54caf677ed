// K1 — the SELL-128 GATv2 attention forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/sell_attention.py:_sell_fwd_kernel
// (launched by _sell_forward). It computes the same function: for every
// virtual row of the degree-sorted SELL-128 layout, an online softmax over
// the row's edges of
//     score = a_h . LeakyReLU(zs[src] + zd[dst])        (per head h)
// accumulating acc = sum exp(score - m) * zs[src], with the reference's
// exp(clip(score - m, -80, 0)) and +1e-8 denominator. It writes, per row,
// out = acc / (l + 1e-8) (normalize) or the raw acc (!normalize, for the
// virtual-row merge), and the compact per-head max m and sum-exp l.
//
// What bounds it on this card: memory. Each real edge reads one zs row of
// H*D fp32 (1 KB at H*D = 256) and a 4-byte gather id and does about a
// dozen fp32 operations per element, below the card's fp32 rate per byte.
//
// What this simple design does about it:
//  - zs rows are read straight through gather_ids, and each row's zd once
//    through perm: no pre-gathered [e_ell, H*D] stream is written to and
//    read back from device memory, as the TPU path does;
//  - one warp per virtual row; lane t holds features t, t+32, ..., so every
//    row read is coalesced (128 bytes per warp instruction), and the next
//    edge's row is loaded while the current one is processed;
//  - only the row's real slots are read. Slices are length-descending, so
//    slot (column k, row r) is real iff r < cnt[k]: a prefix of the row's
//    columns. In the masked reference a padding slot leaves a row with
//    edges unchanged (its exp(-80) term is below the ulp of l >= 1), and a
//    row with no edge ends with m = -1e30 and l = the slice's column count,
//    which is written directly;
//  - 32 gather ids are loaded at once, one per lane, then broadcast by
//    shuffle;
//  - each head's score is summed by a group of G = 32/H (power of two)
//    lanes over shared memory, then by shuffles; the group's first lane
//    keeps the head's running max and sum-exp and broadcasts the rescale
//    factors, so each edge costs 2H exponentials, not 2HD.
// Faster variants (several rows in flight per warp, TMA) come later.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileN = 128;    // rows per SELL slice
constexpr int kWarps = 8;      // rows per thread block
constexpr int kMaxHd = 512;    // H*D per launch (the wrapper splits heads)
constexpr int kMaxHeads = 32;  // heads per launch: one lane group each
constexpr float kNegInf = -1e30f;
constexpr float kExpClamp = -80.0f;
constexpr float kSoftmaxEps = 1e-8f;
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
sell_fwd_kernel(const float* __restrict__ zs, const float* __restrict__ zd,
                const float* __restrict__ a, const int* __restrict__ perm,
                const int* __restrict__ gather_ids,
                const int* __restrict__ cnt, const int* __restrict__ col_off,
                int rows, int heads, int head_dim, float slope, int normalize,
                float* __restrict__ out, float* __restrict__ m_out,
                float* __restrict__ l_out) {
  __shared__ float part[kWarps][32 * NF];  // a_f * LeakyReLU(s_f)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // warp-uniform; the kernel syncs warps only
  const int hd = heads * head_dim;
  const int r = row % kTileN;
  const int c0 = col_off[row / kTileN];
  const int ncols = col_off[row / kTileN + 1] - c0;
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

  if (ncols > 0 && r < cnt[c0]) {
    float zdv[NF], av[NF];
    const float* zd_row = zd + (size_t)perm[row] * hd;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int f = lane + 32 * j;
      zdv[j] = f < hd ? zd_row[f] : 0.f;
      av[j] = f < hd ? a[f] : 0.f;
    }
    float* pw = part[warp];
    for (int k0 = 0; k0 < ncols; k0 += 32) {
      const int k = k0 + lane;
      const bool real = k < ncols && r < cnt[c0 + k];
      // real slots are a prefix, so the count is the first non-real lane
      const int nb = __popc(__ballot_sync(kFull, real));
      const int my_id =
          real ? gather_ids[(size_t)(c0 + k) * kTileN + r] : 0;
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
      if (nb < 32) break;
    }
  } else if (owner) {
    // no real edge: each padding column adds exp(0) = 1 to l, m stays -1e30
    lh = (float)ncols;
  }

#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    const float lj = __shfl_sync(kFull, lh, src_lane[j]);
    if (f < hd)
      out[(size_t)row * hd + f] =
          normalize ? acc[j] / (lj + kSoftmaxEps) : acc[j];
  }
  if (owner) {
    m_out[(size_t)row * heads + h] = mh;
    l_out[(size_t)row * heads + h] = lh;
  }
}

template <int NF>
int launch(const float* zs, const float* zd, const float* a, const int* perm,
           const int* gather_ids, const int* cnt, const int* col_off,
           int rows, int heads, int head_dim, float slope, int normalize,
           float* out, float* m, float* l, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  sell_fwd_kernel<NF><<<blocks, kWarps * 32, 0, stream>>>(
      zs, zd, a, perm, gather_ids, cnt, col_off, rows, heads, head_dim, slope,
      normalize, out, m, l);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream` for `rows` virtual rows (a multiple of 128).
// Returns the cudaError_t of the launch (0 on success).
int gatv2_sell_fwd(const float* zs, const float* zd, const float* a,
                   const int* perm, const int* gather_ids, const int* cnt,
                   const int* col_off, int rows, int heads, int head_dim,
                   float slope, int normalize, float* out, float* m, float* l,
                   cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || heads <= 0 || heads > kMaxHeads || head_dim <= 0 ||
      hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int nf = (hd + 31) / 32;
  if (nf <= 1)
    return launch<1>(zs, zd, a, perm, gather_ids, cnt, col_off, rows, heads,
                     head_dim, slope, normalize, out, m, l, stream);
  if (nf <= 2)
    return launch<2>(zs, zd, a, perm, gather_ids, cnt, col_off, rows, heads,
                     head_dim, slope, normalize, out, m, l, stream);
  if (nf <= 4)
    return launch<4>(zs, zd, a, perm, gather_ids, cnt, col_off, rows, heads,
                     head_dim, slope, normalize, out, m, l, stream);
  if (nf <= 8)
    return launch<8>(zs, zd, a, perm, gather_ids, cnt, col_off, rows, heads,
                     head_dim, slope, normalize, out, m, l, stream);
  return launch<16>(zs, zd, a, perm, gather_ids, cnt, col_off, rows, heads,
                    head_dim, slope, normalize, out, m, l, stream);
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
