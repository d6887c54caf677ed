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
// m = -1e30, l = 0, as the TPU kernel's one-hot reductions leave it. With
// normalize = 0 (the TPU kernel's normalize=False, for the multi-pass
// softmax merge of edge_attention_pallas_merge) out is the raw accumulator
// acc = sum exp(score - m) zs[src]; m and l are unchanged, and a hub row's
// parts are merged before the division is skipped.
//
// What bounds it on this card: memory. Each real edge reads one zs row of
// H*D fp32 (1 KB at H*D = 256) and two 4-byte ids, and does about a dozen
// fp32 operations per element, below the card's fp32 rate per byte. The
// kernel's byte bound already reads about one zs row per edge (a sampled
// batch's sources repeat little), so the per-edge gather floor is close to
// it; what the design has to do is keep enough gathers in flight and spend
// nothing on rows without edges.
//
// The design (a first version gave one warp to each row, found its range by
// two binary searches in device memory and loaded one edge ahead with
// 4-byte loads, summing heads over shared memory: 1.05 / 0.29 / 0.29 ms at
// H*D = 256 / 32 / 16 on the same batches):
//  - one block of 128 threads per 128-node tile. The block reads the
//    tile's sorted destination ids once, coalesced, and derives every row's
//    [start, end) from adjacent differences into shared memory (padding ids
//    name no row of the tile and are skipped); the layout is unchanged;
//  - lane groups sized to the width (lane_groups.cuh): ceil(H*D/4) lanes a
//    row, rounded to a power of two, 16-byte loads, head sums by
//    __shfl_xor_sync inside the head's lanes; every lane of a head keeps
//    the head's running max and sum-exp itself, so no broadcast per edge.
//    The block's groups take the tile's rows in turn; a row without edges
//    costs one store of 0, -1e30, 0;
//  - a register ring of R = kRing<F> edges (4 at H*D <= 256): a group
//    loads R source rows (and the next R source ids) before it computes
//    the first, takes the batch's max once and rescales once per batch
//    (R + 1 exponentials per head for R edges); the register budget is
//    cut so that 8 blocks (H*D <= 32) or 4 (H*D = 256) share an SM, since a
//    block's phases (ids, ranges, rows) are a chain of dependent loads that
//    only other blocks can overlap;
//  - a row of more than kHub edges (a power-law hub) is split over all the
//    block's groups in equal contiguous parts after the other rows (a tile
//    without one skips that pass); each part's (m, l, acc) goes to shared
//    memory and the block's first group merges them in part order, so the
//    result does not depend on timing.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's times on a
// products-sub batch are in PERF.md): on a synthetic batch of that shape
// the kernel takes 0.644 / 0.122 / 0.078 ms at H*D = 256 / 32 / 16, and a
// bare gather of one zs row per edge 0.324 / 0.044 / 0.027 ms
// (tools/torch_kernel_variants.py): about half of the kernel's time at
// H*D = 256, and a third or less at 32 and 16, is the gather itself; the
// rest is each tile's chain of dependent steps (its edge
// range, then per row the zd row, the ids, the zs rows), which only other
// resident blocks overlap.

#include <cuda_runtime.h>

#include <cstddef>

#include "lane_groups.cuh"

namespace {

using namespace lane_groups;

constexpr int kTileN = 128;    // destination nodes per tile
constexpr int kBlock = 128;    // threads per block: one block per tile
constexpr int kMaxHd = 512;    // H*D per launch (the op splits heads)
constexpr int kMaxHeads = 16;  // heads per launch (the op's STATS_L)
constexpr int kHub = 256;      // longer rows are split over the block
constexpr float kNegInf = -1e30f;
constexpr float kExpClamp = -80.0f;
constexpr float kSoftmaxEps = 1e-8f;

// Edges a group keeps in flight (the register ring), and the blocks per SM
// the register budget is cut for, by F = floats per lane. On a sampled
// batch's layout tools/torch_kernel_variants.py measured 128-thread blocks
// with 4 edges at 8 blocks (F = 4, H*D = 32 / 16) and at 4 blocks (F = 8,
// H*D = 256) at 0.644 / 0.122 / 0.078 ms (H*D = 256 / 32 / 16), 256-thread
// blocks with 8 (F = 4) or 4 edges at 2 blocks at 0.643 / 0.144 / 0.092 ms
// and 2 edges at 10 blocks at 0.922 / 0.125 / 0.077 ms (NVIDIA H100 80GB
// HBM3, 700.00 W).
template <int F>
constexpr int kRing = F <= 8 ? 4 : F <= 16 ? 2 : 1;
template <int F>
constexpr int kMinBlocks = F <= 4 ? 8 : F <= 8 ? 4 : F <= 16 ? 3 : 1;

// The online softmax of one destination row over its edges [lo, hi): this
// lane's head's running max m and sum-exp l and its features' acc.
template <int VEC, int NV>
__device__ __forceinline__ void row_softmax(
    const Lane<VEC, NV>& ln, const float* __restrict__ zs,
    const int* __restrict__ src_ids, const float (&zdv)[NV * VEC],
    const float (&av)[NV * VEC], int lo, int hi, int hd, int lph,
    unsigned mask, float slope, float& m, float& l, float (&acc)[NV * VEC]) {
  constexpr int F = NV * VEC;
  constexpr int R = kRing<F>;
  m = kNegInf;
  l = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  int id[R];  // the batch's source ids, loaded one batch ahead
#pragma unroll
  for (int i = 0; i < R; ++i)
    id[i] = lo + i < hi ? __ldg(src_ids + lo + i) : 0;
  for (int e0 = lo; e0 < hi; e0 += R) {
    float z[R][F];
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (e0 + i < hi) ln.load(z[i], zs + (size_t)id[i] * hd);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = e0 + R + i;
      id[i] = e < hi ? __ldg(src_ids + e) : 0;
    }
    float sc[R];
    float bm = m;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (e0 + i >= hi) break;  // group-uniform
      float s_h = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float s = z[i][f] + zdv[f];
        s_h += av[f] * (s > 0.f ? s : slope * s);
      }
      sc[i] = head_sum(s_h, lph, mask);
      bm = fmaxf(bm, sc[i]);
    }
    const float c = expf(m - bm);
    l *= c;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] *= c;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (e0 + i >= hi) break;
      const float p = expf(fminf(fmaxf(sc[i] - bm, kExpClamp), 0.f));
      l += p;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] += p * z[i][f];
    }
    m = bm;
  }
}

template <int VEC, int NV>
__device__ __forceinline__ void store_row(const Lane<VEC, NV>& ln, int row,
                                          int hd, int heads, int h, int sub,
                                          bool normalize, float m, float l,
                                          float (&acc)[NV * VEC],
                                          float* __restrict__ out,
                                          float* __restrict__ m_out,
                                          float* __restrict__ l_out) {
  if (normalize) {
    const float inv = 1.f / (l + kSoftmaxEps);
#pragma unroll
    for (int f = 0; f < NV * VEC; ++f) acc[f] *= inv;
  }
  ln.store(out + (size_t)row * hd, acc);
  if (sub == 0 && h < heads) {
    m_out[(size_t)row * heads + h] = m;
    l_out[(size_t)row * heads + h] = l;
  }
}

template <int VEC, int NV>
__global__ void __launch_bounds__(kBlock, kMinBlocks<NV * VEC>)
pallas_fwd_kernel(const float* __restrict__ zs, const float* __restrict__ zd,
                  const float* __restrict__ a,
                  const int* __restrict__ dst_ids,
                  const int* __restrict__ src_ids,
                  const int* __restrict__ rel_off, int te, int heads,
                  int head_dim, int lg, int lph, int qph, float slope,
                  bool normalize, float* __restrict__ out,
                  float* __restrict__ m_out,
                  float* __restrict__ l_out) {
  constexpr int F = NV * VEC;
  __shared__ int s_lo[kTileN], s_hi[kTileN];
  __shared__ float s_m[kBlock], s_l[kBlock];  // a hub's per-part stats
  __shared__ float s_acc[F][kBlock];          // and features
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kTileN;
  const int t_lo = rel_off[blockIdx.x] * te;
  const int t_hi = rel_off[blockIdx.x + 1] * te;
  for (int i = tid; i < kTileN; i += kBlock) s_lo[i] = s_hi[i] = 0;
  __syncthreads();
  // each row's edge range from adjacent differences of the sorted ids
  for (int p = t_lo + tid; p < t_hi; p += kBlock) {
    const int d = __ldg(dst_ids + p);
    if (d < base || d >= base + kTileN) continue;  // padding
    if (p == t_lo || __ldg(dst_ids + p - 1) != d) s_lo[d - base] = p;
    if (p + 1 == t_hi || __ldg(dst_ids + p + 1) != d) s_hi[d - base] = p + 1;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int hd = heads * head_dim;
  const int gl = lane & (lg - 1);
  const unsigned mask = group_mask(lane, lg);
  const int h = gl / lph, sub = gl % lph;
  const int groups = kBlock / lg;
  const int grp = tid / lg;  // this lane's group in the block
  Lane<VEC, NV> ln;
  ln.init(gl, lph, qph, heads, head_dim);
  float av[F], zdv[F], acc[F], m, l;
  ln.load(av, a);

  bool hub = false;
  for (int i = grp; i < kTileN; i += groups) {
    const int lo = s_lo[i], hi = s_hi[i];
    if (hi - lo > kHub) {  // group-uniform; split below
      hub = true;
      continue;
    }
    if (hi > lo) ln.load(zdv, zd + (size_t)(base + i) * hd);
    row_softmax(ln, zs, src_ids, zdv, av, lo, hi, hd, lph, mask, slope, m, l,
                acc);
    store_row(ln, base + i, hd, heads, h, sub, normalize, m, l, acc, out,
              m_out, l_out);
  }

  if (!__syncthreads_or(hub)) return;  // the tile has no hub row
  for (int i = 0; i < kTileN; ++i) {  // block-uniform
    const int lo = s_lo[i], hi = s_hi[i];
    if (hi - lo <= kHub) continue;
    const int per = (hi - lo + groups - 1) / groups;
    const int p_lo = min(hi, lo + grp * per), p_hi = min(hi, p_lo + per);
    ln.load(zdv, zd + (size_t)(base + i) * hd);
    row_softmax(ln, zs, src_ids, zdv, av, p_lo, p_hi, hd, lph, mask, slope,
                m, l, acc);
    s_m[tid] = m;
    s_l[tid] = l;
#pragma unroll
    for (int f = 0; f < F; ++f) s_acc[f][tid] = acc[f];
    __syncthreads();
    if (grp == 0) {  // merge the parts in order: part q's lane gl is thread
      float mm = kNegInf;  // q * lg + gl
      for (int q = 0; q < groups; ++q) mm = fmaxf(mm, s_m[q * lg + gl]);
      l = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.f;
      for (int q = 0; q < groups; ++q) {
        const int t = q * lg + gl;
        const float c = expf(s_m[t] - mm);
        l += c * s_l[t];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += c * s_acc[f][t];
      }
      store_row(ln, base + i, hd, heads, h, sub, normalize, mm, l, acc, out,
                m_out, l_out);
    }
    __syncthreads();  // the parts are read before the next hub writes them
  }
}

}  // namespace

extern "C" {

// Launches K5 on `stream` for the `rows` destination rows of one chunk (a
// multiple of 128; zd points at the chunk's first row); normalize = 0
// writes the raw accumulator. Returns the cudaError_t of the launch (0 on
// success).
int gatv2_pallas_fwd(const float* zs, const float* zd, const float* a,
                     const int* dst_ids, const int* src_ids,
                     const int* rel_off, int te, int rows, int heads,
                     int head_dim, float slope, int normalize, float* out,
                     float* m, float* l, cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || rows % kTileN != 0 || te <= 0 || heads <= 0 ||
      heads > kMaxHeads || head_dim <= 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(
      heads, head_dim,
      aligned16(zs) && aligned16(zd) && aligned16(a) && aligned16(out));
  return dispatch(geo, [&](auto vec, auto nv) {
    pallas_fwd_kernel<decltype(vec)::value, decltype(nv)::value>
        <<<rows / kTileN, kBlock, 0, stream>>>(
            zs, zd, a, dst_ids, src_ids, rel_off, te, heads, head_dim, geo.lg,
            geo.lph, geo.qph, slope, normalize != 0, out, m, l);
    return (int)cudaGetLastError();
  });
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
