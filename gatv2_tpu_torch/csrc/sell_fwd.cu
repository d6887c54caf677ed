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
// virtual-row merge), and the compact per-head max m and sum-exp l. A row
// without a real edge writes out = 0, m = -1e30 and l = the slice's column
// count (each masked padding column adds exp(0) = 1 in the reference).
//
// What bounds it on this card: memory, and on a random graph not the
// kernel's byte bound (each zs row read once) but the per-edge gather
// floor: the zs table (1.25 GB at H*D = 128 on products-full) is far
// larger than the 50 MB L2 and a random graph's sources have no locality,
// so each real edge reads one zs row from device memory in 32-byte
// sectors, plus its 4-byte gather id. Every edge's gather is independent,
// so what the design has to do is keep enough of them in flight and spend
// few instructions per edge.
//
// The design (a first version gave one warp to each row, summed heads
// over shared memory and broadcast the softmax factors per edge from an
// owner lane, with one zs row in flight: 3.37 / 1.52 / 1.52 ms at
// H*D = 128 / 32 / 16 on products-full chunk 0, 32.11 ms of a 152.11 ms
// epoch):
//  - lane groups sized to the width (lane_groups.cuh): a row gets
//    ceil(H*D/4) lanes rounded to a power of two (4 lanes at H*D = 16, 8
//    at 32, 32 at 128 and above), so a warp works on 32 / LG consecutive
//    rows of one slice (length-descending, so of similar lengths) and no
//    lane idles at the narrow widths; rows are read as 16-byte vectors
//    when D % 4 == 0 and the tables are aligned, else 4-byte loads;
//  - each head's score is the lane's own sum plus __shfl_xor_sync rounds
//    inside the head's lanes, and every lane of a head keeps the head's
//    running max and sum-exp itself: no shared memory, no __syncwarp and
//    no broadcast per edge;
//  - a register ring of R = kRing<F> edges: a group issues the zs loads of
//    R edges (and the next R gather ids) before it computes the first of
//    them, takes the batch's max once and rescales once per batch (R + 1
//    exponentials per head for R edges); the register budget is cut per
//    width (kMinBlocks) so that enough warps share an SM to cover the
//    gathers' latency. Occupancy won over depth (below): at F = 4 floats a
//    lane, every products-full layer, the ring is one edge deep, with the
//    next edge's id loaded ahead, at 8 blocks (64 warps) an SM;
//  - a row's real slots are a prefix of its slice's columns, so its slot
//    count is one binary search over the slice's cnt (sell_row_slots);
//    padding slots are never read.
// Measured (tools/torch_kernel_variants.py on a synthetic products-full
// dst chunk 0; NVIDIA H100 80GB HBM3, 700.00 W): 2.49 / 0.665 / 0.436 ms at
// H*D = 128 / 32 / 16 and 4.87 ms at 256, where a bare gather of one zs row
// per real slot in the same order takes 2.15 / 0.585 / 0.397 and 4.25 ms:
// the kernel is within 1.10-1.16x of what the memory system delivers for
// its access pattern. A first build of this design (a ring of 4 at 4
// blocks at F = 4, 3 at F = 8) took 3.12 / 0.876 / 0.529 and 5.38 ms; a
// ring of 2 at 6 blocks 2.75 / 0.758 / 0.470; evict-first zs loads
// 2.46 / 0.681 / 0.460 ms (no gain, so zs is read with ordinary loads).
//
// The edge-feature variant (EF, below) adds W_e f to each score's
// pre-activation: 2*k*H*D FLOPs an edge, with W_e [k][H*D] in shared
// memory, where each lane reads its own features' k vectors (40 16-byte
// reads a lane an edge at 6 heads x 80, k = 8). At that width a row's 24
// active lanes of 32 hold 20 floats each (NV = 5, exact) and the kernel
// keeps one block (8 warps) an SM, so it is bound by the latency of its
// gathers and shared-memory reads, not by bandwidth: a ring of two edges,
// sharing each W_e read, took K1 from 183 to 144 ms a layer on ogbn-proteins
// (79.1 M edges, H*D = 480; its gathers alone would take ~45 ms).

#include <cuda_runtime.h>

#include <cstddef>

#include "lane_groups.cuh"

namespace {

using namespace lane_groups;

constexpr int kTileN = 128;    // rows per SELL slice
constexpr int kBlock = 256;    // threads per block
constexpr int kMaxHd = 512;    // H*D per launch (the wrapper splits heads)
constexpr int kMaxHeads = 32;  // heads per launch
constexpr float kNegInf = -1e30f;
constexpr float kExpClamp = -80.0f;
constexpr float kSoftmaxEps = 1e-8f;
// zs rows are read with ordinary loads: a zs row is read by every edge out
// of its node (about 5 times per products-full chunk), and the narrow
// layers' tables (157 MB at H*D = 16) are not far above the L2.
constexpr bool kZsEvictFirst = false;

// Edges a group keeps in flight (the register ring), and the blocks per SM
// the register budget is cut for, by F = floats per lane: at F = 4 one
// edge at 8 blocks (32 registers), at F = 8 two at 4 (64), measured as
// above; wider lanes keep fewer blocks.
template <int F>
constexpr int kRing = F <= 4 ? 1 : F <= 16 ? 2 : 1;
template <int F>
constexpr int kMinBlocks = F <= 4 ? 8 : F <= 8 ? 4 : F <= 16 ? 2 : 1;
// The edge-feature variant's ring: two edges, so that each W_e vector read
// from shared memory serves both, and two gathers are in flight.
constexpr int kRingEdge = 2;

// EF: the edge-feature variant. Each slot's k features (ef, in the slot
// order of gather_ids) enter the score as W_e f, W_e laid out [k][H*D]
// (we) and read once per block into shared memory; every lane builds its
// own features' edge term from the slot's k floats (lane_groups.cuh
// add_edge). Without EF the kernel is the one measured above.
template <int VEC, int NV, bool EF>
__global__ void __launch_bounds__(kBlock, kMinBlocks<NV * VEC>)
sell_fwd_kernel(const float* __restrict__ zs, const float* __restrict__ zd,
                const float* __restrict__ a, const int* __restrict__ perm,
                const int* __restrict__ gather_ids,
                const int* __restrict__ cnt, const int* __restrict__ col_off,
                int rows, int heads, int head_dim, int lg, int lph, int qph,
                float slope, int normalize, const float* __restrict__ ef,
                const float* __restrict__ we, int k_ef,
                float* __restrict__ out, float* __restrict__ m_out,
                float* __restrict__ l_out) {
  constexpr int F = NV * VEC;
  constexpr int R = EF ? kRingEdge : kRing<F>;
  extern __shared__ __align__(16) float s_we[];  // EF: W_e [k][H*D]
  if constexpr (EF) load_edge_weights(s_we, we, k_ef * heads * head_dim);
  const int row = (blockIdx.x * kBlock + threadIdx.x) / lg;
  if (row >= rows) return;  // group-uniform; the kernel syncs groups only
  const int lane = threadIdx.x & 31;
  const int hd = heads * head_dim;
  const int gl = lane & (lg - 1);
  const unsigned mask = group_mask(lane, lg);
  const int h = gl / lph, sub = gl % lph;
  Lane<VEC, NV> ln;
  ln.init(gl, lph, qph, heads, head_dim);

  const int r = row % kTileN;
  const int c0 = col_off[row / kTileN];
  const int ncols = col_off[row / kTileN + 1] - c0;
  const int deg = sell_row_slots(cnt, c0, ncols, r);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  float m = kNegInf, l = 0.f;  // this lane's head's running max and sum-exp
  if (deg > 0) {
    float zdv[F], av[F];
    ln.load(zdv, zd + (size_t)perm[row] * hd);
    ln.load(av, a);
    const int* ids = gather_ids + (size_t)c0 * kTileN + r;  // column k: k*128
    // EF: the slot's features, column k at efs + k*128*k_ef
    const float* efs = EF ? ef + ((size_t)c0 * kTileN + r) * k_ef : nullptr;
    int id[R];  // the batch's source ids, loaded one batch ahead
#pragma unroll
    for (int i = 0; i < R; ++i) id[i] = i < deg ? __ldg(ids + i * kTileN) : 0;
    for (int k0 = 0; k0 < deg; k0 += R) {
      float z[R][F];
      float fe[R][kMaxEdgeDim];
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (k0 + i < deg) {
          ln.load(z[i], zs + (size_t)id[i] * hd, kZsEvictFirst);
          if constexpr (EF)
            load_edge_feats(fe[i], efs + (size_t)(k0 + i) * kTileN * k_ef,
                            k_ef);
        }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int k = k0 + R + i;
        id[i] = k < deg ? __ldg(ids + (size_t)k * kTileN) : 0;
      }
      float sc[R];
      float bm = m;
      float pre[R][F];  // EF: the ring's pre-activations
      if constexpr (EF) {
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int f = 0; f < F; ++f) pre[i][f] = z[i][f] + zdv[f];
        ln.add_edge(pre, s_we, fe, k_ef, hd);  // slots past deg unread
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (k0 + i >= deg) break;  // group-uniform
        float s_h = 0.f;
        if constexpr (EF) {
#pragma unroll
          for (int f = 0; f < F; ++f)
            s_h += av[f] * (pre[i][f] > 0.f ? pre[i][f] : slope * pre[i][f]);
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float s = z[i][f] + zdv[f];
            s_h += av[f] * (s > 0.f ? s : slope * s);
          }
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
        if (k0 + i >= deg) break;
        const float p = expf(fminf(fmaxf(sc[i] - bm, kExpClamp), 0.f));
        l += p;
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += p * z[i][f];
      }
      m = bm;
    }
  } else {
    // no real edge: each padding column adds exp(0) = 1 to l, m stays -1e30
    l = (float)ncols;
  }

  if (normalize) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = acc[f] / (l + kSoftmaxEps);
  }
  ln.store(out + (size_t)row * hd, acc);
  if (sub == 0 && h < heads) {
    m_out[(size_t)row * heads + h] = m;
    l_out[(size_t)row * heads + h] = l;
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` for `rows` virtual rows (a multiple of 128).
// Returns the cudaError_t of the launch (0 on success).
// ef / we / k: the edge-feature variant (ef [slots, k] in gather_ids'
// order, we = W_e as [k][H*D]); null / 0 for the plain kernel.
int gatv2_sell_fwd(const float* zs, const float* zd, const float* a,
                   const int* perm, const int* gather_ids, const int* cnt,
                   const int* col_off, int rows, int heads, int head_dim,
                   float slope, int normalize, const float* ef,
                   const float* we, int k, float* out, float* m, float* l,
                   cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || heads <= 0 || heads > kMaxHeads || head_dim <= 0 ||
      hd > kMaxHd || k < 0 || k > kMaxEdgeDim || (k > 0) != (ef != nullptr))
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(
      heads, head_dim,
      aligned16(zs) && aligned16(zd) && aligned16(a) && aligned16(out));
  const int rows_per_block = kBlock / geo.lg;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (k == 0)
    return dispatch(geo, [&](auto vec, auto nv) {
      sell_fwd_kernel<decltype(vec)::value, decltype(nv)::value, false>
          <<<blocks, kBlock, 0, stream>>>(
              zs, zd, a, perm, gather_ids, cnt, col_off, rows, heads,
              head_dim, geo.lg, geo.lph, geo.qph, slope, normalize, nullptr,
              nullptr, 0, out, m, l);
      return (int)cudaGetLastError();
    });
  const size_t smem = sizeof(float) * (size_t)k * hd;
  return dispatch_edge(geo, [&](auto vec, auto nv) {
    sell_fwd_kernel<decltype(vec)::value, decltype(nv)::value, true>
        <<<blocks, kBlock, smem, stream>>>(
            zs, zd, a, perm, gather_ids, cnt, col_off, rows, heads, head_dim,
            geo.lg, geo.lph, geo.qph, slope, normalize, ef, we, k, out, m, l);
    return (int)cudaGetLastError();
  });
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
