// K4 — the SELL-128 GATv2 attention backward, phase 2b (source rows of a
// chunked layout): d_zs by per-edge recompute, or with edge features from
// K2's compact packets, for NVIDIA Hopper (sm_90a).
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
// destination side instead of read from a packet buffer. A row's slots are
// summed in column order, as the TPU kernel does, so the output is the same
// from run to run (no atomics).
//
// What bounds it on this card: memory, and on a random graph not the
// kernel's byte bound (each destination row read once) but the per-edge
// gather floor: the zd and g tables (2.5 GB at H*D = 128 on products-full)
// are far larger than the 50 MB L2 and a random graph's destinations have
// no locality, so each real edge reads one zd row, one g row, sigma, r and
// its id from device memory (4 * (2*H*D + 2*H + 1) bytes), plus the rows'
// zs reads and dzs writes. Every edge's gathers are independent, so what
// the design has to do is keep enough of them in flight.
//
// The design (a first version gave one warp to each row, loaded one edge
// ahead with 4-byte loads and summed heads over shared memory: 5.51 / 2.29
// / 2.29 ms at H*D = 128 / 32 / 16 on the same chunk):
//  - lane groups sized to the width (lane_groups.cuh): a row gets
//    ceil(H*D/4) lanes rounded to a power of two (4 lanes at H*D = 16, 8 at
//    32, 32 at 128), so a warp works on 32 / LG rows at once and no lane
//    idles at the narrow widths; every row read is 16-byte vectors; the
//    score and dalpha head sums are the lane's own sums plus
//    __shfl_xor_sync rounds inside the head's lanes, and every lane of a
//    head computes alpha and de itself: no shared memory, no __syncwarp and
//    no broadcast per edge;
//  - a register ring of R = kRing<F> slots (4 at H*D <= 128): a group
//    issues the id, zd, g, sigma and r loads of R slots before it computes
//    the first of them, and loads the next R ids before it computes, so R
//    gathers per row (R * 32 / LG per warp) are in flight; the register
//    budget is cut so that 3 blocks (24 warps) share an SM, which measured
//    faster than deeper rings at lower occupancy;
//  - the zd and g rows are read with evict-first loads: they stream through
//    L2 once, and the tables that are read again (sigma and r, 20-40 MB on
//    products-full; the slot ids a slice's rows share; zs) stay there;
//  - a row's real slots are a prefix of its slice's columns (column-major,
//    length-descending: slot (k, r) is real iff r < cnt[k]), so the row's
//    slot count is one binary search over the slice's cnt, which the slice's
//    128 rows share in L1. Padding slots are never read; a row without
//    edges writes 0.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W): 5.154 / 1.333 / 0.930 ms at
// H*D = 128 / 32 / 16 on products-full chunk 0 (chip_smoke.py; per-edge
// gather floor 4.005 / 1.027 / 0.536 ms), where a bare gather of the same
// rows in the same order takes 4.58 / 1.17 / 0.84 ms on a synthetic chunk
// of that shape (tools/torch_kernel_variants.py): the kernel is within
// 1.10-1.14x of what the memory system delivers for its access pattern.
//
// With edge features the rebuild would also read each edge's features and
// W_e from shared memory: the variant that did (a ring of two slots
// sharing each W_e read, as K1) took 169 ms a layer on ogbn-proteins
// (79.1 M edges, H*D = 480) at one block of 251 registers an SM. So there
// K2 writes each edge's compact packet (alpha and de per head, the
// pre-activation's sign bits; sell_bwd_dst.cu) and the compact variant
// (PK, below) reads it instead:
//     dzs[j] += alpha * g[dst] + de * a_h * (sign ? 1 : slope)
// from one g row and one packet an edge, found through ell_perm (the
// slot's packet index), with no zs, zd, sigma, r, features or W_e. alpha
// and de are K2's own numbers, which the rebuild gave to the bit (the same
// sums in the same order), and each row's sum keeps the column order.

#include <cuda_runtime.h>

#include <cstddef>

#include "lane_groups.cuh"

namespace {

using namespace lane_groups;

constexpr int kTileN = 128;    // rows per SELL slice
constexpr int kBlock = 256;    // threads per block
constexpr int kMaxHd = 512;    // H*D per launch (the op splits heads)
constexpr int kMaxHeads = 32;  // heads per launch
constexpr float kExpClamp = -80.0f;

// Slots a group keeps in flight (the register ring), and the blocks per SM
// the register budget is cut for, by F = floats per lane. At F = 4
// (H*D = 128 / 32 / 16) tools/torch_kernel_variants.py measured 4 slots at
// 3 blocks (80 registers, 24 warps an SM) at 5.16 / 1.33 / 0.93 ms, 8
// slots with no register cut (1-2 blocks) at 9.04 / 2.39 / 1.32 ms, 8 at 2
// blocks at 5.59 / 1.47 / 0.95 ms and 2 at 4 blocks at 5.13 / 1.32 / 0.93
// ms (NVIDIA H100 80GB HBM3, 700.00 W).
template <int F>
constexpr int kRing = F <= 4 ? 4 : F <= 8 ? 2 : 1;
template <int F>
constexpr int kMinBlocks = F <= 8 ? 3 : F <= 16 ? 2 : 1;
// The compact variant's ring and register budget: a slot holds one g row,
// its packet's alpha, de and sign word, and the next slot's ids. On one
// chunk's worth of the ogbn-proteins cell's source rows
// (tools/torch_kernel_variants.py k4e; NVIDIA H100 80GB HBM3, 700.00 W)
// ring 2 at 2 blocks took 2.69 ms (128 registers) against 9.40 for the
// rebuild and 2.51 for a bare gather of one g row a slot; ring 4 at 1 block
// 2.75; ring 1 at 3 blocks, ring 3 at 2 and ring 2 at 3 spilled (2.72,
// 3.17, 5.02 ms). In the cell K4 went from 168 to 49 ms a layer. Lanes of
// more than 24 floats keep the ring at one block an SM, where 2 spilled.
constexpr int kRingCompact = 2;
template <int F>
constexpr int kMinBlocksCompact = F <= 24 ? 2 : 1;

// PK: the compact variant, which reads each real slot's compact packet
// (compact, pk_words words a slot, sell_bwd_dst.cu) at the index ell_perm
// gives the slot (ell_perm in the slot order of gather_ids), and reads
// neither zs, zd, sigma, r nor perm. Without PK the kernel is the one
// measured above.
template <int VEC, int NV, bool PK>
__global__ void __launch_bounds__(kBlock, PK ? kMinBlocksCompact<NV * VEC>
                                             : kMinBlocks<NV * VEC>)
sell_bwd_src_kernel(const float* __restrict__ zs, const float* __restrict__ zd,
                    const float* __restrict__ g,
                    const float* __restrict__ sigma,
                    const float* __restrict__ rr, const float* __restrict__ a,
                    const int* __restrict__ perm,
                    const int* __restrict__ gather_ids,
                    const int* __restrict__ cnt,
                    const int* __restrict__ col_off, int rows, int heads,
                    int head_dim, int lg, int lph, int qph, float slope,
                    const unsigned* __restrict__ compact,
                    const int* __restrict__ ell_perm, int pk_words,
                    float* __restrict__ dzs) {
  constexpr int F = NV * VEC;
  constexpr int R = PK ? kRingCompact : kRing<F>;
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / lg;
  const int row = ((blockIdx.x * kBlock + threadIdx.x) >> 5) * rows_per_warp +
                  lane / lg;
  if (row >= rows) return;  // group-uniform; the kernel syncs groups only
  const int hd = heads * head_dim;
  const int gl = lane & (lg - 1);
  const unsigned mask = group_mask(lane, lg);
  const int h = gl / lph;
  const bool own_head = h < heads;
  Lane<VEC, NV> ln;
  ln.init(gl, lph, qph, heads, head_dim);

  // the row's real slots: the first `deg` columns of its slice
  const int r = row % kTileN;
  const int c0 = col_off[row / kTileN];
  const int deg = sell_row_slots(cnt, c0, col_off[row / kTileN + 1] - c0, r);

  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  if constexpr (PK) {
    if (deg > 0) {
      float av[F];
      ln.load(av, a);
      const int* ids = gather_ids + (size_t)c0 * kTileN + r;  // column k
      const int* pks = ell_perm + (size_t)c0 * kTileN + r;
      int id[R], pi[R];  // the next R slots' dst ids and packet indices
#pragma unroll
      for (int i = 0; i < R; ++i) {
        id[i] = i < deg ? __ldg(ids + i * kTileN) : 0;
        pi[i] = i < deg ? __ldg(pks + i * kTileN) : 0;
      }
      for (int k0 = 0; k0 < deg; k0 += R) {
        float gv[R][F], al[R], de[R];
        unsigned sg[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const bool real = k0 + i < deg;
          if (real) ln.load(gv[i], g + (size_t)id[i] * hd, true);
          const unsigned* p = compact + (size_t)pi[i] * pk_words;
          const float2 t =
              real && own_head ? __ldg(reinterpret_cast<const float2*>(p) + h)
                               : make_float2(0.f, 0.f);
          al[i] = t.x;
          de[i] = t.y;
          sg[i] = real && own_head ? __ldg(p + 2 * heads + gl) : 0u;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int k = k0 + R + i;
          id[i] = k < deg ? __ldg(ids + (size_t)k * kTileN) : 0;
          pi[i] = k < deg ? __ldg(pks + (size_t)k * kTileN) : 0;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (k0 + i >= deg) break;  // group-uniform
#pragma unroll
          for (int f = 0; f < F; ++f)
            acc[f] += al[i] * gv[i][f] +
                      de[i] * av[f] * ((sg[i] >> f) & 1u ? 1.f : slope);
        }
      }
    }
  } else if (deg > 0) {
    float z[F], av[F];  // the row's resident zs, and a
    ln.load(z, zs + (size_t)perm[row] * hd);
    ln.load(av, a);
    const int* ids = gather_ids + (size_t)c0 * kTileN + r;  // column k: k*128
    int id[R];
#pragma unroll
    for (int i = 0; i < R; ++i) id[i] = i < deg ? __ldg(ids + i * kTileN) : 0;
    for (int k0 = 0; k0 < deg; k0 += R) {
      float zdv[R][F], gv[R][F], sg[R], rv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool real = k0 + i < deg;
        const size_t base = (size_t)id[i] * hd;
        if (real) {
          ln.load(zdv[i], zd + base, true);  // read once: evict-first
          ln.load(gv[i], g + base, true);
        }
        sg[i] = real && own_head ? __ldg(sigma + (size_t)id[i] * heads + h)
                                 : 0.f;
        rv[i] = real && own_head ? __ldg(rr + (size_t)id[i] * heads + h)
                                 : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int k = k0 + R + i;
        id[i] = k < deg ? __ldg(ids + (size_t)k * kTileN) : 0;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (k0 + i >= deg) break;  // group-uniform
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
  ln.store(dzs + (size_t)row * hd, acc);
}

}  // namespace

extern "C" {

// Launches K4 on `stream` for `rows` virtual source rows of one chunk (a
// multiple of 128). Returns the cudaError_t of the launch (0 on success).
// compact / ell_perm: the compact variant (compact: K2's packets of the
// layer, compact_words(H, LPH) words a slot; ell_perm [slots] in
// gather_ids' order: each slot's packet index), which reads neither zs,
// zd, sigma, r nor perm; null for the plain kernel.
int gatv2_sell_bwd_src(const float* zs, const float* zd, const float* g,
                       const float* sigma, const float* r, const float* a,
                       const int* perm, const int* gather_ids, const int* cnt,
                       const int* col_off, int rows, int heads, int head_dim,
                       float slope, const unsigned* compact,
                       const int* ell_perm, float* dzs, cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || heads <= 0 || heads > kMaxHeads || head_dim <= 0 ||
      hd > kMaxHd || (compact != nullptr) != (ell_perm != nullptr))
    return (int)cudaErrorInvalidValue;
  const Geometry geo =
      geometry(heads, head_dim,
               aligned16(g) && aligned16(a) && aligned16(dzs) &&
                   (compact != nullptr || (aligned16(zs) && aligned16(zd))));
  const int rows_per_block = kBlock / 32 * (32 / geo.lg);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (compact == nullptr)
    return dispatch(geo, [&](auto vec, auto nv) {
      sell_bwd_src_kernel<decltype(vec)::value, decltype(nv)::value, false>
          <<<blocks, kBlock, 0, stream>>>(
              zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, rows,
              heads, head_dim, geo.lg, geo.lph, geo.qph, slope, nullptr,
              nullptr, 0, dzs);
      return (int)cudaGetLastError();
    });
  if (!compact_geometry(geo, head_dim)) return (int)cudaErrorInvalidValue;
  return dispatch_edge(geo, [&](auto vec, auto nv) {
    sell_bwd_src_kernel<decltype(vec)::value, decltype(nv)::value, true>
        <<<blocks, kBlock, 0, stream>>>(
            zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, rows,
            heads, head_dim, geo.lg, geo.lph, geo.qph, slope, compact,
            ell_perm, compact_words(heads, geo.lph), dzs);
    return (int)cudaGetLastError();
  });
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
