// K2 — the SELL-128 GATv2 attention backward, phase 1 (destination rows),
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gatv2_tpu/ops/sell_attention.py:_sell_bwd_dst_kernel
// (launched by _sell_bwd_dst), with and without emit_c1. It computes the same
// function: for every real edge (column k, row j) of the destination-sorted
// SELL-128 layout, with node n = perm[j] and src = gather_ids[slot],
//     s      = zs[src] + zd[n]
//     s_act  = LeakyReLU(s)
//     sc_h   = <s_act_h, a_h>
//     alpha  = exp(clip(sc_h - sigma[n,h], -80, 0))
//     dalpha = <g[n]_h, zs[src]_h>
//     de     = alpha * (dalpha - r[n,h])
//     ds     = de * a_h * (s > 0 ? 1 : slope)
// and accumulates dzd[j] += ds (per row), d_a += de * s_act, and writes the
// per-edge packet c1[slot] = alpha * g[n] + ds, which K3 (sell_segsum.cu)
// sums per source row into d_zs. On a chunked layout (the TPU kernel's
// emit_c1=False, one launch per chunk of slices) c1 is null and no packet
// is written: K4 (sell_bwd_src.cu) recomputes each edge's packet from the
// source side instead. dzd and d_a are the same numbers either way. Padding
// slots are left unwritten in c1 (K3 skips them by the same count); in the
// masked TPU algebra a padding slot of a row with edges adds exp(-80) * r
// ~ 1e-35 * r, below fp32 resolution, and a row without edges gets exactly
// 0, which is written directly.
//
// What bounds it on this card: memory. Each real edge reads one zs row
// (and, with packets, writes one c1 row) of H*D fp32, against about 15
// fp32 operations per feature, far below the card's fp32 rate per byte. On
// a random graph whose zs table (1.25 GB at H*D = 128 on products-full)
// dwarfs the 50 MB L2, the zs reads are the per-edge gather floor: one row
// per edge in 32-byte sectors, plus the rows' zd, g, sigma, r and dzd.
//
// The design (a first version gave one warp to each row, summed both head
// dot products over shared memory and broadcast alpha and de per edge by
// shuffles, with one zs row in flight: 3.72 / 1.92 / 1.92 ms at
// H*D = 128 / 32 / 16 on products-full chunk 0 without packets, 37.81 ms
// of a 152.11 ms epoch):
//  - lane groups sized to the width (lane_groups.cuh), as in K1: a row gets
//    ceil(H*D/4) lanes rounded to a power of two, so a warp works on 32 / LG
//    consecutive rows of one slice; 16-byte vectors when D % 4 == 0 and the
//    tables are aligned; the row's zd and g vectors and its head's sigma
//    and r are loaded once per row;
//  - the score and dalpha head sums are the lane's own sums plus
//    __shfl_xor_sync rounds inside the head's lanes, and every lane of a
//    head computes alpha and de itself: no shared memory, no __syncwarp and
//    no broadcast per edge; with packets, each edge's c1 row is written by
//    the group's vector stores in slot order;
//  - a rotating register ring of R = kRing<F> zs rows: while a group
//    computes edge k, the loads of edges k+1 .. k+R-1 are in flight and the
//    ids of the next R edges are loaded; the register budget is cut per
//    width (kMinBlocks). Unlike K1 (one edge at a time, 64 warps an SM),
//    K2's longer per-edge chain (two head sums, then alpha, de, dzd and
//    d_a) wants a load in flight during it: a ring of 2 at 4 blocks an SM;
//  - a row's slot count is one binary search over its slice's cnt
//    (sell_row_slots); padding slots are never read;
//  - d_a is deterministic, with no float atomics: each lane sums its own
//    features over the rows its group takes (blocks stride over the rows in
//    a group-uniform loop, so the partials stay few); at the end the warp's
//    groups are added by __shfl_xor_sync over the group-index bits and the
//    block's warps in warp order through shared memory, one partial per
//    block, which the wrapper sums in a fixed order.
// Measured (tools/torch_kernel_variants.py on a synthetic products-full
// dst chunk 0, without packets; NVIDIA H100 80GB HBM3, 700.00 W): 3.22 /
// 0.904 / 0.527 ms at H*D = 128 / 32 / 16 and 5.63 ms at 256, where a bare
// gather of one zs row per real slot takes 2.15 / 0.585 / 0.397 and 4.25
// ms: within 1.33-1.55x of it (K2 also reads each row's zd and g and does
// about twice K1's work per edge). A first build of this design, a batch
// ring (R loads, then R computes) of 4 at 3 blocks, took 4.85 / 1.34 /
// 0.753 ms; one edge at a time at 6 blocks 3.75 / 1.055 / 0.619; a ring of
// 4 at 3 blocks 3.61 / 0.981 / 0.565; evict-first zs loads 3.23 / 0.909 /
// 0.538 ms (no gain at F = 4).
//
// The edge-feature variant (EF, below) rebuilds each score with W_e f as
// K1 does, and sums dW_e per lane group in shared memory (a read and a
// write of 40 16-byte vectors a lane an edge at 6 heads x 80, k = 8): at
// 205 registers and 154 KB of shared memory it keeps one block an SM and
// took 300 ms a layer on ogbn-proteins (79.1 M edges, H*D = 480), the
// largest part of that cell's epoch.

#include <cuda_runtime.h>

#include <cstddef>

#include "lane_groups.cuh"

namespace {

using namespace lane_groups;

constexpr int kTileN = 128;    // rows per SELL slice
constexpr int kBlock = 256;    // threads per block (ops/sell_bwd_dst.py BLOCK)
constexpr int kWarps = kBlock / 32;
constexpr int kMaxHd = 512;    // H*D per launch (the op splits heads)
constexpr int kMaxHeads = 32;  // heads per launch
constexpr float kExpClamp = -80.0f;
// zs rows are read with ordinary loads, as in K1 (sell_fwd.cu).
constexpr bool kZsEvictFirst = false;

// zs rows a group keeps in the ring, and the blocks per SM the register
// budget is cut for, by F = floats per lane: at F = 4 two at 4 blocks (63
// registers), at F = 8 two at 2 (106; 5.63 ms against 5.94 for one at 4
// blocks), measured as above; wider lanes keep one row at 1 block.
template <int F>
constexpr int kRing = F <= 8 ? 2 : 1;
template <int F>
constexpr int kMinBlocks = F <= 4 ? 4 : F <= 8 ? 2 : 1;

// EF: the edge-feature variant. Each slot's k features (ef, in the slot
// order of gather_ids) enter the score as W_e f, W_e laid out [k][H*D]
// (we) and read once per block into shared memory, as in K1; and the
// kernel adds dW_e = sum over the slots of ds (x) f. Each lane group sums
// its own rows' products into a [k][H*D] table of its own in shared
// memory (its lanes own disjoint features: no atomics); at the end the
// block adds its groups' tables in group order and adds the result into
// its row of dwe_part [blocks, k, H*D], so the launches over the chunks of
// a layout accumulate in launch order and the wrapper's one sum over the
// blocks fixes every rounding. Without EF the kernel is the one measured
// above.
template <int VEC, int NV, bool EF>
__global__ void __launch_bounds__(kBlock, kMinBlocks<NV * VEC>)
sell_bwd_dst_kernel(const float* __restrict__ zs, const float* __restrict__ zd,
                    const float* __restrict__ g,
                    const float* __restrict__ sigma,
                    const float* __restrict__ rr, const float* __restrict__ a,
                    const int* __restrict__ perm,
                    const int* __restrict__ gather_ids,
                    const int* __restrict__ cnt,
                    const int* __restrict__ col_off, int rows, int heads,
                    int head_dim, int lg, int lph, int qph, float slope,
                    const float* __restrict__ ef,
                    const float* __restrict__ we, int k_ef,
                    float* __restrict__ dzd, float* __restrict__ da_part,
                    float* __restrict__ c1, float* __restrict__ dwe_part) {
  constexpr int F = NV * VEC;
  constexpr int R = kRing<F>;
  __shared__ float s_da[kWarps][kMaxHd];  // each warp's d_a sums
  // EF: W_e [k][H*D], then one dW_e table [k][H*D] per lane group
  extern __shared__ __align__(16) float s_dyn[];
  const int lane = threadIdx.x & 31;
  const int hd = heads * head_dim;
  const int ehd = k_ef * hd;
  float* s_dwe = s_dyn + ehd + (threadIdx.x / lg) * ehd;  // this group's
  if constexpr (EF) {
    for (int i = threadIdx.x; i < ehd * (kBlock / lg); i += kBlock)
      s_dyn[ehd + i] = 0.f;
    load_edge_weights(s_dyn, we, ehd);
  }
  const int gl = lane & (lg - 1);
  const unsigned mask = group_mask(lane, lg);
  const int h = gl / lph;
  const bool own_head = h < heads;
  Lane<VEC, NV> ln;
  ln.init(gl, lph, qph, heads, head_dim);
  float av[F], da_acc[F];
  ln.load(av, a);
#pragma unroll
  for (int f = 0; f < F; ++f) da_acc[f] = 0.f;
  const bool emit = c1 != nullptr;  // uniform over the launch
  const int rows_per_block = kBlock / lg;

  for (int row = blockIdx.x * rows_per_block + threadIdx.x / lg; row < rows;
       row += gridDim.x * rows_per_block) {  // group-uniform
    const int r = row % kTileN;
    const int c0 = col_off[row / kTileN];
    const int deg =
        sell_row_slots(cnt, c0, col_off[row / kTileN + 1] - c0, r);
    float dacc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) dacc[f] = 0.f;
    if (deg > 0) {
      const int node = perm[row];
      float zdv[F], gv[F];
      ln.load(zdv, zd + (size_t)node * hd);
      ln.load(gv, g + (size_t)node * hd);
      const float sig = own_head ? __ldg(sigma + (size_t)node * heads + h)
                                 : 0.f;
      const float r_h = own_head ? __ldg(rr + (size_t)node * heads + h) : 0.f;
      const int* ids = gather_ids + (size_t)c0 * kTileN + r;  // column k: k*128
      // EF: the slot's features, column k at efs + k*128*k_ef
      const float* efs =
          EF ? ef + ((size_t)c0 * kTileN + r) * k_ef : nullptr;
      // the ring: slot j holds an edge's zs row from its load to its
      // compute, and id[j] the source id of the next edge loaded into it;
      // while edge k is computed, the loads of edges k+1 .. k+R-1 are in
      // flight and the ids of the next R edges are known
      int id[R];
      float z[R][F];
      float fe[R][kMaxEdgeDim];
#pragma unroll
      for (int j = 0; j < R; ++j)
        id[j] = j < deg ? __ldg(ids + j * kTileN) : 0;
#pragma unroll
      for (int j = 0; j + 1 < R; ++j) {
        if (j < deg) {
          ln.load(z[j], zs + (size_t)id[j] * hd, kZsEvictFirst);
          if constexpr (EF)
            load_edge_feats(fe[j], efs + (size_t)j * kTileN * k_ef, k_ef);
        }
        id[j] = j + R < deg ? __ldg(ids + (size_t)(j + R) * kTileN) : 0;
      }
      for (int k0 = 0; k0 < deg; k0 += R) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int k = k0 + i;
          if (k >= deg) break;  // group-uniform
          const int j = (i + R - 1) % R;  // the slot of edge k + R - 1
          if (k + R - 1 < deg) {
            ln.load(z[j], zs + (size_t)id[j] * hd, kZsEvictFirst);
            if constexpr (EF)
              load_edge_feats(fe[j],
                              efs + (size_t)(k + R - 1) * kTileN * k_ef,
                              k_ef);
            const int kn = k + 2 * R - 1;
            id[j] = kn < deg ? __ldg(ids + (size_t)kn * kTileN) : 0;
          }
          if constexpr (EF) {
            float pre[F];
#pragma unroll
            for (int f = 0; f < F; ++f) pre[f] = z[i][f] + zdv[f];
            ln.add_edge(pre, s_dyn, fe[i], k_ef, hd);
            float sc = 0.f, dal = 0.f;
#pragma unroll
            for (int f = 0; f < F; ++f) {
              sc += av[f] * (pre[f] > 0.f ? pre[f] : slope * pre[f]);
              dal += gv[f] * z[i][f];
            }
            sc = head_sum(sc, lph, mask);
            dal = head_sum(dal, lph, mask);
            const float alpha =
                expf(fminf(fmaxf(sc - sig, kExpClamp), 0.f));
            const float de = alpha * (dal - r_h);
            float pk[F], dsv[F];
#pragma unroll
            for (int f = 0; f < F; ++f) {
              const bool pos = pre[f] > 0.f;
              const float ds = de * av[f] * (pos ? 1.f : slope);
              dacc[f] = __fadd_rn(dacc[f], ds);
              da_acc[f] = fmaf(de, pos ? pre[f] : slope * pre[f], da_acc[f]);
              pk[f] = alpha * gv[f] + ds;
              dsv[f] = ds;
            }
            ln.add_outer(s_dwe, dsv, fe[i], k_ef, hd);
            if (emit)
              ln.store(c1 + ((size_t)(c0 + k) * kTileN + r) * hd, pk);
            continue;
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
            // explicit roundings: whether the packet is written (ds used
            // twice or once) must not change how dzd and d_a are contracted
            dacc[f] = __fadd_rn(dacc[f], ds);
            da_acc[f] = fmaf(de, pos ? s : slope * s, da_acc[f]);
            pk[f] = alpha * gv[f] + ds;
          }
          if (emit)
            ln.store(c1 + ((size_t)(c0 + k) * kTileN + r) * hd, pk);
        }
      }
    }
    ln.store(dzd + (size_t)row * hd, dacc);
  }

  // the block's d_a partial: the warp's groups added over the group-index
  // bits (every lane ends with the same sums), then the warps in warp order
#pragma unroll
  for (int f = 0; f < F; ++f)
    for (int o = lg; o < 32; o <<= 1)
      da_acc[f] += __shfl_xor_sync(kFull, da_acc[f], o);
  const int warp = threadIdx.x >> 5;
  if (lane < lg) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!ln.ok[j]) continue;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        s_da[warp][ln.off[j] + v] = da_acc[VEC * j + v];
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < hd; f += kBlock) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_da[w][f];
    da_part[(size_t)blockIdx.x * hd + f] = s;
  }
  if constexpr (EF) {
    // the block's dW_e: its groups' tables in group order, added into its
    // row of the partials
    const int groups = kBlock / lg;
    for (int i = threadIdx.x; i < ehd; i += kBlock) {
      float s = 0.f;
      for (int q = 0; q < groups; ++q) s += s_dyn[ehd + q * ehd + i];
      dwe_part[(size_t)blockIdx.x * ehd + i] += s;
    }
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream` for `rows` virtual rows (a multiple of 128) with
// `blocks` thread blocks of kBlock threads, which stride over the rows;
// da_part holds blocks x H*D partials. c1 may be null: then no packet is
// written. Returns the cudaError_t of the launch (0 on success).
// ef / we / k / dwe_part: the edge-feature variant (ef [slots, k] in
// gather_ids' order, we = W_e as [k][H*D], dwe_part [blocks, k, H*D] that
// each block adds its dW_e partial into); null / 0 for the plain kernel.
int gatv2_sell_bwd_dst(const float* zs, const float* zd, const float* g,
                       const float* sigma, const float* r, const float* a,
                       const int* perm, const int* gather_ids, const int* cnt,
                       const int* col_off, int rows, int heads, int head_dim,
                       float slope, int blocks, const float* ef,
                       const float* we, int k, float* dzd, float* da_part,
                       float* c1, float* dwe_part, cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || blocks <= 0 || heads <= 0 || heads > kMaxHeads ||
      head_dim <= 0 || hd > kMaxHd || k < 0 || k > kMaxEdgeDim ||
      (k > 0) != (ef != nullptr) || (k > 0) != (dwe_part != nullptr))
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(
      heads, head_dim,
      aligned16(zs) && aligned16(zd) && aligned16(g) && aligned16(a) &&
          aligned16(dzd) && (c1 == nullptr || aligned16(c1)));
  if (k == 0)
    return dispatch(geo, [&](auto vec, auto nv) {
      sell_bwd_dst_kernel<decltype(vec)::value, decltype(nv)::value, false>
          <<<blocks, kBlock, 0, stream>>>(
              zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, rows,
              heads, head_dim, geo.lg, geo.lph, geo.qph, slope, nullptr,
              nullptr, 0, dzd, da_part, c1, nullptr);
      return (int)cudaGetLastError();
    });
  // W_e and one dW_e table per lane group
  const size_t smem = sizeof(float) * (size_t)k * hd * (1 + kBlock / geo.lg);
  return dispatch_edge(geo, [&](auto vec, auto nv) {
    auto kernel =
        sell_bwd_dst_kernel<decltype(vec)::value, decltype(nv)::value, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kBlock, smem, stream>>>(
        zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, rows, heads,
        head_dim, geo.lg, geo.lph, geo.qph, slope, ef, we, k, dzd, da_part,
        c1, dwe_part);
    return (int)cudaGetLastError();
  });
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
