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
// source side instead, or, with edge features, reads the compact packet
// this kernel writes (below). dzd and d_a are the same numbers either way.
// Padding slots are left unwritten in c1 (K3 skips them by the same
// count); in the masked TPU algebra a padding slot of a row with edges adds
// exp(-80) * r ~ 1e-35 * r, below fp32 resolution, and a row without edges
// gets exactly 0, which is written directly.
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
// The edge-feature variant (KE > 0, below) rebuilds each score with W_e f
// as K1 does, and sums dW_e per lane group in shared memory. At 6 heads x
// 80 and k = 8 its 154 KB of shared memory keep one block an SM, and what
// bounds it is the shared-memory pipe: one edge at a time, a lane read 40
// 16-byte W_e vectors an edge and read and wrote 40 of its group's dW_e
// table, 120 shared-memory instructions, and the kernel took 300 ms a
// layer on ogbn-proteins (79.1 M edges, H*D = 480), the largest part of
// that cell's epoch. So a row's edges go two at a time (kEdgeStep): each
// W_e read and each table update serves both, 60 instructions an edge,
// with the same roundings in the same order (dzd, d_a, dW_e and the
// packets equal the one-edge kernel's to the bit). The registers this
// costs are found by turning each zs row into its pre-activation and then
// its ds in place and by holding 8 features a slot where the launch has at
// most 8 (254 registers, no spills). Measured on one chunk's worth of the
// cell's rows (tools/torch_kernel_variants.py k2e; NVIDIA H100 80GB HBM3,
// 700.00 W): 12.41 ms against 16.66 one edge at a time with 16 features
// held (15.98 with 8), where a bare gather of one zs row per real slot
// takes 2.69 ms; three edges a step took 11.18 ms but spilled at 255
// registers, and a ring of two steps (the next step's loads in flight)
// 17.33 ms with 484 bytes spilled. In the cell's traced epochs K2 went
// from 300 to 223 ms a layer.
//
// On a chunked layout the edge-feature variant also writes each real
// slot's compact packet (`compact`: one buffer for the whole layer, which
// K4 reads through ell_perm), what K4 would otherwise rebuild from the zd
// row, the features, W_e, sigma and r. A slot's packet is
// compact_words(H, LPH) words of 32 bits: alpha and de of head h at words
// 2h and 2h + 1, then one word of the pre-activation's sign bits for each
// lane of a head (lane gl of the group, gl < H * LPH) at word 2H + gl, bit
// i set iff the lane's feature i (component i % VEC of its vector i / VEC)
// has zs + zd + W_e f > 0; the count is rounded up to an even number, so
// that each (alpha, de) pair is 8-byte aligned. At 6 heads of 80 that is
// 36 words, 144 bytes a slot. The lanes are those of 16-byte vectors
// whenever D % 4 == 0 (a launch with packets whose tables are not aligned
// is refused), so K2 and K4 agree on them. An edge's bits are packed from
// its pre-activation before that turns into ds in place, and its packet is
// stored once ds is done: nothing is held across the step. Measured on the
// chunk above (tools/torch_kernel_variants.py k2e): 13.07 ms with packets
// against 12.42 for the kernel before them, without; the store before the
// ds loop took 13.77, the bits packed inside that loop 13.67 (and spilled
// at 16 features held). In the cell K2 went from 222 to 235 ms a layer and
// K4 from 168 to 49.

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
// The edge-feature variant takes a row's edges kEdgeStep at a time, so
// that each W_e vector read and each dW_e table update serves that many
// edges: a step's zs rows and features are loaded together, with the next
// step's ids, and then computed, as in K1's ring.
constexpr int kEdgeStep = 2;
// Launches with at most this many edge features take an instantiation that
// holds that many a slot in registers, not kMaxEdgeDim.
constexpr int kNarrowEdgeDim = 8;

// The source ids of step q of a row (its edges G*q .. G*q + G - 1; 0 past
// deg).
template <int G>
__device__ __forceinline__ void load_step_ids(int (&id)[G],
                                              const int* __restrict__ ids,
                                              int q, int deg) {
#pragma unroll
  for (int e = 0; e < G; ++e) {
    const int k = G * q + e;
    id[e] = k < deg ? __ldg(ids + (size_t)k * kTileN) : 0;
  }
}

// Step q of a row into registers: each edge's zs row (through id) and its
// k features (column k at efs + k*128*k_ef); an edge past deg as
// zeros.
template <int G, int VEC, int NV, int KE>
__device__ __forceinline__ void load_step(
    const Lane<VEC, NV>& ln, float (&z)[G][NV * VEC], float (&fe)[G][KE],
    const int (&id)[G], int q, int deg, const float* __restrict__ zs, int hd,
    const float* __restrict__ efs, int k_ef) {
#pragma unroll
  for (int e = 0; e < G; ++e) {
    const int k = G * q + e;
    if (k < deg) {
      ln.load(z[e], zs + (size_t)id[e] * hd, kZsEvictFirst);
      load_edge_feats(fe[e], efs + (size_t)k * kTileN * k_ef, k_ef);
    } else {
#pragma unroll
      for (int f = 0; f < NV * VEC; ++f) z[e][f] = 0.f;
#pragma unroll
      for (int c = 0; c < KE; ++c) fe[e][c] = 0.f;
    }
  }
}

// KE > 0: the edge-feature variant, holding at most KE features a slot.
// Each slot's k features (ef, in the slot order of gather_ids) enter the
// score as W_e f, W_e laid out [k][H*D] (we) and read once per block into
// shared memory, as in K1; and the kernel adds dW_e = sum over the slots of
// ds (x) f. Each lane group sums its own rows' products into a [k][H*D]
// table of its own in shared memory (its lanes own disjoint features: no
// atomics); at the end the block adds its groups' tables in group order and
// adds the result into its row of dwe_part [blocks, k, H*D], so the
// launches over the chunks of a layout accumulate in launch order and the
// wrapper's one sum over the blocks fixes every rounding. A row's edges go
// kEdgeStep at a time (the last step short of edges when the count is not a
// multiple), each taken in edge order: dzd, d_a and each table entry take
// the same roundings as one edge at a time. With `compact` (a chunked
// layout's backward) each real slot's compact packet is written there,
// at the slot's index times pk_words words. Without edge features (KE = 0)
// the kernel is the one measured above.
template <int VEC, int NV, int KE>
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
                    float* __restrict__ c1, float* __restrict__ dwe_part,
                    unsigned* __restrict__ compact, int pk_words) {
  constexpr bool EF = KE > 0;
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
      if constexpr (EF) {
        // step q: edges G*q .. G*q + G - 1, those past deg as zeros; the
        // ids of step q + 1 are loaded before step q computes
        constexpr int G = kEdgeStep;
        const float* efs = ef + ((size_t)c0 * kTileN + r) * k_ef;
        int id[G];
        load_step_ids(id, ids, 0, deg);
        for (int q = 0; G * q < deg; ++q) {
          float z[G][F];
          float fe[G][KE];
          load_step(ln, z, fe, id, q, deg, zs, hd, efs, k_ef);
          load_step_ids(id, ids, q + 1, deg);
          const int n = min(G, deg - G * q);  // group-uniform
          // dalpha from the zs rows, then the rows become the
          // pre-activations in place
          float dal[G];
#pragma unroll
          for (int e = 0; e < G; ++e) {
            dal[e] = 0.f;
#pragma unroll
            for (int f = 0; f < F; ++f) dal[e] += gv[f] * z[e][f];
#pragma unroll
            for (int f = 0; f < F; ++f) z[e][f] = z[e][f] + zdv[f];
          }
          ln.add_edge(z, s_dyn, fe, k_ef, hd);
#pragma unroll
          for (int e = 0; e < G; ++e) {
            float(&x)[F] = z[e];  // the pre-activation, then ds
            if (e >= n) {
              // an edge past deg adds nothing to the tables: fmaf(0, 0, t)
              // is t (no entry is -0)
#pragma unroll
              for (int f = 0; f < F; ++f) x[f] = 0.f;
              continue;
            }
            float sc = 0.f;
#pragma unroll
            for (int f = 0; f < F; ++f)
              sc += av[f] * (x[f] > 0.f ? x[f] : slope * x[f]);
            sc = head_sum(sc, lph, mask);
            const float da_h = head_sum(dal[e], lph, mask);
            const float alpha =
                expf(fminf(fmaxf(sc - sig, kExpClamp), 0.f));
            const float de = alpha * (da_h - r_h);
            // the compact packet's sign bits, feature f at bit f, taken
            // before the pre-activation turns into ds
            unsigned sign = 0u;
#pragma unroll
            for (int f = 0; f < F; ++f) sign |= (x[f] > 0.f ? 1u : 0u) << f;
#pragma unroll
            for (int f = 0; f < F; ++f) {
              const bool pos = x[f] > 0.f;
              const float ds = de * av[f] * (pos ? 1.f : slope);
              dacc[f] = __fadd_rn(dacc[f], ds);
              da_acc[f] = fmaf(de, pos ? x[f] : slope * x[f], da_acc[f]);
              x[f] = ds;
            }
            if (compact != nullptr && own_head) {  // this edge's packet
              unsigned* p =
                  compact +
                  ((size_t)(c0 + G * q + e) * kTileN + r) * pk_words;
              if ((gl & (lph - 1)) == 0)
                *reinterpret_cast<float2*>(p + 2 * h) =
                    make_float2(alpha, de);
              p[2 * heads + gl] = sign;
            }
            if (emit) {
              float pk[F];  // this edge's packet c1
#pragma unroll
              for (int f = 0; f < F; ++f) pk[f] = alpha * gv[f] + x[f];
              ln.store(c1 + ((size_t)(c0 + G * q + e) * kTileN + r) * hd,
                       pk);
            }
          }
          ln.add_outer(s_dwe, z, fe, k_ef, hd);
        }
      } else {
        // the ring: slot j holds an edge's zs row from its load to its
        // compute, and id[j] the source id of the next edge loaded into
        // it; while edge k is computed, the loads of edges k+1 .. k+R-1
        // are in flight and the ids of the next R edges are known
        int id[R];
        float z[R][F];
#pragma unroll
        for (int j = 0; j < R; ++j)
          id[j] = j < deg ? __ldg(ids + j * kTileN) : 0;
#pragma unroll
        for (int j = 0; j + 1 < R; ++j) {
          if (j < deg) ln.load(z[j], zs + (size_t)id[j] * hd, kZsEvictFirst);
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
              const int kn = k + 2 * R - 1;
              id[j] = kn < deg ? __ldg(ids + (size_t)kn * kTileN) : 0;
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
            const float alpha =
                expf(fminf(fmaxf(sc - sig, kExpClamp), 0.f));
            const float de = alpha * (dal - r_h);
            float pk[F];  // this edge's packet c1
#pragma unroll
            for (int f = 0; f < F; ++f) {
              const float s = z[i][f] + zdv[f];
              const bool pos = s > 0.f;
              const float ds = de * av[f] * (pos ? 1.f : slope);
              // explicit roundings: whether the packet is written (ds used
              // twice or once) must not change how dzd and d_a are
              // contracted
              dacc[f] = __fadd_rn(dacc[f], ds);
              da_acc[f] = fmaf(de, pos ? s : slope * s, da_acc[f]);
              pk[f] = alpha * gv[f] + ds;
            }
            if (emit)
              ln.store(c1 + ((size_t)(c0 + k) * kTileN + r) * hd, pk);
          }
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
// compact: with edge features, where the launch's compact packets go
// (compact_words(H, LPH) words a slot, the launch's slot 0 first); null
// for none.
int gatv2_sell_bwd_dst(const float* zs, const float* zd, const float* g,
                       const float* sigma, const float* r, const float* a,
                       const int* perm, const int* gather_ids, const int* cnt,
                       const int* col_off, int rows, int heads, int head_dim,
                       float slope, int blocks, const float* ef,
                       const float* we, int k, float* dzd, float* da_part,
                       float* c1, float* dwe_part, unsigned* compact,
                       cudaStream_t stream) {
  const int hd = heads * head_dim;
  if (rows <= 0 || blocks <= 0 || heads <= 0 || heads > kMaxHeads ||
      head_dim <= 0 || hd > kMaxHd || k < 0 || k > kMaxEdgeDim ||
      (k > 0) != (ef != nullptr) || (k > 0) != (dwe_part != nullptr) ||
      (compact != nullptr && k == 0))
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(
      heads, head_dim,
      aligned16(zs) && aligned16(zd) && aligned16(g) && aligned16(a) &&
          aligned16(dzd) && (c1 == nullptr || aligned16(c1)));
  if (compact != nullptr && !compact_geometry(geo, head_dim))
    return (int)cudaErrorInvalidValue;
  if (k == 0)
    return dispatch(geo, [&](auto vec, auto nv) {
      sell_bwd_dst_kernel<decltype(vec)::value, decltype(nv)::value, 0>
          <<<blocks, kBlock, 0, stream>>>(
              zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, rows,
              heads, head_dim, geo.lg, geo.lph, geo.qph, slope, nullptr,
              nullptr, 0, dzd, da_part, c1, nullptr, nullptr, 0);
      return (int)cudaGetLastError();
    });
  // W_e and one dW_e table per lane group
  const size_t smem = sizeof(float) * (size_t)k * hd * (1 + kBlock / geo.lg);
  auto launch_edge = [&](auto vec, auto nv, auto ke) {
    auto kernel = sell_bwd_dst_kernel<decltype(vec)::value,
                                      decltype(nv)::value,
                                      decltype(ke)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, kBlock, smem, stream>>>(
        zs, zd, g, sigma, r, a, perm, gather_ids, cnt, col_off, rows, heads,
        head_dim, geo.lg, geo.lph, geo.qph, slope, ef, we, k, dzd, da_part,
        c1, dwe_part, compact, compact_words(heads, geo.lph));
    return (int)cudaGetLastError();
  };
  return dispatch_edge(geo, [&](auto vec, auto nv) {
    return k <= kNarrowEdgeDim ? launch_edge(vec, nv, Int<kNarrowEdgeDim>{})
                               : launch_edge(vec, nv, Int<kMaxEdgeDim>{});
  });
}

const char* gatv2_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
